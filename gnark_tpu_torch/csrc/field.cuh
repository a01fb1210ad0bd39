// Prime-field and quadratic-extension arithmetic for the MSM kernels.
//
// Device counterpart of gnark_tpu_torch/ops/limbs.py and ops/towers.py
// (which port gnark_tpu/ops/limbs.py and towers.py::Fp2Ops).  Elements are
// N x 32-bit limbs in Montgomery form with R = 2^(32N) -- the same R as
// the 16-bit limb planes of the tensors (2^(16L) with L = 2N), so values
// cross the boundary without conversion.  Every operation ends canonical
// (< p), as the plain path does, so a kernel that applies the same
// formulas as its plain version gives the same limbs bit for bit.
//
// What bounds this on the H100: integer multiplies.  A product is N^2
// mad.lo/mad.hi pairs for the schoolbook part and as many for the
// reduction (CIOS, 2N^2 + N 32-bit multiplies in all); add and sub are
// carry chains.  The design keeps whole elements in registers and lets
// nvcc fully unroll the limb loops over compile-time N; the moduli are
// template parameters (a traits struct), so BLS12-381's 12-limb fp is a
// new traits struct, not a rewrite.
//
// The header also compiles as plain C++ (no __CUDACC__), so the
// arithmetic can be exercised on a host without a GPU.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define GT_HD __host__ __device__ __forceinline__

// BN254 base field: p = 0x30644e72...d87cfd47 (gnark_tpu.fields BN254_FP).
struct BN254Fp {
  static constexpr int N = 8;
  static constexpr int BETA = -1;  // fp2 = fp[u] / (u^2 + 1)
  GT_HD static uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                               0x97816a91u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return v[i];
  }
  // R mod p: the Montgomery form of 1
  GT_HD static uint32_t one(int i) {
    constexpr uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                               0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr uint32_t INV = 0xe4866389u;  // -p^-1 mod 2^32
};

template <class P>
struct Fp {
  static constexpr int N = P::N;
  static constexpr int L16 = 2 * N;  // 16-bit limbs in a tensor plane
  uint32_t v[N];
};

template <class P>
GT_HD Fp<P> fp_zero() {
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < P::N; ++i) r.v[i] = 0;
  return r;
}

template <class P>
GT_HD Fp<P> fp_one() {
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < P::N; ++i) r.v[i] = P::one(i);
  return r;
}

template <class P>
GT_HD bool is_zero(const Fp<P>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) acc |= a.v[i];
  return acc == 0;
}

// r - p if (hi or r >= p), else r; r < 2p
template <class P>
GT_HD Fp<P> cond_sub_p(const Fp<P>& r, uint32_t hi) {
  Fp<P> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t t = (uint64_t)r.v[i] - P::p(i) - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  return (hi || !borrow) ? d : r;
}

template <class P>
GT_HD Fp<P> add(const Fp<P>& a, const Fp<P>& b) {
  Fp<P> s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  return cond_sub_p(s, (uint32_t)c);
}

template <class P>
GT_HD Fp<P> sub(const Fp<P>& a, const Fp<P>& b) {
  Fp<P> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      uint64_t t = (uint64_t)d.v[i] + P::p(i) + c;
      d.v[i] = (uint32_t)t;
      c = t >> 32;
    }
  }
  return d;
}

template <class P>
GT_HD Fp<P> neg(const Fp<P>& a) {
  return is_zero(a) ? a : sub(fp_zero<P>(), a);
}

template <class P>
GT_HD Fp<P> dbl(const Fp<P>& a) {
  return add(a, a);
}

// Montgomery product a * b * R^-1 mod p, CIOS (coarsely integrated
// operand scanning): one multiply row and one reduction row per limb of b.
template <class P>
GT_HD Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * P::INV;
    s = (uint64_t)t[0] + (uint64_t)m * P::p(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * P::p(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = t[i];
  return cond_sub_p(r, t[N]);  // t < 2p
}

template <class P>
GT_HD Fp<P> sqr(const Fp<P>& a) {
  return mul(a, a);
}

// One element from an int64 tensor of 16-bit limb planes: limb l at
// src[l * stride].  Limb 0's bits 16 and up are returned in *flags (the
// MSM rides point flags there) and masked off.
template <class P>
GT_HD Fp<P> load(const int64_t* src, long stride, uint32_t* flags = nullptr) {
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    uint64_t lo = (uint64_t)src[(2 * i) * stride];
    uint64_t hi = (uint64_t)src[(2 * i + 1) * stride];
    if (i == 0) {
      if (flags) *flags = (uint32_t)(lo >> 16);
      lo &= 0xffffu;
    }
    r.v[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  return r;
}

template <class P>
GT_HD void store(const Fp<P>& a, int64_t* dst, long stride) {
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    dst[(2 * i) * stride] = a.v[i] & 0xffffu;
    dst[(2 * i + 1) * stride] = a.v[i] >> 16;
  }
}

// ---- fp2 = fp[u] / (u^2 - beta) ------------------------------------------

template <class P>
struct Fp2 {
  static constexpr int N = 2 * P::N;
  static constexpr int L16 = 2 * Fp<P>::L16;  // c0 planes over c1 planes
  Fp<P> c0, c1;
};

template <class P>
GT_HD Fp<P> mul_beta(const Fp<P>& x) {
  static_assert(P::BETA == -1, "only beta = -1 is instantiated");
  return neg(x);
}

template <class P>
GT_HD bool is_zero(const Fp2<P>& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}

template <class P>
GT_HD Fp2<P> add(const Fp2<P>& a, const Fp2<P>& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}

template <class P>
GT_HD Fp2<P> sub(const Fp2<P>& a, const Fp2<P>& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

template <class P>
GT_HD Fp2<P> neg(const Fp2<P>& a) {
  return {neg(a.c0), neg(a.c1)};
}

template <class P>
GT_HD Fp2<P> dbl(const Fp2<P>& a) {
  return add(a, a);
}

// Karatsuba, as towers.py::Fp2Ops.mul
template <class P>
GT_HD Fp2<P> mul(const Fp2<P>& a, const Fp2<P>& b) {
  Fp<P> v0 = mul(a.c0, b.c0);
  Fp<P> v1 = mul(a.c1, b.c1);
  Fp<P> s = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {add(v0, mul_beta(v1)), sub(sub(s, v0), v1)};
}

template <class P>
GT_HD Fp2<P> sqr(const Fp2<P>& a) {
  return mul(a, a);
}

template <class P>
GT_HD Fp2<P> load2(const int64_t* src, long stride, uint32_t* flags) {
  return {load<P>(src, stride, flags), load<P>(src + Fp<P>::L16 * stride, stride)};
}

template <class P>
GT_HD void store(const Fp2<P>& a, int64_t* dst, long stride) {
  store(a.c0, dst, stride);
  store(a.c1, dst + Fp<P>::L16 * stride, stride);
}
