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
// On the device (__CUDA_ARCH__, N = 8) the product, add, sub and the
// conditional subtraction are PTX carry chains: mad.lo.cc / madc.hi.cc /
// addc for a CIOS row, add.cc / sub.cc for the rest.  The portable C++
// form carries through 64-bit sums, which ptxas issues as about 365 add
// instructions beside a product's 136 multiplies.  The carry flag does not
// survive from one asm statement to the next (the compiler may put any
// instruction between them), so every chain starts and ends inside one
// asm statement: each CIOS row's multiply half and reduction half is one.
// Both forms compute the same integers, so they give the same limbs.
//
// The header also compiles as plain C++ (no __CUDACC__), so the
// arithmetic can be exercised on a host without a GPU; the host pass of
// nvcc and g++ take the portable form.

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


#if defined(__CUDA_ARCH__)
#define GT_PTX 1
// r += b over 8 limbs; returns the carry out (0 or 1).  In place ("+r"),
// so that no output can share a register with an input read later.
__device__ __forceinline__ uint32_t add8(uint32_t* r, const uint32_t* b) {
  uint32_t c;
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(c)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return c;
}

// r -= b over 8 limbs; returns 0xffffffff on a borrow out, else 0
__device__ __forceinline__ uint32_t sub8(uint32_t* r, const uint32_t* b) {
  uint32_t m;
  asm("sub.cc.u32  %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32    %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(m)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return m;
}

// One CIOS row, multiply half: t[0..9] += a * b (t[9] is 0 on entry).
// Chain 1 adds the low halves of a_j b into t_j, chain 2 the high halves
// into t_(j+1).
__device__ __forceinline__ void cios_mul_row(uint32_t* t, const uint32_t* a,
                                             uint32_t b) {
  asm("mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// One CIOS row, reduction half: m = t_0 * inv, t += m * p, which clears
// t_0; the caller shifts t down one limb.
__device__ __forceinline__ void cios_red_row(uint32_t* t, const uint32_t* p,
                                             uint32_t inv) {
  asm("{\n\t.reg .u32 m;\n\t"
      "mul.lo.u32     m, %0, %18;\n\t"
      "mad.lo.cc.u32  %0, m, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, m, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, m, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, m, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, m, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, m, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, m, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, m, %17, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, m, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, m, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, m, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, m, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, m, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, m, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, m, %16, %7;\n\t"
      "madc.hi.cc.u32 %8, m, %17, %8;\n\t"
      "addc.u32       %9, %9, 0;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
        "r"(p[6]), "r"(p[7]), "r"(inv));
}
#endif

template <class P>
GT_HD void p_limbs(uint32_t* q) {
#pragma unroll
  for (int i = 0; i < P::N; ++i) q[i] = P::p(i);
}

// r - p if (hi or r >= p), else r; r < 2p
template <class P>
GT_HD Fp<P> cond_sub_p(const Fp<P>& r, uint32_t hi) {
  Fp<P> d;
#ifdef GT_PTX
  if constexpr (P::N == 8) {
    uint32_t q[8];
    p_limbs<P>(q);
    d = r;
    const uint32_t keep = sub8(d.v, q) & ~(0u - (hi != 0));
#pragma unroll
    for (int i = 0; i < 8; ++i) d.v[i] = keep ? r.v[i] : d.v[i];
    return d;
  }
#endif
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
#ifdef GT_PTX
  if constexpr (P::N == 8) {
    s = a;
    return cond_sub_p(s, add8(s.v, b.v));
  }
#endif
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
#ifdef GT_PTX
  if constexpr (P::N == 8) {
    // add p back under the borrow's mask: no branch
    d = a;
    const uint32_t m = sub8(d.v, b.v);
    uint32_t q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = P::p(i) & m;
    add8(d.v, q);
    return d;
  }
#endif
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
#ifdef GT_PTX
  if constexpr (N == 8) {
    uint32_t q[8];
    p_limbs<P>(q);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cios_mul_row(t, a.v, b.v[i]);
      cios_red_row(t, q, P::INV);
#pragma unroll
      for (int j = 0; j < N + 1; ++j) t[j] = t[j + 1];
      t[N + 1] = 0;
    }
    Fp<P> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = t[i];
    return cond_sub_p(r, t[N]);  // t < 2p
  }
#endif
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
