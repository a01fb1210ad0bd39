// The kernels of the MSM, for BN254 G1 (over Fp) and G2 (over Fp2): the
// four of the signed windowed Pippenger plan, and the double-and-add
// ladder that serves small MSMs with the reduction of its output, built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (gnark_tpu_torch/ops/_cuda.py).  Each kernel
// computes exactly what its plain PyTorch version in ops/msm.py computes,
// on the same int64 tensors of 16-bit limb planes, with the same point
// formulas in the same order, so the outputs agree bit for bit.
//
// Kernel              replaces (gnark_tpu/ops/msm.py)
//   leaf_prefix       MSM._leaf_prefix_pallas   (msm.py:496)
//   lane_offsets      MSM._lane_offsets_pallas  (msm.py:564)
//   weighted_sum      MSM._weighted_sum_pallas  (msm.py:623)
//   horner_fold       MSM._horner_fold_pallas   (msm.py:725)
//   ladder            MSM._run_ladder_pallas    (msm.py:319)
//   reduce            _reduce                   (msm.py:124, XLA: the sum
//                     of the ladder's per-point results, msm.py:384)
//
// What bounds them on the H100: 32-bit integer multiplies (mad.lo/mad.hi),
// about 2N^2 per field product, N = 8 limbs; memory traffic is small next
// to that (a mixed add reads 2 and writes 3 elements, and costs 11
// products).  The design is the simple one: a point lives in one thread's
// registers and the limb loops unroll at compile time.
//   * leaf_prefix: one thread per (window, lane) walks its C sorted points;
//     neighbouring lanes read neighbouring addresses.  At 2^16 that is
//     24 x 512 = 12,288 chains, which under-fills 132 SMs (about 3 warps
//     an SM): the lane count R is the knob for a later change.
//   * lane_offsets: one block per window, a Hillis-Steele scan over the R
//     lane totals in ping-pong buffers in device memory.
//   * weighted_sum: one block per window, the halving fold of the plain
//     version, each level spread over the block's threads.
//   * horner_fold: one thread.
//   * ladder: one thread per point runs all 256 double-and-add steps on
//     its own accumulator, with the add skipped where the scalar bit is 0
//     (the plain version's masked select keeps the accumulator there too)
//     and the doubling skipped while the accumulator is the identity.
//     The MSM sends fewer than 8192 points here, so few threads run; one
//     warp per block spreads them over the most SMs, but it under-fills
//     the card as the leaf does.
//   * reduce: one block; each of its 256 lanes sums a strided share of
//     the points, then a tree over the lanes.
// None uses wgmma, TMA or clusters.
//
// Without __CUDACC__ the kernels compile as host C++ (the launchers drop
// out), so a host harness that defines blockIdx, threadIdx, blockDim,
// __global__, __launch_bounds__ and __syncthreads can run a grid one
// thread at a time against the plain versions.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "ec.cuh"

struct G1 {
  using F = Fp<BN254Fp>;
  // b = 3, b3 = 9: 8a + a
  GT_HD static F mul_b3(const F& a) { return add(dbl(dbl(dbl(a))), a); }
};

struct G2 {
  using F = Fp2<BN254Fp>;
  // b' = 3 / (9 + u); b3 = 3b' in Montgomery form
  GT_HD static F b3() {
    constexpr uint32_t c0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu,
                                0xd71e7c52u, 0xd95d4664u, 0x03873e63u,
                                0x082ab8f4u, 0x0e75b5b1u};
    constexpr uint32_t c1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau,
                                0x31d21a78u, 0x680401ffu, 0x85dd7297u,
                                0xdf39a7e9u, 0x03c52d6au};
    F r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r.c0.v[i] = c0[i];
      r.c1.v[i] = c1[i];
    }
    return r;
  }
  GT_HD static F mul_b3(const F& a) { return mul(a, b3()); }
};

// sx, sy: [nw, C, L16, R]; sorted position r*C + cs at (w, cs, :, r).
// y limb 0 carries flags: bit 16 = infinity (skip), bit 17 = negative
// digit (add -P).  rows: [nw, C*R, 3*L16]; row cs*R + r = X|Y|Z of the
// running sum after step cs of lane r.
template <class Curve>
__global__ void __launch_bounds__(128)
    leaf_prefix_kernel(const int64_t* sx, const int64_t* sy, int64_t* rows,
                       int nw, int C, int R) {
  using F = typename Curve::F;
  using IO = FieldIO<F>;
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)nw * R) return;
  const int w = (int)(t / R), r = (int)(t % R);
  Point<F> acc = identity<Curve>();
  for (int cs = 0; cs < C; ++cs) {
    const long off = ((long)w * C + cs) * F::L16 * R + r;
    uint32_t flags;
    F px = IO::load(sx + off, R);
    F py = IO::load(sy + off, R, &flags);
    if (flags & 2u) py = neg(py);
    if (!(flags & 1u)) acc = padd_mixed<Curve>(acc, px, py);
    store_point<Curve>(acc, rows + ((long)w * C * R + (long)cs * R + r) * 3 * F::L16, 1);
  }
}

// tot, out: [3*L16, nw, R].  out[r] = sum of tot[0..r) (exclusive scan,
// lane 0 = the identity (0 : 1 : 0)); rolled-in lanes of each step are
// the identity, as in the plain version.  scratch: 2 * nw * R points.
template <class Curve>
__global__ void __launch_bounds__(256)
    lane_offsets_kernel(const int64_t* tot, int64_t* out,
                        Point<typename Curve::F>* scratch, int nw, int R) {
  using P = Point<typename Curve::F>;
  const int w = blockIdx.x;
  const long stride = (long)nw * R;
  P* a = scratch + (long)w * 2 * R;
  P* b = a + R;
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    a[r] = load_point<Curve>(tot + (long)w * R + r, stride);
  __syncthreads();
  for (int s = 1; s < R; s <<= 1) {
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      b[r] = padd<Curve>(a[r], r >= s ? a[r - s] : identity<Curve>());
    __syncthreads();
    P* tmp = a;
    a = b;
    b = tmp;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    store_point<Curve>(r >= 1 ? a[r - 1] : identity<Curve>(),
                       out + (long)w * R + r, stride);
}

// bk: [3*L16, nw, nb] with nb a power of two; out: [3*L16, nw] with
// out[w] = sum_j (j+1) * bk[w, j].  Halving fold: with H = m/2,
//   sum_{j<m} (j+1) B_j = sum_{j<H} (j+1) (B_j + B_{H+j}) + H sum_{j<H} B_{H+j};
// the high half is tree-summed, doubled log2(H) times into W, and the
// array folds in half.  scratch: nw * (nb + nb/2 + 1) points.
template <class Curve>
__global__ void __launch_bounds__(256)
    weighted_sum_kernel(const int64_t* bk, int64_t* out,
                        Point<typename Curve::F>* scratch, int nw, int nb) {
  using P = Point<typename Curve::F>;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long stride = (long)nw * nb;
  P* B = scratch + (long)w * (nb + nb / 2 + 1);
  P* T = B + nb;
  P* W = T + nb / 2;
  for (int j = tid; j < nb; j += nt)
    B[j] = load_point<Curve>(bk + (long)w * nb + j, stride);
  __syncthreads();
  bool have_w = false;
  for (int m = nb; m > 1; m /= 2) {
    const int H = m / 2;
    if (H == 1) {
      if (tid == 0) T[0] = B[1];
    } else {
      for (int j = tid; j < H / 2; j += nt)
        T[j] = padd<Curve>(B[H + j], B[H + H / 2 + j]);
      __syncthreads();
      for (int t = H / 2; t > 1; t /= 2) {
        for (int j = tid; j < t / 2; j += nt)
          T[j] = padd<Curve>(T[j], T[j + t / 2]);
        __syncthreads();
      }
    }
    __syncthreads();
    if (tid == 0) {
      P hs = T[0];
      for (int h = H; h > 1; h >>= 1) hs = pdbl<Curve>(hs);
      *W = have_w ? padd<Curve>(*W, hs) : hs;
    }
    have_w = true;
    for (int j = tid; j < H; j += nt) B[j] = padd<Curve>(B[j], B[H + j]);
    __syncthreads();
  }
  if (tid == 0)
    store_point<Curve>(have_w ? padd<Curve>(B[0], *W) : B[0], out + w, nw);
}

// S: [3*L16, nw]; out: [3*L16, 1] = sum_w 2^(c w) S_w, most significant
// window first: c doublings, then one add per window.
template <class Curve>
__global__ void horner_fold_kernel(const int64_t* S, int64_t* out, int nw,
                                   int c) {
  using P = Point<typename Curve::F>;
  P acc = load_point<Curve>(S + nw - 1, nw);
  for (int w = nw - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = pdbl<Curve>(acc);
    acc = padd<Curve>(acc, load_point<Curve>(S + w, nw));
  }
  store_point<Curve>(acc, out, 1);
}

// xs, ys: [L16, n] affine Montgomery coordinates; inf: [n] bytes, nonzero
// for infinity; sc: [Ls, n] regular-form 16-bit scalar limbs.  out:
// [3*L16, n], column i = s_i * P_i in Jacobian coordinates, by MSB-first
// double-and-add over all 16 * Ls bits.  The identity (0 : 1 : 0) is not
// doubled, as in the plain version, which leaves out the steps above its
// batch's highest set bit: the accumulator is the identity there.
template <class Curve>
__global__ void __launch_bounds__(32)
    ladder_kernel(const int64_t* xs, const int64_t* ys, const uint8_t* inf,
                  const int64_t* sc, int64_t* out, int n, int Ls) {
  using F = typename Curve::F;
  using IO = FieldIO<F>;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const F px = IO::load(xs + i, n);
  const F py = IO::load(ys + i, n);
  const bool pinf = inf[i] != 0;
  Point<F> acc = identity<Curve>();
  for (int k = Ls - 1; k >= 0; --k) {
    const uint32_t limb = (uint32_t)sc[(long)k * n + i];
    for (int b = 15; b >= 0; --b) {
      if (!is_zero(acc.Z)) acc = jdbl<Curve>(acc);
      if (((limb >> b) & 1u) && !pinf) acc = jadd_mixed<Curve>(acc, px, py);
    }
  }
  store_point<Curve>(acc, out + i, n);
}

constexpr int REDUCE_LANES = 256;

// pts: [3*L16, n] Jacobian points; out: [3*L16, 1], their sum.  Lane t
// sums points t, t + 256, t + 512, ... in order; then lane t adds lane
// t + s for s = 128, 64, ..., 1.  The loops run over lanes, not threads,
// so any block size gives the same limbs.  scratch: 256 points.
template <class Curve>
__global__ void __launch_bounds__(REDUCE_LANES)
    reduce_kernel(const int64_t* pts, int64_t* out,
                  Point<typename Curve::F>* scratch, int n) {
  using P = Point<typename Curve::F>;
  for (int t = threadIdx.x; t < REDUCE_LANES; t += blockDim.x) {
    P acc = t < n ? load_point<Curve>(pts + t, n) : identity<Curve>();
    for (long i = t + REDUCE_LANES; i < n; i += REDUCE_LANES)
      acc = jadd<Curve>(acc, load_point<Curve>(pts + i, n));
    scratch[t] = acc;
  }
  __syncthreads();
  for (int s = REDUCE_LANES / 2; s >= 1; s >>= 1) {
    for (int t = threadIdx.x; t < s; t += blockDim.x)
      scratch[t] = jadd<Curve>(scratch[t], scratch[t + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) store_point<Curve>(scratch[0], out, 1);
}

// ---- C launchers: launch on the given stream, return cudaGetLastError() --

#ifdef __CUDACC__

#define GNARK_MSM_LAUNCHERS(NAME, CURVE)                                      \
  extern "C" int gnark_msm_leaf_prefix_##NAME(                                \
      const void* sx, const void* sy, void* rows, int nw, int C, int R,       \
      void* stream) {                                                         \
    const long threads = (long)nw * R;                                        \
    const int block = 128;                                                    \
    leaf_prefix_kernel<CURVE><<<(unsigned)((threads + block - 1) / block),    \
                                block, 0, (cudaStream_t)stream>>>(            \
        (const int64_t*)sx, (const int64_t*)sy, (int64_t*)rows, nw, C, R);    \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_lane_offsets_##NAME(                               \
      const void* tot, void* out, void* scratch, int nw, int R,               \
      void* stream) {                                                         \
    lane_offsets_kernel<CURVE><<<nw, 256, 0, (cudaStream_t)stream>>>(         \
        (const int64_t*)tot, (int64_t*)out,                                   \
        (Point<CURVE::F>*)scratch, nw, R);                                    \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_weighted_sum_##NAME(                               \
      const void* bk, void* out, void* scratch, int nw, int nb,               \
      void* stream) {                                                         \
    weighted_sum_kernel<CURVE><<<nw, 256, 0, (cudaStream_t)stream>>>(         \
        (const int64_t*)bk, (int64_t*)out, (Point<CURVE::F>*)scratch, nw,     \
        nb);                                                                  \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_horner_fold_##NAME(const void* S, void* out,       \
                                              int nw, int c, void* stream) {  \
    horner_fold_kernel<CURVE><<<1, 1, 0, (cudaStream_t)stream>>>(             \
        (const int64_t*)S, (int64_t*)out, nw, c);                             \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_ladder_##NAME(                                    \
      const void* xs, const void* ys, const void* inf, const void* sc,        \
      void* out, int n, int Ls, void* stream) {                               \
    const int block = 32;                                                     \
    ladder_kernel<CURVE><<<(n + block - 1) / block, block, 0,                 \
                           (cudaStream_t)stream>>>(                           \
        (const int64_t*)xs, (const int64_t*)ys, (const uint8_t*)inf,          \
        (const int64_t*)sc, (int64_t*)out, n, Ls);                            \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_reduce_##NAME(const void* pts, void* out,          \
                                         void* scratch, int n,                \
                                         void* stream) {                      \
    reduce_kernel<CURVE><<<1, REDUCE_LANES, 0, (cudaStream_t)stream>>>(       \
        (const int64_t*)pts, (int64_t*)out, (Point<CURVE::F>*)scratch, n);    \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_point_bytes_##NAME() {                             \
    return (int)sizeof(Point<CURVE::F>);                                      \
  }

GNARK_MSM_LAUNCHERS(g1, G1)
GNARK_MSM_LAUNCHERS(g2, G2)

#endif  // __CUDACC__
