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
// products).  A point's field elements live in registers and the limb
// loops unroll at compile time.
//   * leaf_prefix: each (window, lane) chain walks its C sorted points on
//     a group of G threads inside one warp (G = Curve::LEAF_GROUP, fixed
//     at compile time: 4 for G1 and G2, the fastest of 2, 4, 8 and of 4,
//     8, 16 on an H100, ops/leaf_groups.py), so the 2^16 plan's 24 x 512
//     = 12,288 chains give 4 x 12,288 threads, 11.6 warps an SM.  Each
//     mixed addition runs as levels of independent products over the
//     group, as the fold's point operations do (G1: 5, then 6; G2: 15,
//     the 6 of its two b3 products, then 18), synced with __syncwarp on
//     the group's lanes.  Lane 0 holds the running sum and does the
//     additions between levels, as in the fold.  Every lane repeating
//     them, with only the products' results through shared memory, issues
//     as many instructions a warp (the leader's additions take the warp's
//     issue slots whether the other lanes wait or repeat them) and picks
//     each lane's operands by branches; on an H100 it was slower at every
//     width (G1 1.41 against 1.17 ms at its best, G2 5.87 against 4.31;
//     ops/leaf_groups.py --csrc).  The group loads each point and stores
//     each row together.
//   * lane_offsets: one block per window, a Hillis-Steele scan over the R
//     lane totals in ping-pong buffers in device memory.
//   * weighted_sum: the plain version's halving fold is a chain of about
//     110 point operations if each level waits for the last, but its
//     dependency graph is 3K - 2 operations deep at nb = 2^K buckets (28
//     at 1,024: the tree sums of all levels are ready after K - 1, their
//     doublings run side by side, then the W additions).  A window's
//     cluster of WSUM_CLUSTER blocks runs that graph as a wavefront, step
//     by step with a cluster barrier between: each step's independent
//     operations go to the blocks' groups of WSUM_GROUP threads, each
//     operation as levels of products over its group, as in the leaf.  The
//     first steps (768, 512, 320, ... operations a window) are bound by the
//     products, the last twenty (one to nine) by the chain's latency; four
//     blocks of 256 threads a window were the fastest on an H100, with
//     groups of 4 (G1) and 8 (G2) (ops/leaf_groups.py --kernel
//     weighted_sum: one block a window, or eight, was slower).
//   * horner_fold: a chain of point operations, so bound by the latency of
//     its longest chain of dependent products, not by their number.  One
//     block of one warp; each point operation runs as levels of
//     independent field products (RCB15 doubling: 4 + 4 products, with a
//     level of its own for G2's b3 product; addition: 6 + 6, and 2 for
//     G2's b3), spread over the lanes through shared memory with a barrier
//     after each level; an fp2 product is its three Karatsuba base
//     products on three lanes.  Lane 0 holds the accumulator and does the
//     additions between levels.
//   * ladder: the scalar is cut into K = 16 chunks of B = 16 Ls / K bits,
//     one thread per (point, chunk), so n K threads fill the card (65,536
//     threads at the small proof's 4096 points, 15.5 warps an SM).
//     Each thread runs a uniform schedule over its chunk: w-bit windows
//     (w = 4) from the top, w complete doublings and one complete addition
//     of a table entry each, with no branch on the scalar; the point's table
//     0..2^w - 1 of multiples (T[2k] = 2 T[k], T[2k+1] = T[2k] + T[1]) is
//     built once per block in shared memory, level by level, by the
//     threads of the block.  Output column (chunk j, point i) is d_ij P_i.
//   * reduce: one block per chunk sums that chunk's n points: each of its
//     256 lanes a strided share, then a tree over the lanes.  The fold of
//     the K chunk sums, sum_j 2^(jB) T_j, is horner_fold with c = B.
// The complete formulas (ec_complete.cuh) take the identity, P + P and
// P + (-P) without a branch, so every lane of a warp runs the same code.
// None uses wgmma or TMA; only the weighted sum uses clusters.
//
// Without __CUDACC__ the kernels compile as host C++ (the launchers drop
// out), so a host harness that defines blockIdx, threadIdx, blockDim,
// __global__, __shared__, __launch_bounds__, __syncthreads and __syncwarp
// can run a grid one block at a time with blockDim.x = 1: every loop over
// a block's work steps by blockDim.x, and every loop over a leaf group's
// by G, so leaf_prefix_kernel<Curve, 1> and weighted_sum_kernel<Curve, 1,
// 1, 1> (groups of one) and the other kernels run on one thread that does
// it all, in order.  On the host the weighted sum's slots are a static
// array.

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

#include "ec_complete.cuh"

#ifdef __CUDACC__
#define GT_BLOCK __device__ __noinline__
#define GT_INLINE __device__ __forceinline__
#else
#define GT_BLOCK inline
#define GT_INLINE inline
#endif

struct G1 {
  using F = Fp<BN254Fp>;
  static constexpr bool B3_PRODUCT = false;
  static constexpr int LEAF_GROUP = 4;  // threads a leaf chain
  // threads a weighted-sum operation, threads a block, blocks a window
  static constexpr int WSUM_GROUP = 4, WSUM_THREADS = 256, WSUM_CLUSTER = 4;
  // resident ladder blocks an SM: caps G1's registers at 128 (ptxas takes
  // 164 otherwise, and 12 warps an SM stay resident, not 16)
  static constexpr int LADDER_BLOCKS = 4;
  // b = 3, b3 = 9: 8a + a
  GT_HD static F mul_b3(const F& a) { return add(dbl(dbl(dbl(a))), a); }
};

struct G2 {
  using F = Fp2<BN254Fp>;
  static constexpr bool B3_PRODUCT = true;  // b3 * a is a full fp2 product
  static constexpr int LEAF_GROUP = 4;
  static constexpr int WSUM_GROUP = 8, WSUM_THREADS = 256, WSUM_CLUSTER = 4;
  static constexpr int LADDER_BLOCKS = 2;
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

// ---- point operations as levels of independent products ------------------

constexpr int FOLD_THREADS = 32;

// An F-product as base-field products: one for fp, three for fp2
// (towers.py::Fp2Ops.mul's Karatsuba, as field.cuh's fp2 mul).  put()
// writes the operands of product k, get() combines its results.
template <class F>
struct Prod;

template <class P>
struct Prod<Fp<P>> {
  using Base = Fp<P>;
  static constexpr int S = 1;
  GT_HD static void put(Base* A, Base* B, int k, const Base& a, const Base& b) {
    A[k] = a;
    B[k] = b;
  }
  GT_HD static Base get(const Base* R, int k) { return R[k]; }
};

template <class P>
struct Prod<Fp2<P>> {
  using Base = Fp<P>;
  static constexpr int S = 3;
  GT_HD static void put(Base* A, Base* B, int k, const Fp2<P>& a,
                        const Fp2<P>& b) {
    A[3 * k] = a.c0;
    B[3 * k] = b.c0;
    A[3 * k + 1] = a.c1;
    B[3 * k + 1] = b.c1;
    A[3 * k + 2] = add(a.c0, a.c1);
    B[3 * k + 2] = add(b.c0, b.c1);
  }
  GT_HD static Fp2<P> get(const Base* R, int k) {
    const Base v0 = R[3 * k], v1 = R[3 * k + 1], s = R[3 * k + 2];
    return {add(v0, mul_beta(v1)), sub(sub(s, v0), v1)};
  }
};

// The operands and results of one level: at most 6 F-products.
template <class F>
struct FoldShared {
  using PR = Prod<F>;
  typename PR::Base A[6 * PR::S], B[6 * PR::S], R[6 * PR::S];
};

// How the nt lanes that share one FoldShared wait for each other: the
// Horner fold's block at a barrier, a leaf chain's thread group (the lanes
// of mask, inside one warp) at __syncwarp.
struct BlockSync {
  GT_INLINE void operator()() const { __syncthreads(); }
};
struct GroupSync {
  unsigned mask;
  GT_INLINE void operator()() const { __syncwarp(mask); }
};

// R[k] = A[k] * B[k] for k < m over the lanes tid = 0 .. nt - 1; the sync
// before publishes lane 0's operands, the one after its results.
template <class Base, class Sync>
GT_BLOCK void fold_products(Base* A, Base* B, Base* R, int m, int tid, int nt,
                            Sync sync) {
  sync();
  for (int k = tid; k < m; k += nt) R[k] = mul(A[k], B[k]);
  sync();
}

// v[0..cnt) *= b3: additions on lane 0 for G1, one level of products for G2
template <class Curve, class Sync>
GT_BLOCK void fold_b3(typename Curve::F* v, int cnt,
                      FoldShared<typename Curve::F>& s, int tid, int nt,
                      Sync sync) {
  using PR = Prod<typename Curve::F>;
  if constexpr (Curve::B3_PRODUCT) {
    if (tid == 0)
      for (int k = 0; k < cnt; ++k) PR::put(s.A, s.B, k, v[k], Curve::b3());
    fold_products(s.A, s.B, s.R, cnt * PR::S, tid, nt, sync);
    if (tid == 0)
      for (int k = 0; k < cnt; ++k) v[k] = PR::get(s.R, k);
  } else if (tid == 0) {
    for (int k = 0; k < cnt; ++k) v[k] = Curve::mul_b3(v[k]);
  }
}

// P = 2P, ec_complete.cuh's pdbl (alg 9) in levels; P is lane 0's
template <class Curve, class Sync>
GT_BLOCK void fold_dbl(Point<typename Curve::F>& P,
                       FoldShared<typename Curve::F>& s, int tid, int nt,
                       Sync sync) {
  using F = typename Curve::F;
  using PR = Prod<F>;
  const bool lead = tid == 0;
  if (lead) {
    PR::put(s.A, s.B, 0, P.Y, P.Y);
    PR::put(s.A, s.B, 1, P.Y, P.Z);
    PR::put(s.A, s.B, 2, P.Z, P.Z);
    PR::put(s.A, s.B, 3, P.X, P.Y);
  }
  fold_products(s.A, s.B, s.R, 4 * PR::S, tid, nt, sync);
  F t[4];  // Y^2, YZ, b3 Z^2, XY
  if (lead)
    for (int k = 0; k < 4; ++k) t[k] = PR::get(s.R, k);
  fold_b3<Curve>(t + 2, 1, s, tid, nt, sync);
  if (lead) {
    const F Z3 = dbl(dbl(dbl(t[0])));  // 8 Y^2
    const F Y3 = add(t[0], t[2]);
    const F t0 = sub(t[0], add(dbl(t[2]), t[2]));  // Y^2 - 3 b3 Z^2
    PR::put(s.A, s.B, 0, t[2], Z3);
    PR::put(s.A, s.B, 1, t[1], Z3);
    PR::put(s.A, s.B, 2, t0, Y3);
    PR::put(s.A, s.B, 3, t0, t[3]);
  }
  fold_products(s.A, s.B, s.R, 4 * PR::S, tid, nt, sync);
  if (lead)
    P = {dbl(PR::get(s.R, 3)), add(PR::get(s.R, 2), PR::get(s.R, 0)),
         PR::get(s.R, 1)};
}

// P = P + Q, ec_complete.cuh's padd (alg 7) in levels; P, Q are lane 0's
template <class Curve, class Sync>
GT_BLOCK void fold_add(Point<typename Curve::F>& P,
                       const Point<typename Curve::F>& Q,
                       FoldShared<typename Curve::F>& s, int tid, int nt,
                       Sync sync) {
  using F = typename Curve::F;
  using PR = Prod<F>;
  const bool lead = tid == 0;
  if (lead) {
    PR::put(s.A, s.B, 0, P.X, Q.X);
    PR::put(s.A, s.B, 1, P.Y, Q.Y);
    PR::put(s.A, s.B, 2, P.Z, Q.Z);
    PR::put(s.A, s.B, 3, add(P.X, P.Y), add(Q.X, Q.Y));
    PR::put(s.A, s.B, 4, add(P.Y, P.Z), add(Q.Y, Q.Z));
    PR::put(s.A, s.B, 5, add(P.X, P.Z), add(Q.X, Q.Z));
  }
  fold_products(s.A, s.B, s.R, 6 * PR::S, tid, nt, sync);
  F t0, t1, t3, t4, v[2];  // v: t2, Y3, the two b3 operands
  if (lead) {
    t0 = PR::get(s.R, 0);
    t1 = PR::get(s.R, 1);
    v[0] = PR::get(s.R, 2);
    t3 = sub(PR::get(s.R, 3), add(t0, t1));
    t4 = sub(PR::get(s.R, 4), add(t1, v[0]));
    v[1] = sub(PR::get(s.R, 5), add(t0, v[0]));
    t0 = add(dbl(t0), t0);  // 3 X1X2
  }
  fold_b3<Curve>(v, 2, s, tid, nt, sync);
  if (lead) {
    const F Z3 = add(t1, v[0]);
    t1 = sub(t1, v[0]);
    PR::put(s.A, s.B, 0, t3, t1);
    PR::put(s.A, s.B, 1, t4, v[1]);
    PR::put(s.A, s.B, 2, t1, Z3);
    PR::put(s.A, s.B, 3, v[1], t0);
    PR::put(s.A, s.B, 4, Z3, t4);
    PR::put(s.A, s.B, 5, t0, t3);
  }
  fold_products(s.A, s.B, s.R, 6 * PR::S, tid, nt, sync);
  if (lead)
    P = {sub(PR::get(s.R, 0), PR::get(s.R, 1)),
         add(PR::get(s.R, 2), PR::get(s.R, 3)),
         add(PR::get(s.R, 4), PR::get(s.R, 5))};
}

// P = P + (X2 : Y2 : 1), ec_complete.py's add_mixed (alg 8) in levels, in
// its order: X X2, Y Y2, (X + Y)(X2 + Y2), X2 Z, Y2 Z; b3 Z and b3 t4;
// then the six products of X3, Y3, Z3.  P, X2, Y2 are lane 0's.  Inlined
// into the leaf's loop, its one caller: as a call it kept the running sum
// in local memory and took a tenth of the leaf's time on an H100
// (ops/leaf_groups.py --csrc), more than inlining the two helpers it
// shares with the fold would gain.
template <class Curve, class Sync>
GT_INLINE void fold_add_mixed(Point<typename Curve::F>& P,
                              const typename Curve::F& X2,
                              const typename Curve::F& Y2,
                              FoldShared<typename Curve::F>& s, int tid,
                              int nt, Sync sync) {
  using F = typename Curve::F;
  using PR = Prod<F>;
  const bool lead = tid == 0;
  if (lead) {
    PR::put(s.A, s.B, 0, P.X, X2);
    PR::put(s.A, s.B, 1, P.Y, Y2);
    PR::put(s.A, s.B, 2, add(P.X, P.Y), add(X2, Y2));
    PR::put(s.A, s.B, 3, X2, P.Z);
    PR::put(s.A, s.B, 4, Y2, P.Z);
  }
  fold_products(s.A, s.B, s.R, 5 * PR::S, tid, nt, sync);
  F t0, t1, t3, t5, v[2];  // v: the two b3 operands, Z and t4
  if (lead) {
    t0 = PR::get(s.R, 0);
    t1 = PR::get(s.R, 1);
    t3 = sub(PR::get(s.R, 2), add(t0, t1));
    v[0] = P.Z;
    v[1] = add(PR::get(s.R, 3), P.X);  // t4
    t5 = add(PR::get(s.R, 4), P.Y);
    t0 = add(dbl(t0), t0);  // 3 X1X2
  }
  fold_b3<Curve>(v, 2, s, tid, nt, sync);
  if (lead) {
    const F Z3 = add(t1, v[0]);
    t1 = sub(t1, v[0]);
    PR::put(s.A, s.B, 0, t3, t1);
    PR::put(s.A, s.B, 1, t5, v[1]);
    PR::put(s.A, s.B, 2, t1, Z3);
    PR::put(s.A, s.B, 3, v[1], t0);
    PR::put(s.A, s.B, 4, Z3, t5);
    PR::put(s.A, s.B, 5, t0, t3);
  }
  fold_products(s.A, s.B, s.R, 6 * PR::S, tid, nt, sync);
  if (lead)
    P = {sub(PR::get(s.R, 0), PR::get(s.R, 1)),
         add(PR::get(s.R, 2), PR::get(s.R, 3)),
         add(PR::get(s.R, 4), PR::get(s.R, 5))};
}

// S: [3*L16, nw]; out: [3*L16, 1] = sum_w 2^(c w) S_w, most significant
// window first: c doublings, then one add per window.  The fold starts at
// the highest window that is not the identity (Z != 0), or at window 0
// when all are: the identities above it would only be doubled.  One block.
template <class Curve>
__global__ void __launch_bounds__(FOLD_THREADS)
    horner_fold_kernel(const int64_t* S, int64_t* out, int nw, int c) {
  using P = Point<typename Curve::F>;
  __shared__ FoldShared<typename Curve::F> sh;
  const int tid = threadIdx.x, nt = blockDim.x;
  int top = nw - 1;  // every lane finds it: no shared word, no barrier
  while (top > 0 && is_zero(load_point<Curve>(S + top, nw).Z)) --top;
  P acc, q;
  if (tid == 0) acc = load_point<Curve>(S + top, nw);
  for (int w = top - 1; w >= 0; --w) {
    for (int k = 0; k < c; ++k) fold_dbl<Curve>(acc, sh, tid, nt, BlockSync{});
    if (tid == 0) q = load_point<Curve>(S + w, nw);
    fold_add<Curve>(acc, q, sh, tid, nt, BlockSync{});
  }
  if (tid == 0) store_point<Curve>(acc, out, 1);
}

// ---- the weighted bucket sum, a wavefront over the halving fold ----------

// The steps of the halving fold's dependency graph at nb = 2^K buckets (K
// >= 1), one point operation deep each: with H = 2^(k-1) at level k,
//   the fold B[j] = B[j] + B[H+j], j < H                at step K + 1 - k,
//   sub-level i of the tree over B[H, 2H)               at step K - k + i,
//   the j-th doubling of that tree's sum (hs_k = H sum) at step K - 1 + j,
//   W_k = W_{k+1} + hs_k (W_K = hs_K)                   at step 3K - 2 - k,
//   S = B[0] + W_1                                      last.
GT_HD int wsum_steps(int K) { return K + 1 > 3 * K - 2 ? K + 1 : 3 * K - 2; }

// The barrier between two steps: the block's, or that of a cluster of
// blocks (a threaded host harness defines cluster_sync).
#ifdef __CUDACC__
GT_INLINE void cluster_sync() { cooperative_groups::this_cluster().sync(); }
#else
void cluster_sync();
#endif
template <int CLUSTER>
GT_INLINE void wsum_sync() {
  if constexpr (CLUSTER == 1)
    __syncthreads();
  else
    cluster_sync();
}

// bk: [3*L16, nw, nb] with nb a power of two; out: [3*L16, nw] with
// out[w] = sum_j (j+1) * bk[w, j], by the plain version's halving fold
//   sum_{j<m} (j+1) B_j = sum_{j<H} (j+1) (B_j + B_{H+j}) + H sum_{j<H} B_{H+j}
// with the same operations on the same operands in the same order per
// chain; only when each runs changes.  A window's CLUSTER blocks (one, or
// a thread-block cluster) run the steps of wsum_steps, a barrier between
// two; the operations of one step are independent and dealt out to the
// blocks' groups of G threads, each run
// as levels of products over its group (fold_add, fold_dbl) with lane 0
// loading the operands from scratch and storing the result.  scratch: nw
// * (nb + nb/2) points a window: B (folded in place: a step's trees read
// only the high half), level k's tree (in place, its sum doubled there) at
// T + 2^(k-2) - 1 for k >= 2 (level 1's sum is B[1]), and W.  The groups'
// FoldShared slots are dynamic shared memory (above 48 KB for G2).
template <class Curve, int G, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS)
    weighted_sum_kernel(const int64_t* bk, int64_t* out,
                        Point<typename Curve::F>* scratch, int nw, int nb) {
  using F = typename Curve::F;
  using P = Point<F>;
  static_assert(G < 32 && 32 % G == 0, "a group lies inside one warp");
  const int w = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char wsum_shared[];
  FoldShared<F>* slots = reinterpret_cast<FoldShared<F>*>(wsum_shared);
#else
  __shared__ FoldShared<F> cluster_slots[CLUSTER][THREADS / G];
  FoldShared<F>* slots = cluster_slots[rank];
#endif
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % G, groups = CLUSTER * nt / G;
  const int group = rank * (nt / G) + tid / G;  // in the window's cluster
  FoldShared<F>& sh = slots[tid / G];
  const GroupSync sync{((1u << G) - 1u) << (tid % 32 / G * G)};
  const long stride = (long)nw * nb;
  P* B = scratch + (long)w * (nb + nb / 2);
  P* T = B + nb;
  P* W = T + nb / 2 - 1;  // W_k for k < K
  auto hs = [&](int k) { return k >= 2 ? T + (1 << (k - 2)) - 1 : B + 1; };
  int K = 0;
  while ((1 << K) < nb) ++K;
  for (int j = rank * nt + tid; j < nb; j += CLUSTER * nt)
    B[j] = load_point<Curve>(bk + (long)w * nb + j, stride);
  wsum_sync<CLUSTER>();
  if (K == 0) {
    if (rank == 0 && tid == 0) store_point<Curve>(B[0], out + w, nw);
    return;
  }
  const int D = wsum_steps(K);
  for (int s = 1; s <= D; ++s) {
    // this step's operations, in this order: the fold of level K + 1 - s;
    // sub-level s - (K - k) of the trees of levels k = K .. K + 1 - s,
    // `per` additions each; doubling s - K + 1 of levels k = K ..
    // s - K + 2; then W_{3K-2-s}, or S
    const int nf = s <= K ? 1 << (K - s) : 0;
    const int per = s < K ? 1 << (K - 1 - s) : 0;
    const int ntr = s * per;
    const int nd = s >= K && s <= 2 * K - 2 ? 2 * K - 1 - s : 0;
    const int nwk = s == D || (s >= 2 * K - 1 && s <= 3 * K - 3) ? 1 : 0;
    const int nops = nf + ntr + nd + nwk;
    for (int o = group; o < nops; o += groups) {
      P a, b;  // lane 0's
      P* dst = nullptr;
      bool dbl = false;
      if (o < nf) {
        dst = B + o;
        if (lane == 0) {
          a = B[o];
          b = B[nf + o];
        }
      } else if (o < nf + ntr) {
        const int q = o - nf, k = K - q / per, j = q % per;
        P* Tk = hs(k);
        dst = Tk + j;
        if (lane == 0) {
          const P* src = s == K - k + 1 ? B + (1 << (k - 1)) : Tk;
          a = src[j];
          b = src[per + j];
        }
      } else if (o < nf + ntr + nd) {
        dst = hs(K - (o - nf - ntr));
        dbl = true;
        if (lane == 0) a = *dst;
      } else if (s < D) {
        const int k = 3 * K - 2 - s;
        dst = W;
        if (lane == 0) {
          a = k == K - 1 ? *hs(K) : *W;
          b = *hs(k);
        }
      } else if (lane == 0) {
        a = B[0];
        b = K == 1 ? *hs(1) : *W;
      }
      if (dbl)
        fold_dbl<Curve>(a, sh, lane, G, sync);
      else
        fold_add<Curve>(a, b, sh, lane, G, sync);
      if (lane == 0) {
        if (dst)
          *dst = a;
        else
          store_point<Curve>(a, out + w, nw);
      }
    }
    wsum_sync<CLUSTER>();
  }
}

// ---- the leaf prefix, a thread group a chain -------------------------------

// Threads a leaf block: 128, or 64 or 32 where the groups' FoldShared
// slots would pass the 48 KB of static shared memory a block may hold.
template <class F, int G>
struct LeafBlock {
  static constexpr long SLOT = sizeof(FoldShared<F>), MAX = 48 * 1024;
  static constexpr int THREADS = 128 / G * SLOT <= MAX  ? 128
                                 : 64 / G * SLOT <= MAX ? 64
                                                        : 32;
};

// An element as its 32-bit words, limb 0 first (fp2: c0's, then c1's).
template <class F>
GT_HD void words_to(F& a, const uint32_t* w) {
  static_assert(sizeof(F) == F::N * sizeof(uint32_t), "F is its words");
  uint32_t* d = reinterpret_cast<uint32_t*>(&a);
  for (int i = 0; i < F::N; ++i) d[i] = w[i];
}

template <class F>
GT_HD void words_from(uint32_t* w, const F& a) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
  for (int i = 0; i < F::N; ++i) w[i] = s[i];
}

// One 32-bit word as the two 16-bit limbs at dst[0], dst[1].
GT_HD void store_word(int64_t* dst, uint32_t v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<longlong2*>(dst) = make_longlong2(v & 0xffffu, v >> 16);
#else
  dst[0] = v & 0xffffu;
  dst[1] = v >> 16;
#endif
}

// sx, sy: [nw, C, L16, R]; sorted position r*C + cs at (w, cs, :, r).
// y limb 0 carries flags: bit 16 = infinity (skip), bit 17 = negative
// digit (add -P).  rows: [nw, C*R, 3*L16]; row cs*R + r = X|Y|Z of the
// running sum after step cs of lane r.
//
// Chain q = w*R + r runs on the G consecutive threads G q .. G q + G - 1,
// one group inside a warp, which share a FoldShared slot and sync with
// __syncwarp on their own lanes.  A step: the group loads the point's
// 2 W words (W = F::N; lane j words j, j + G, ...; neighbouring groups
// read neighbouring r) into the slot's R area; lane 0 adds it to its
// running sum with fold_add_mixed (its products spread over the group),
// copies the sum into the A area, and the group writes the row's 3 W
// words, 16 bytes a word, lane j words j, j + G, ...: a warp's groups write
// one contiguous run of rows.  Every lane reads the flags, so the
// infinity skip is the group's, and the syncs inside the addition stay
// among the lanes that reach them.
template <class Curve, int G>
__global__ void __launch_bounds__(LeafBlock<typename Curve::F, G>::THREADS)
    leaf_prefix_kernel(const int64_t* sx, const int64_t* sy, int64_t* rows,
                       int nw, int C, int R) {
  using F = typename Curve::F;
  constexpr int W = F::N;
  static_assert(G < 32 && 32 % G == 0, "a group lies inside one warp");
  static_assert(sizeof(FoldShared<F>::R) >= (2 * W + 1) * sizeof(uint32_t) &&
                sizeof(FoldShared<F>::A) >= 3 * W * sizeof(uint32_t),
                "the point and the row fit in the slot");
  __shared__ FoldShared<F> slots[LeafBlock<F, G>::THREADS / G];
  const long q = ((long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= (long)nw * R) return;  // the whole group
  const int lane = threadIdx.x % G;
  const int w = (int)(q / R), r = (int)(q % R);
  FoldShared<F>& s = slots[threadIdx.x / G];
  uint32_t* pt = reinterpret_cast<uint32_t*>(s.R);  // x, y words, flags
  uint32_t* sum = reinterpret_cast<uint32_t*>(s.A);  // X, Y, Z words
  const GroupSync sync{((1u << G) - 1u) << (threadIdx.x % 32 / G * G)};
  Point<F> acc = identity<Curve>();  // lane 0's
  for (int cs = 0; cs < C; ++cs) {
    const long off = ((long)w * C + cs) * F::L16 * R + r;
    for (int i = lane; i < 2 * W; i += G) {
      const int64_t* src = (i < W ? sx : sy) + off + 2L * (i % W) * R;
      uint32_t lo = (uint32_t)src[0];
      const uint32_t hi = (uint32_t)src[R];
      if (i == W) {
        pt[2 * W] = lo >> 16;
        lo &= 0xffffu;
      }
      pt[i] = lo | hi << 16;
    }
    sync();
    const uint32_t flags = pt[2 * W];
    if (!(flags & 1u)) {
      F px, py;
      if (lane == 0) {
        words_to(px, pt);
        words_to(py, pt + W);
        if (flags & 2u) py = neg(py);
      }
      fold_add_mixed<Curve>(acc, px, py, s, lane, G, sync);
    }
    if (lane == 0) {
      words_from(sum, acc.X);
      words_from(sum + W, acc.Y);
      words_from(sum + 2 * W, acc.Z);
    }
    sync();
    int64_t* row = rows + ((long)w * C * R + (long)cs * R + r) * 3 * F::L16;
    for (int i = lane; i < 3 * W; i += G) store_word(row + 2 * i, sum[i]);
  }
}

// ---- the chunked, windowed ladder ---------------------------------------------

constexpr int LADDER_POINTS = 8;   // points a block
constexpr int LADDER_CHUNKS = 16;  // K: chunks a scalar, a thread each
constexpr int LADDER_WINDOW = 4;   // w: bits a window
constexpr int LADDER_TABLE = 1 << LADDER_WINDOW;
constexpr int LADDER_THREADS = LADDER_POINTS * LADDER_CHUNKS;

// Levels of the table recipe T[2k] = 2 T[k], T[2k+1] = T[2k] + T[1]:
// entry e is ready after table_depth(e) of them.
GT_HD int table_depth(int e) {
  int d = 0;
  for (; e > 1; ++d) e = (e & 1) ? e - 1 : e >> 1;
  return d;
}

// bits [lo, lo + nb) of scalar i, from [Ls, n] 16-bit limb planes
GT_HD uint32_t scalar_bits(const int64_t* sc, long n, long i, int lo, int nb) {
  uint32_t d = 0;
  for (int b = lo + nb - 1; b >= lo; --b)
    d = (d << 1) | (((uint32_t)sc[(long)(b >> 4) * n + i] >> (b & 15)) & 1u);
  return d;
}

// xs, ys: [L16, n] affine Montgomery coordinates; inf: [n] bytes, nonzero
// for infinity; sc: [Ls, n] regular-form 16-bit scalar limbs.  out:
// [3*L16, K, n] projective; column (j, i) = d_ij * P_i, d_ij = bits
// [jB, (j+1)B) of s_i, B = 16 Ls / K.  A chunk of w-bit windows, the top
// one B - (nwin - 1) w bits wide: acc = T[top digit], then per window w
// doublings and acc + T[digit], T[0] the identity (0 : 1 : 0).  Blocks of
// LADDER_POINTS points x K chunks.
template <class Curve>
__global__ void __launch_bounds__(LADDER_THREADS, Curve::LADDER_BLOCKS)
    ladder_kernel(const int64_t* xs, const int64_t* ys, const uint8_t* inf,
                  const int64_t* sc, int64_t* out, int n, int Ls) {
  using F = typename Curve::F;
  using P = Point<F>;
  using IO = FieldIO<F>;
  constexpr int K = LADDER_CHUNKS, w = LADDER_WINDOW;
  __shared__ P table[LADDER_POINTS][LADDER_TABLE];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long first = (long)blockIdx.x * LADDER_POINTS;
  for (int k = tid; k < LADDER_POINTS; k += nt) {
    const long i = first + k;
    P p1 = identity<Curve>();
    if (i < n && !inf[i]) p1 = {IO::load(xs + i, n), IO::load(ys + i, n), IO::one()};
    table[k][0] = identity<Curve>();
    table[k][1] = p1;
  }
  __syncthreads();
  for (int lev = 1, top = table_depth(LADDER_TABLE - 1); lev <= top; ++lev) {
    for (int t = tid; t < LADDER_POINTS * LADDER_TABLE; t += nt) {
      const int e = t % LADDER_TABLE;
      P* T = table[t / LADDER_TABLE];
      if (e >= 2 && table_depth(e) == lev)
        T[e] = (e & 1) ? padd<Curve>(T[e - 1], T[1]) : pdbl<Curve>(T[e >> 1]);
    }
    __syncthreads();
  }
  const int B = 16 * Ls / K;
  const int nwin = (B + w - 1) / w;
  const int top = (nwin - 1) * w;
  // neighbouring threads take neighbouring points of one chunk
  for (int t = tid; t < LADDER_POINTS * K; t += nt) {
    const int k = t % LADDER_POINTS, j = t / LADDER_POINTS;
    const long i = first + k;
    if (i >= n) continue;
    const P* T = table[k];
    const int lo = j * B;
    P acc = T[scalar_bits(sc, n, i, lo + top, B - top)];
    for (int m = nwin - 2; m >= 0; --m) {
      for (int d = 0; d < w; ++d) acc = pdbl<Curve>(acc);
      acc = padd<Curve>(acc, T[scalar_bits(sc, n, i, lo + m * w, w)]);
    }
    store_point<Curve>(acc, out + (long)j * n + i, (long)K * n);
  }
}

constexpr int REDUCE_LANES = 256;

// pts: [3*L16, K, n] projective points; out: [3*L16, K], the sum of each
// chunk's n points.  Block j, lane t sums points t, t + 256, ... of chunk
// j in order, over n rounded up to a multiple of 256 with the identity
// (0 : 1 : 0) as the padding; then lane t adds lane t + s for s = 128, 64,
// ..., 1.  The loops run over lanes, not threads, so any block size gives
// the same limbs.  scratch: K * 256 points.
template <class Curve>
__global__ void __launch_bounds__(REDUCE_LANES)
    reduce_kernel(const int64_t* pts, int64_t* out,
                  Point<typename Curve::F>* scratch, int n, int K) {
  using P = Point<typename Curve::F>;
  const int j = blockIdx.x;
  const long stride = (long)K * n;
  const int64_t* col = pts + (long)j * n;
  P* s = scratch + (long)j * REDUCE_LANES;
  const long n_pad = ((long)n + REDUCE_LANES - 1) / REDUCE_LANES * REDUCE_LANES;
  for (int t = threadIdx.x; t < REDUCE_LANES; t += blockDim.x) {
    P acc = t < n ? load_point<Curve>(col + t, stride) : identity<Curve>();
    for (long i = t + REDUCE_LANES; i < n_pad; i += REDUCE_LANES)
      acc = padd<Curve>(acc, i < n ? load_point<Curve>(col + i, stride)
                                   : identity<Curve>());
    s[t] = acc;
  }
  __syncthreads();
  for (int h = REDUCE_LANES / 2; h >= 1; h >>= 1) {
    for (int t = threadIdx.x; t < h; t += blockDim.x)
      s[t] = padd<Curve>(s[t], s[t + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) store_point<Curve>(s[0], out + j, K);
}

// ---- C launchers: launch on the given stream, return cudaGetLastError() --

#ifdef __CUDACC__

template <class Curve, int G>
int launch_leaf_prefix(const void* sx, const void* sy, void* rows, int nw,
                       int C, int R, void* stream) {
  constexpr int block = LeafBlock<typename Curve::F, G>::THREADS;
  const long threads = (long)nw * R * G;
  leaf_prefix_kernel<Curve, G><<<(unsigned)((threads + block - 1) / block),
                                 block, 0, (cudaStream_t)stream>>>(
      (const int64_t*)sx, (const int64_t*)sy, (int64_t*)rows, nw, C, R);
  return (int)cudaGetLastError();
}

// Above 48 KB of FoldShared slots a block needs the dynamic shared memory
// attribute, which the kernel keeps once set; a cluster of blocks a window
// is a launch attribute.
template <class Curve, int G, int THREADS, int CLUSTER>
int launch_weighted_sum(const void* bk, void* out, void* scratch, int nw,
                        int nb, void* stream) {
  using P = Point<typename Curve::F>;
  constexpr int shared =
      THREADS / G * (int)sizeof(FoldShared<typename Curve::F>);
  static_assert(shared <= 227 * 1024, "the slots pass a block's shared memory");
  static_assert(CLUSTER >= 1 && CLUSTER <= 8, "a portable cluster");
  const auto kern = weighted_sum_kernel<Curve, G, THREADS, CLUSTER>;
  if (shared > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nw * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, kern, (const int64_t*)bk, (int64_t*)out,
                         (P*)scratch, nw, nb);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

#define GNARK_MSM_LAUNCHERS(NAME, CURVE)                                      \
  extern "C" int gnark_msm_leaf_prefix_##NAME(                                \
      const void* sx, const void* sy, void* rows, int nw, int C, int R,       \
      void* stream) {                                                         \
    return launch_leaf_prefix<CURVE, CURVE::LEAF_GROUP>(sx, sy, rows, nw, C,  \
                                                        R, stream);           \
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
    return launch_weighted_sum<CURVE, CURVE::WSUM_GROUP, CURVE::WSUM_THREADS, \
                               CURVE::WSUM_CLUSTER>(bk, out, scratch, nw, nb, \
                                                    stream);                  \
  }                                                                           \
  extern "C" int gnark_msm_horner_fold_##NAME(const void* S, void* out,       \
                                              int nw, int c, void* stream) {  \
    horner_fold_kernel<CURVE><<<1, FOLD_THREADS, 0, (cudaStream_t)stream>>>(  \
        (const int64_t*)S, (int64_t*)out, nw, c);                             \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_ladder_##NAME(                                    \
      const void* xs, const void* ys, const void* inf, const void* sc,        \
      void* out, int n, int Ls, void* stream) {                               \
    ladder_kernel<CURVE><<<(n + LADDER_POINTS - 1) / LADDER_POINTS,           \
                           LADDER_THREADS, 0, (cudaStream_t)stream>>>(        \
        (const int64_t*)xs, (const int64_t*)ys, (const uint8_t*)inf,          \
        (const int64_t*)sc, (int64_t*)out, n, Ls);                            \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_reduce_##NAME(const void* pts, void* out,          \
                                         void* scratch, int n, int K,         \
                                         void* stream) {                      \
    reduce_kernel<CURVE><<<K, REDUCE_LANES, 0, (cudaStream_t)stream>>>(       \
        (const int64_t*)pts, (int64_t*)out, (Point<CURVE::F>*)scratch, n,     \
        K);                                                                   \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int gnark_msm_point_bytes_##NAME() {                             \
    return (int)sizeof(Point<CURVE::F>);                                      \
  }

GNARK_MSM_LAUNCHERS(g1, G1)
GNARK_MSM_LAUNCHERS(g2, G2)

#endif  // __CUDACC__
