// The kernels of the MSM, for BN254 G1 (over Fp) and G2 (over Fp2), and
// BLS24-315 G1 (over its 10-word Fp) and G2 (over FpK<.., 4, 13>): the
// five of the signed windowed Pippenger plan, the double-and-add ladder
// that serves small MSMs with the reduction of its output, and the
// fixed-base scan that makes setup's key points, built with
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
//   buckets           MSM._window_chunk's boundaries, global prefixes and
//                     bucket differences (msm.py:887-909, XLA)
//   weighted_sum      MSM._weighted_sum_pallas  (msm.py:623)
//   horner_fold       MSM._horner_fold_pallas   (msm.py:725)
//   ladder            MSM._run_ladder_pallas    (msm.py:319)
//   reduce            _reduce                   (msm.py:124, XLA: the sum
//                     of the ladder's per-point results, msm.py:384)
// Kernel              replaces (gnark_tpu/ops/fixed_base.py)
//   fixed_base        FixedBaseTable._run       (fixed_base.py:56, a
//                     jitted lax.scan through XLA)
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
//     = 12,288 chains give 4 x 12,288 threads, 11.6 warps an SM.  Over
//     fp4 (BLS24-315 G2) the group splits the chain by coefficient
//     instead (leaf_sliced_kernel, below).  Otherwise each
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
//   * lane_offsets: an exclusive scan of a window's R = 2^K lane totals.
//     Hillis-Steele (the TPU kernel's) does R log2 R additions, one a
//     thread, 4,608 a window at R = 512; the Brent-Kung scan in place does
//     2R - 2 - K (1,013) in 2K - 1 steps of independent additions (widths
//     256, 128, ..., 1, then 1, 3, ..., 255).  A window's cluster of
//     LANES_CLUSTER blocks runs them step by step, a cluster barrier
//     between, each addition on a group of LANES_GROUP threads as levels
//     of products (fold_add), as the weighted sum does; a run of steps too
//     narrow to fill one block's groups runs on one block with block
//     barriers between (0-4 % faster than on the whole cluster).  Over
//     fp4 each addition runs on a group by coefficient instead
//     (lane_offsets_sliced_kernel).
//   * buckets: per window, the nb + 1 digit boundaries E_b (a binary
//     search over the sorted digits), the global prefix at each (a leaf
//     row plus its lane's offset: one complete addition) and bucket b =
//     PE_(b+1) - PE_b (one more).  A block takes a run of consecutive
//     buckets, its groups of BUCKETS_GROUP threads adding the run's
//     prefixes into shared memory and then its buckets, each addition as
//     levels of products over the group (fold_add); over fp4 by
//     coefficient (buckets_sliced_kernel).
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
//     additions between levels.  Over fp4 a group of FOLD_GROUP lanes runs
//     the chain by coefficient instead (horner_fold_sliced_kernel).
//   * ladder: the scalar is cut into K = 16 chunks of B = 16 Ls / K bits,
//     one thread per (point, chunk), so n K threads fill the card (65,536
//     threads at the small proof's 4096 points, 15.5 warps an SM; over
//     fp4 a group of LADDER_GROUP threads a chain, ladder_sliced_kernel).
//     Each thread runs a uniform schedule over its chunk: w-bit windows
//     (w = 4) from the top, w complete doublings and one complete addition
//     of a table entry each, with no branch on the scalar; the point's table
//     0..2^w - 1 of multiples (T[2k] = 2 T[k], T[2k+1] = T[2k] + T[1]) is
//     built once per block in shared memory, level by level, by the
//     threads of the block.  Output column (chunk j, point i) is d_ij P_i.
//   * reduce: one block per chunk sums that chunk's n points: each of its
//     256 lanes a strided share, then a tree over the lanes (over fp4 a
//     cluster a chunk, an accumulator a lane group, reduce_sliced_kernel).
//     The fold of the K chunk sums, sum_j 2^(jB) T_j, is horner_fold with
//     c = B.
//   * fixed_base: a column's nwin mixed additions of table entries (one a
//     window digit of its scalar), a chain on a group of LEAF_GROUP threads
//     as a leaf chain runs (over fp4 by coefficient, as the sliced leaf),
//     then the Jacobian form; the table stays in L2.
// The complete formulas (ec_complete.cuh) take the identity, P + P and
// P + (-P) without a branch, so every lane of a warp runs the same code.
// None uses wgmma or TMA; the lane offsets and the weighted sum use
// clusters.  The Horner fold can leave its sum in the Jacobian form the
// MSM returns (X Z, Y Z^2, Z): two more levels of products.
//
// This file instantiates BN254's kernels (kinds g1, g2).  BLS24-315's
// G1 and G2 (g1_bls24315, g2_bls24315) are libraries of their own,
// msm_g1_bls24315.cu and msm_g2_bls24315.cu, which include this file with
// GNARK_MSM_BLS24315 defined: three nvcc runs side by side.  G1's kernels
// are the same templates at their widths.  An fp4 element is 40 words and
// a point 120, so where lane 0 holds the point its registers spill, and
// the FoldShared slot (16 base products a product) is 11.5 KB.  So each
// G2 kernel was redesigned for fp4 (leaf_sliced_kernel,
// lane_offsets_sliced_kernel, buckets_sliced_kernel,
// weighted_sum_sliced_kernel, ladder_sliced_kernel, reduce_sliced_kernel,
// horner_fold_sliced_kernel, picked by FpKTraits): a point's coefficients
// split over its group's lanes, so no lane holds a whole point and
// nothing waits on a serial lane 0.  The leaf runs each product through
// Sliced's exchange; the others run SlicedPoint's complete addition and
// doubling, each formula's independent products as one level (one write
// of the operands, one sync, each lane's columns, one sync), the lane
// offsets, the weighted sum, the bucket step and the reduction each
// operation on one group, its operands by coefficient through scratch or
// shared memory.  The templates at fp4 are built only by
// ops/inline_check.py and the tests' sanitizer harness.
//
// Without __CUDACC__ the kernels compile as host C++ (the launchers drop
// out), so a host harness that defines blockIdx, threadIdx, blockDim,
// __global__, __shared__, __launch_bounds__, __syncthreads and __syncwarp
// can run a grid one block at a time with blockDim.x = 1: every loop over
// a block's work steps by blockDim.x, and every loop over a leaf group's
// by G, so leaf_prefix_kernel<Curve, 1>, lane_offsets_kernel<Curve, 1, 1,
// 1>, buckets_kernel<Curve, 1, 1> and weighted_sum_kernel<Curve, 1, 1, 1>
// (groups of one; over fp4 their sliced kernels at G = 1) and the other
// kernels run on one thread that does it all, in order.  On the host the
// cluster kernels' slots are a static array.

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
  // the same for a lane-offsets addition
  static constexpr int LANES_GROUP = 8, LANES_THREADS = 128, LANES_CLUSTER = 4;
  // threads a bucket-step addition, threads a block
  static constexpr int BUCKETS_GROUP = 4, BUCKETS_THREADS = 256;
  // resident ladder blocks an SM: caps G1's registers at 128 (ptxas takes
  // 164 otherwise, and 12 warps an SM stay resident, not 16)
  static constexpr int LADDER_BLOCKS = 4;
  static constexpr int LADDER_POINTS = 8;  // points a ladder block
  // b = 3, b3 = 9: 8a + a
  GT_HD static F mul_b3(const F& a) { return add(dbl(dbl(dbl(a))), a); }
};

struct G2 {
  using F = Fp2<BN254Fp>;
  static constexpr bool B3_PRODUCT = true;  // b3 * a is a full fp2 product
  static constexpr int LEAF_GROUP = 4;
  static constexpr int WSUM_GROUP = 8, WSUM_THREADS = 256, WSUM_CLUSTER = 4;
  static constexpr int LANES_GROUP = 8, LANES_THREADS = 256, LANES_CLUSTER = 4;
  static constexpr int BUCKETS_GROUP = 8, BUCKETS_THREADS = 256;
  static constexpr int LADDER_BLOCKS = 2;
  static constexpr int LADDER_POINTS = 8;
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

// BLS24-315 G1: y^2 = x^3 + 1, b3 = 3: 2a + a
struct G1Bls24 {
  using F = Fp<BLS24315Fp>;
  static constexpr bool B3_PRODUCT = false;
  static constexpr int LEAF_GROUP = 4;
  static constexpr int WSUM_GROUP = 4, WSUM_THREADS = 256, WSUM_CLUSTER = 4;
  static constexpr int LANES_GROUP = 8, LANES_THREADS = 128, LANES_CLUSTER = 4;
  static constexpr int BUCKETS_GROUP = 4, BUCKETS_THREADS = 256;
  static constexpr int LADDER_BLOCKS = 2;
  static constexpr int LADDER_POINTS = 8;
  GT_HD static F mul_b3(const F& a) { return add(dbl(a), a); }
};

// BLS24-315 G2 over fp4 = fp[u]/(u^4 - 13): y^2 = x^3 + 1/u; b3 = 3/u =
// (0, 0, 0, 3/13) in Montgomery form (tests/test_torch_msm.py
// derives it from the curve's b2).  Its leaf is leaf_sliced_kernel: a
// chain's fp4 coefficients over LEAF_GROUP = 8 lanes, a lane pair a
// coefficient, in blocks of LEAF_THREADS, LEAF_BLOCKS resident an SM (at
// most 170 registers: ptxas takes 166 and spills nothing); the fastest of
// G = 2, 4, 8 in blocks of 64 and 128 threads, 2 to 6 an SM, on an H100
// (ops/leaf_groups.py --kind g2_bls24315).  Its ladder and Horner fold
// are ladder_sliced_kernel and horner_fold_sliced_kernel (SlicedPoint):
// the ladder's chains on LADDER_GROUP = 4 lanes, a lane a coefficient, in
// blocks of LADDER_THREADS = 128 (two points, 110.8 KB of shared memory),
// LADDER_BLOCKS = 2 an SM (134 registers, no spills); the fold's one
// chain on FOLD_GROUP = 16 lanes, four a coefficient, each a quarter of a
// level's products (130 registers); on an H100 the fastest of the ladder
// at G = 2, 4, 8 in 64 and 128 threads and of the fold at G = 4, 8, 16
// (ops/leaf_groups.py --kernel ladder|horner_fold --kind g2_bls24315).
// Its weighted sum and reduction are weighted_sum_sliced_kernel and
// reduce_sliced_kernel: an operation a group of WSUM_GROUP = 8 lanes (a
// lane pair a coefficient) in blocks of WSUM_THREADS = 256, WSUM_CLUSTER
// = 4 blocks a window, and a chunk's accumulators on groups of
// REDUCE_GROUP = 8 lanes in blocks of REDUCE_THREADS = 128, REDUCE_CLUSTER
// = 8 blocks a chunk (two accumulators a group); launch bounds of one
// block an SM, so ptxas takes 171 and 152 registers and spills nothing
// (left to itself it took 128 and spilled); the fastest of G = 4, 8, 16
// in 64-512 threads and clusters of 4 and 8 (ops/leaf_groups.py --kernel
// weighted_sum|reduce --kind g2_bls24315).  Its lane offsets are
// lane_offsets_sliced_kernel: an addition a group of LANES_GROUP = 8 lanes
// in blocks of LANES_THREADS = 256, LANES_CLUSTER = 4 blocks a window (138
// registers, no spills); the fastest of G = 4, 8, 16 in 128 and 256
// threads and clusters of 4 and 8 on an H100 (ops/leaf_groups.py --kernel
// lane_offsets --kind g2_bls24315).  LADDER_POINTS is the template
// ladder's, which ops/inline_check.py builds.
struct G2Bls24 {
  using F = FpK<BLS24315Fp, 4, 13>;
  static constexpr bool B3_PRODUCT = true;
  static constexpr int B3_COEF = 3;  // b3's one nonzero coefficient
  static constexpr int LEAF_GROUP = 8;
  static constexpr int LEAF_THREADS = 128, LEAF_BLOCKS = 3;
  static constexpr int WSUM_GROUP = 8, WSUM_THREADS = 256, WSUM_CLUSTER = 4;
  static constexpr int LANES_GROUP = 8, LANES_THREADS = 256, LANES_CLUSTER = 4;
  static constexpr int BUCKETS_GROUP = 8, BUCKETS_THREADS = 256;
  static constexpr int REDUCE_GROUP = 8, REDUCE_THREADS = 128,
                       REDUCE_CLUSTER = 8;
  static constexpr int LADDER_GROUP = 4, LADDER_THREADS = 128;
  static constexpr int LADDER_BLOCKS = 2;
  static constexpr int FOLD_GROUP = 16;
  static constexpr int LADDER_POINTS = 4;
  GT_HD static F b3() {
    constexpr uint32_t c3[10] = {0x91789d7eu, 0xf9b9b51cu, 0xf0c0536cu,
                                 0x66e0bf96u, 0xca0ac19fu, 0xec4323b0u,
                                 0x6d2b00c8u, 0x1d538510u, 0x7238da1bu,
                                 0x02b4647du};
    F r;
    for (int k = 0; k < 3; ++k) r.c[k] = fp_zero<BLS24315Fp>();
    for (int i = 0; i < 10; ++i) r.c[3].v[i] = c3[i];
    return r;
  }
  GT_HD static F mul_b3(const F& a) { return mul(a, b3()); }
};

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

template <class P, int K, int C>
struct Prod<FpK<P, K, C>> {
  using Base = Fp<P>;
  static constexpr int S = K * K;  // the schoolbook's base products
  GT_HD static void put(Base* A, Base* B, int k, const FpK<P, K, C>& a,
                        const FpK<P, K, C>& b) {
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < K; ++j) {
        A[S * k + i * K + j] = a.c[i];
        B[S * k + i * K + j] = b.c[j];
      }
  }
  GT_HD static FpK<P, K, C> get(const Base* R, int k) {
    Base t[2 * K - 1];
    for (int m = 0; m < 2 * K - 1; ++m) t[m] = fp_zero<P>();
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < K; ++j) t[i + j] = add(t[i + j], R[S * k + i * K + j]);
    return fold_columns<P, K, C>(t);
  }
};

// A kind's shape, for ops/_cuda.py (its SHAPE names these, in this
// order): the base field's 32-bit words, the coordinate field's degree
// over it, Prod<F>::S, B3_PRODUCT, the curve struct's launch shapes, a
// point's bytes, the leaf's threads a block, whether the leaf (and the
// ladder and the fold) are the coefficient-sliced kernels, and the
// shipped ladder's threads a chain, threads a block and blocks an SM and
// the fold's threads a chain (LadderShape), and the bucket step's threads
// an addition, threads a block and buckets a block (buckets_run).  Host
// code too, so that the tests' g++ harness reads it.
#define GNARK_MSM_SHAPE(NAME, CURVE)                                          \
  extern "C" void gnark_msm_shape_##NAME(int* out) {                          \
    using F = CURVE::F;                                                       \
    using Base = Prod<F>::Base;                                               \
    using LS = LadderShape<CURVE>;                                            \
    const int v[] = {Base::N, F::N / Base::N, Prod<F>::S,                     \
                     (int)CURVE::B3_PRODUCT, CURVE::LEAF_GROUP,               \
                     CURVE::WSUM_GROUP, CURVE::WSUM_THREADS,                  \
                     CURVE::WSUM_CLUSTER, CURVE::LANES_GROUP,                 \
                     CURVE::LANES_THREADS, CURVE::LANES_CLUSTER,              \
                     CURVE::LADDER_POINTS, (int)sizeof(Point<F>),             \
                     leaf_threads<CURVE>(), (int)FpKTraits<F>::SLICED,        \
                     LS::GROUP, LS::THREADS, LS::BLOCKS, LS::FOLD,            \
                     LS::REDUCE_GROUP, LS::REDUCE_THREADS,                    \
                     LS::REDUCE_CLUSTER, CURVE::BUCKETS_GROUP,                \
                     CURVE::BUCKETS_THREADS,                                  \
                     buckets_run(CURVE::BUCKETS_THREADS /                     \
                                 CURVE::BUCKETS_GROUP)};                      \
    for (int i = 0; i < (int)(sizeof v / sizeof v[0]); ++i) out[i] = v[i];    \
  }

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

// P = (X Z, Y Z^2, Z), ec_complete.py's to_jacobian, in two levels: X Z
// and Z^2, then Y Z^2.  P is lane 0's.
template <class Curve, class Sync>
GT_BLOCK void fold_jacobian(Point<typename Curve::F>& P,
                            FoldShared<typename Curve::F>& s, int tid, int nt,
                            Sync sync) {
  using F = typename Curve::F;
  using PR = Prod<F>;
  const bool lead = tid == 0;
  if (lead) {
    PR::put(s.A, s.B, 0, P.X, P.Z);
    PR::put(s.A, s.B, 1, P.Z, P.Z);
  }
  fold_products(s.A, s.B, s.R, 2 * PR::S, tid, nt, sync);
  F xz;
  if (lead) {
    xz = PR::get(s.R, 0);
    PR::put(s.A, s.B, 0, P.Y, PR::get(s.R, 1));
  }
  fold_products(s.A, s.B, s.R, PR::S, tid, nt, sync);
  if (lead) P = {xz, PR::get(s.R, 0), P.Z};
}

// S: [3*L16, nw]; out: [3*L16, 1] = sum_w 2^(c w) S_w, most significant
// window first: c doublings, then one add per window.  The fold starts at
// the highest window that is not the identity (Z != 0), or at window 0
// when all are: the identities above it would only be doubled.  The sum
// leaves as (X Z, Y Z^2, Z), the MSM's Jacobian output (fold_jacobian).
// One block.
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
  fold_jacobian<Curve>(acc, sh, tid, nt, BlockSync{});
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

// The FoldShared slots of a block's groups of G threads: dynamic shared
// memory on the card (above 48 KB for G2), a static array on the host.
template <class F, int G, int THREADS, int CLUSTER>
GT_INLINE FoldShared<F>* group_slots(int rank) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char group_shared[];
  return reinterpret_cast<FoldShared<F>*>(group_shared);
#else
  __shared__ FoldShared<F> slots[CLUSTER][THREADS / G];
  return slots[rank];
#endif
}

// A block's shared memory as one struct S (the sliced kernels', the bucket
// step's): dynamic on the card (above 48 KB it needs the attribute,
// launch_clusters), a static object on the host, one for each block of a
// cluster (rank).
template <class S, int CLUSTER = 1>
GT_INLINE S& sliced_shared(int rank = 0) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char sliced_bytes[];
  return *reinterpret_cast<S*>(sliced_bytes);
#else
  __shared__ S s[CLUSTER];
  return s[rank];
#endif
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
// T + 2^(k-2) - 1 for k >= 2 (level 1's sum is B[1]), and W.
template <class Curve, int G, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS)
    weighted_sum_kernel(const int64_t* bk, int64_t* out,
                        Point<typename Curve::F>* scratch, int nw, int nb) {
  using F = typename Curve::F;
  using P = Point<F>;
  static_assert(G < 32 && 32 % G == 0, "a group lies inside one warp");
  const int w = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % G, groups = CLUSTER * nt / G;
  const int group = rank * (nt / G) + tid / G;  // in the window's cluster
  FoldShared<F>& sh = group_slots<F, G, THREADS, CLUSTER>(rank)[tid / G];
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

// ---- the lane offsets, a Brent-Kung scan over a cluster -------------------

// Step s of a Brent-Kung inclusive scan in place over R = 2^K lanes (K >=
// 1; 2K - 1 steps): the up-sweep's level d = s for s < K, then the
// down-sweep's d = 2K - 2 - s.  Each adds A[i - 2^d] to A[i] for i = first,
// first + 2^(d+1), ... below R, first = 2^(d+1) - 1 going up and 3 2^d - 1
// going down.  A step's additions are independent: it writes the lanes
// -1 mod 2^(d+1) and reads on the left the lanes 2^d - 1 mod 2^(d+1).
struct ScanStep {
  int half, first, count;  // 2^d, the first lane written, the additions
};
GT_HD ScanStep scan_step(int K, int R, int s) {
  const int d = s < K ? s : 2 * K - 2 - s;
  const int first = (s < K ? 2 : 3) * (1 << d) - 1;
  return {1 << d, first, (R - 1 - first) / (2 << d) + 1};
}

// tot, out: [3*L16, nw, R], R a power of two.  out[r] = tot[0] + ... +
// tot[r - 1], lane 0 the identity (0 : 1 : 0): the plain version's
// Brent-Kung scan (the same additions of the same operands in the same
// order), then the exclusive shift.  A window's CLUSTER blocks (one, or a
// thread-block cluster) load its totals into scratch (nw * R points, the
// scan works in place) and run the 2K - 1 steps, a barrier between two;
// a step's additions are dealt to the blocks' groups of G threads, each
// run as levels of products over its group (fold_add) with lane 0 loading
// the operands from scratch and storing the sum.  In a cluster, a run of
// steps with fewer additions than a block has groups runs on rank 0's
// block alone, __syncthreads between two, a cluster barrier at each end.
template <class Curve, int G, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS)
    lane_offsets_kernel(const int64_t* tot, int64_t* out,
                        Point<typename Curve::F>* scratch, int nw, int R) {
  using F = typename Curve::F;
  using P = Point<F>;
  static_assert(G < 32 && 32 % G == 0, "a group lies inside one warp");
  const int w = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % G, per_block = nt / G;
  FoldShared<F>& sh = group_slots<F, G, THREADS, CLUSTER>(rank)[tid / G];
  const GroupSync sync{((1u << G) - 1u) << (tid % 32 / G * G)};
  const long stride = (long)nw * R;
  P* A = scratch + (long)w * R;
  int K = 0;
  while ((1 << K) < R) ++K;
  for (int r = rank * nt + tid; r < R; r += CLUSTER * nt)
    A[r] = load_point<Curve>(tot + (long)w * R + r, stride);
  wsum_sync<CLUSTER>();
  const int D = K ? 2 * K - 1 : 0;
  auto alone = [&](int s) {  // step s on rank 0's block alone
    return CLUSTER > 1 && s < D && scan_step(K, R, s).count < per_block;
  };
  for (int s = 0; s < D; ++s) {
    const ScanStep st = scan_step(K, R, s);
    const bool solo = alone(s);
    if (!solo || rank == 0) {
      const int groups = solo ? per_block : CLUSTER * per_block;
      for (int o = (solo ? 0 : rank * per_block) + tid / G; o < st.count;
           o += groups) {
        const int i = st.first + 2 * st.half * o;
        P a, b;  // lane 0's
        if (lane == 0) {
          a = A[i - st.half];
          b = A[i];
        }
        fold_add<Curve>(a, b, sh, lane, G, sync);
        if (lane == 0) A[i] = a;
      }
    }
    if (!solo || !alone(s + 1))
      wsum_sync<CLUSTER>();
    else if (rank == 0)
      __syncthreads();
  }
  for (int r = rank * nt + tid; r < R; r += CLUSTER * nt)
    store_point<Curve>(r ? A[r - 1] : identity<Curve>(),
                       out + (long)w * R + r, stride);
}

// ---- the bucket step: global prefixes at the digit boundaries -------------

// E_b: the last index of a window's sorted digits d[0, n) that is at most
// b, or -1 where there is none (searchsorted(d, b, right) - 1).
GT_HD long last_at_most(const int64_t* d, long n, long b) {
  long lo = 0, hi = n;
  while (lo < hi) {
    const long mid = (lo + hi) / 2;
    if (d[mid] <= b)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

// Buckets a block of the bucket step takes: one fewer than its groups, so
// that its RUN + 1 prefixes take one round of the groups (one with a
// group of one).
GT_HD constexpr int buckets_run(int groups) { return groups > 1 ? groups - 1 : 1; }

// A block of the bucket step: RUN + 1 boundaries, their E_b and global
// prefixes, beside its groups' slots.
template <class Slot, class Pt, int GROUPS>
struct BucketsBlock {
  static constexpr int RUN = buckets_run(GROUPS);
  Slot slots[GROUPS];
  Pt pe[RUN + 1];
  long ends[RUN + 1];
};

// rows: [nw, C*R, 3*L16] leaf rows (row cs*R + r: lane r after step cs,
// X|Y|Z), offs: [3*L16, nw, R] lane offsets, d: [nw, n = C*R] each
// window's sorted digits; out: [3*L16, nw, nb].  The plain version's
// bucket step (ops/msm.py::buckets_plain; gnark_tpu's _window_chunk,
// msm.py:887-909, jitted through XLA): for b = 0 .. nb, E_b (binary
// search), the global prefix PE_b = rows[(E % C) R + E / C] + offs[E / C]
// (E clamped at 0; X = Z = 0 where E_b < 0, the identity class, with that
// addition's Y), then bucket b = PE_(b+1) + (-PE_b): the same complete
// additions of the same operands, so the same limbs.  A block takes a run
// of RUN consecutive buckets of one window: its threads search the RUN +
// 1 boundaries, its groups of G threads add the prefixes (fold_add, lane
// 0 loading the row and the offset) into shared memory, a barrier, then
// the buckets, lane 0 storing each.  A prefix on a block's edge is added
// by both blocks that need it: one addition more a block, no barrier
// between blocks.  What bounds it: the two additions' products (two
// levels of 6 and G2's b3 level each, a round of ceil(6 S / G) a level);
// the rows it reads are nb + 1 a window, scattered.
template <class Curve, int G, int THREADS>
__global__ void __launch_bounds__(THREADS)
    buckets_kernel(const int64_t* rows, const int64_t* offs,
                   const int64_t* d_sorted, int64_t* out, int nw, int C,
                   int R, int nb) {
  using F = typename Curve::F;
  using P = Point<F>;
  using Sh = BucketsBlock<FoldShared<F>, P, THREADS / G>;
  constexpr int GROUPS = THREADS / G, RUN = Sh::RUN;
  static_assert(G < 32 && 32 % G == 0 && THREADS % G == 0,
                "a group lies inside one warp");
  Sh& sh = sliced_shared<Sh>();
  const int per = (nb + RUN - 1) / RUN;  // blocks a window
  const int w = blockIdx.x / per, b0 = blockIdx.x % per * RUN;
  const int cnt = nb - b0 < RUN ? nb - b0 : RUN;
  const int tid = threadIdx.x, lane = tid % G, group = tid / G;
  const long n = (long)C * R;
  for (int t = tid; t <= cnt; t += THREADS)
    sh.ends[t] = last_at_most(d_sorted + w * n, n, b0 + t);
  __syncthreads();
  FoldShared<F>& s = sh.slots[group];
  const GroupSync sync{((1u << G) - 1u) << (tid % 32 / G * G)};
  for (int o = group; o <= cnt; o += GROUPS) {
    const long e = sh.ends[o], g = e < 0 ? 0 : e, r = g / C;
    P a, b;  // lane 0's
    if (lane == 0) {
      a = load_point<Curve>(rows + (w * n + g % C * R + r) * 3 * F::L16, 1);
      b = load_point<Curve>(offs + (long)w * R + r, (long)nw * R);
    }
    fold_add<Curve>(a, b, s, lane, G, sync);
    if (lane == 0) {
      if (e < 0) a.X = a.Z = FieldIO<F>::zero();
      sh.pe[o] = a;
    }
  }
  __syncthreads();
  for (int o = group; o < cnt; o += GROUPS) {
    P a, b;
    if (lane == 0) {
      a = sh.pe[o + 1];
      b = sh.pe[o];
      b.Y = neg(b.Y);
    }
    fold_add<Curve>(a, b, s, lane, G, sync);
    if (lane == 0)
      store_point<Curve>(a, out + (long)w * nb + b0 + o, (long)nw * nb);
  }
}

// ---- the leaf prefix, a thread group a chain -------------------------------

// Threads a leaf_prefix_kernel block: 128, or 64 or 32 where the groups'
// FoldShared slots would pass the 48 KB of static shared memory a block
// may hold.
template <class F, int G>
struct LeafBlock {
  static constexpr long SLOT = sizeof(FoldShared<F>), MAX = 48 * 1024;
  static constexpr int THREADS = 128 / G * SLOT <= MAX  ? 128
                                 : 64 / G * SLOT <= MAX ? 64
                                                        : 32;
};

// Whether F is an fp^K, whose leaf is leaf_sliced_kernel, and its shape.
template <class F>
struct FpKTraits {
  static constexpr bool SLICED = false;
};
template <class P_, int K, int C>
struct FpKTraits<FpK<P_, K, C>> {
  static constexpr bool SLICED = true;
  using P = P_;
  static constexpr int DEG = K, NR = C;  // u^DEG = NR
};

// Threads a leaf block of a curve's shipped leaf.
template <class Curve>
constexpr int leaf_threads() {
  if constexpr (FpKTraits<typename Curve::F>::SLICED)
    return Curve::LEAF_THREADS;
  else
    return LeafBlock<typename Curve::F, Curve::LEAF_GROUP>::THREADS;
}

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
// __syncwarp on their own lanes.  (Over fp^K the leaf is
// leaf_sliced_kernel: lane 0 would hold a 120-word point and deal out 16
// base products a product through an 11.5 KB slot.)  A step: the group
// loads the point's 2 W words (W = F::N; lane j words j, j + G, ...;
// neighbouring groups read neighbouring r) into the slot's R area; lane 0
// adds it to its
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

// ---- the leaf prefix over fp^K, a chain's coefficients over a group ---------

// One base element in a thread's exchange slot, padded to whole 16-byte
// words: a lane writes and reads it as 16-byte vectors, and the slots of
// the 8 threads of a quarter warp (48 bytes apart at N = 10) fall on
// distinct banks.
template <class P>
struct alignas(16) XSlot {
  uint32_t v[(P::N + 3) / 4 * 4];
};

template <class P>
GT_HD void slot_put(XSlot<P>& s, const Fp<P>& a) {
#ifdef __CUDA_ARCH__
  uint4* d = reinterpret_cast<uint4*>(s.v);
#pragma unroll
  for (int q = 0; q < P::N / 4; ++q)
    d[q] = make_uint4(a.v[4 * q], a.v[4 * q + 1], a.v[4 * q + 2],
                      a.v[4 * q + 3]);
#pragma unroll
  for (int i = P::N / 4 * 4; i < P::N; ++i) s.v[i] = a.v[i];
#else
  for (int i = 0; i < P::N; ++i) s.v[i] = a.v[i];
#endif
}

template <class P>
GT_HD Fp<P> slot_get(const XSlot<P>& s) {
  Fp<P> a;
#ifdef __CUDA_ARCH__
  const uint4* d = reinterpret_cast<const uint4*>(s.v);
#pragma unroll
  for (int q = 0; q < P::N / 4; ++q) {
    const uint4 x = d[q];
    a.v[4 * q] = x.x;
    a.v[4 * q + 1] = x.y;
    a.v[4 * q + 2] = x.z;
    a.v[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int i = P::N / 4 * 4; i < P::N; ++i) a.v[i] = s.v[i];
#else
  for (int i = 0; i < P::N; ++i) a.v[i] = s.v[i];
#endif
  return a;
}

// A chain's group of G lanes over F = fp^K (u^K = NR).  The first SPAN =
// min(G, K) lanes own distinct coefficients: lane l owns l, l + SPAN, ...
// (KPL = K / SPAN of them, its slots t = 0 .. KPL - 1).  With G = 2K each
// coefficient has two lanes, l and l + K, which hold the same values and
// split its columns' rounds (LPC = 2).  A thread's exchange slots, in
// block shared memory [slot][thread]: A, NR A and B, the operands of the
// product in flight, KPL each; PART, a column's half sum (LPC = 2); KB3,
// the constant of each owned column of a b3 product.
template <class Curve, int G, int THREADS>
struct Sliced {
  using T = FpKTraits<typename Curve::F>;
  using P = typename T::P;
  using B = Fp<P>;
  static constexpr int K = T::DEG, NR = T::NR;
  static constexpr int SPAN = G < K ? G : K, KPL = K / SPAN, LPC = G / SPAN;
  static constexpr int ROUNDS = K / LPC;  // of a column, a lane
  static_assert(K % SPAN == 0 && (LPC == 1 || LPC == 2) && G % SPAN == 0,
                "G divides K, or is 2K");
  static constexpr int A = 0, AN = KPL, BB = 2 * KPL, KB3 = 3 * KPL,
                       PART = 4 * KPL, SLOTS = (LPC > 1 ? 5 : 4) * KPL;
  using Slots = XSlot<P>[SLOTS][THREADS];

  Slots& ex;
  // this thread, its half's first thread, its first coefficient, its half
  int tid, home, lane0, half;
  GroupSync sync;

  GT_HD int coef(int t) const { return lane0 + SPAN * t; }
  // coefficient j of the operand in slot array `slot`, from its owner in
  // this thread's half of the group
  GT_HD B read(int slot, int j) const {
    return slot_get(ex[slot + j / SPAN][home + j % SPAN]);
  }

  // r = a b: column m of the product is sum_s a_(m-s mod K) b_s, times NR
  // where s > m (u^K = NR), K base products.  A lane sums its ROUNDS of
  // each of its columns two at a time (two independent products in
  // flight: at G = 8 both, 9 % faster than one at a time; all four at G =
  // 4 spilled and were 37 % slower; ops/leaf_groups.py on an H100); the
  // NR factor comes with the operand: its owner writes NR a beside a, and
  // a lane reads the one its round needs.
  GT_INLINE void mul(B* r, const B* a, const B* b) const {
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      slot_put(ex[A + t][tid], a[t]);
      slot_put(ex[AN + t][tid], mul_const<NR>(a[t]));
      slot_put(ex[BB + t][tid], b[t]);
    }
    sync();
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int m = coef(t);
      B acc = fp_zero<P>();
#pragma unroll 2
      for (int i = 0; i < ROUNDS; ++i) {
        const int s = half * ROUNDS + i;
        const B x = read(s > m ? AN : A, (m - s + K) % K);
        acc = add(acc, ::mul(x, read(BB, s)));
      }
      r[t] = acc;
    }
    if constexpr (LPC > 1) {
#pragma unroll
      for (int t = 0; t < KPL; ++t) slot_put(ex[PART + t][tid], r[t]);
      sync();
#pragma unroll
      for (int t = 0; t < KPL; ++t) r[t] = add(r[t], slot_get(ex[PART + t][tid ^ SPAN]));
    } else {
      sync();
    }
  }

  // r1 = b3 a1, r2 = b3 a2 for b3 = c u^E (E = Curve::B3_COEF): column m is
  // a_(m-E mod K) c, times NR where E > m; one base product a column
  GT_INLINE void mul_b3(B* r1, const B* a1, B* r2, const B* a2) const {
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      slot_put(ex[A + t][tid], a1[t]);
      slot_put(ex[BB + t][tid], a2[t]);
    }
    sync();
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = (coef(t) - Curve::B3_COEF + K) % K;
      const B c = slot_get(ex[KB3 + t][tid]);
      r1[t] = ::mul(read(A, j), c);
      r2[t] = ::mul(read(BB, j), c);
    }
    sync();
  }

  // This lane's coefficients of the identity (0 : 1 : 0), and this
  // thread's b3 column constants (the KB3 slots that mul_b3 reads).
  GT_HD void start(B* X, B* Y, B* Z) const {
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int m = coef(t);
      X[t] = Z[t] = fp_zero<P>();
      Y[t] = m == 0 ? fp_one<P>() : fp_zero<P>();
      const B c = Curve::b3().c[Curve::B3_COEF];
      slot_put(ex[KB3 + t][tid], Curve::B3_COEF > m ? mul_const<NR>(c) : c);
    }
  }

  // (X : Y : Z) += (x, y), this lane's coefficients: ec_complete.py's
  // add_mixed (alg 8) in its order (the projective representative
  // depends on it; every field operation ends canonical, so the columns'
  // other formula for a product gives FpKOps.mul's limbs).
  GT_INLINE void add_mixed(B* X, B* Y, B* Z, const B* x, const B* y) const {
    B s1[KPL], s2[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      s1[t] = add(X[t], Y[t]);
      s2[t] = add(x[t], y[t]);
    }
    B t0[KPL], t1[KPL], t3[KPL], t4[KPL], t5[KPL];
    mul(t0, X, x);
    mul(t1, Y, y);
    mul(t3, s1, s2);
    mul(t4, x, Z);  // X2 Z1
    mul(t5, y, Z);  // Y2 Z1
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      t3[t] = sub(t3[t], add(t0[t], t1[t]));
      t4[t] = add(t4[t], X[t]);
      t5[t] = add(t5[t], Y[t]);
      t0[t] = add(dbl(t0[t]), t0[t]);  // 3 X1X2
    }
    B tz[KPL], Z3[KPL], Y3[KPL];
    mul_b3(tz, Z, Y3, t4);  // b3 Z1, b3 t4
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      Z3[t] = add(t1[t], tz[t]);
      t1[t] = sub(t1[t], tz[t]);
    }
    B m0[KPL], m1[KPL];
    mul(m0, t3, t1);
    mul(m1, t5, Y3);
#pragma unroll
    for (int t = 0; t < KPL; ++t) X[t] = sub(m0[t], m1[t]);
    mul(m0, t1, Z3);
    mul(m1, Y3, t0);
#pragma unroll
    for (int t = 0; t < KPL; ++t) Y[t] = add(m0[t], m1[t]);
    mul(m0, Z3, t5);
    mul(m1, t0, t3);
#pragma unroll
    for (int t = 0; t < KPL; ++t) Z[t] = add(m0[t], m1[t]);
  }
};

// sx, sy: [nw, C, L16, R]; sorted position r*C + cs at (w, cs, :, r).
// y limb 0 carries flags: bit 16 = infinity (skip), bit 17 = negative
// digit (add -P).  rows: [nw, C*R, 3*L16]; row cs*R + r = X|Y|Z of the
// running sum after step cs of lane r.  The same function as
// leaf_prefix_kernel, for F = fp^K.
//
// Chain q = w*R + r runs on the G consecutive threads G q .. G q + G - 1,
// one group inside a warp, split by coefficient (Sliced): each lane holds
// its coefficients of the running sum (3 KPL base elements) and of the
// point, so an fp^K addition, subtraction or negation is KPL base ones
// a lane, all lanes at once, and a product is a lane's columns of it
// (mul).  A step: each lane loads its coefficients' limbs of x and y;
// every lane reads the flags in y limb 0 of coefficient 0 itself, so the
// skip and the negation are the group's; ec_complete.py's add_mixed (alg
// 8) in its order (the projective representative depends on it; every
// field operation ends canonical, so the columns' other formula for a
// product gives FpKOps.mul's limbs); each lane stores its coefficients'
// words of X, Y and Z, 16 bytes a word.  Nothing is serial on one lane,
// no running sum passes through shared memory, and a thread's exchange
// slots (Sliced, 4 KPL x 48 bytes) leave the block size free: blocks of
// THREADS, BLOCKS resident an SM, so that registers and not shared
// memory set the occupancy.
template <class Curve, int G, int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    leaf_sliced_kernel(const int64_t* sx, const int64_t* sy, int64_t* rows,
                       int nw, int C, int R) {
  using F = typename Curve::F;
  using SL = Sliced<Curve, G, THREADS>;
  using P = typename SL::P;
  using B = typename SL::B;
  constexpr int KPL = SL::KPL, L = Fp<P>::L16;
  static_assert(G < 32 && 32 % G == 0 && THREADS % 32 == 0,
                "a group lies inside one warp");
  __shared__ typename SL::Slots ex;
  const int tid = threadIdx.x, lane = tid % G;
  const long q = ((long)blockIdx.x * blockDim.x + tid) / G;
  if (q >= (long)nw * R) return;  // the whole group
  const int w = (int)(q / R), r = (int)(q % R);
  const int half = lane / SL::SPAN;
  const SL sl{ex, tid, tid - lane + half * SL::SPAN, lane % SL::SPAN, half,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  B X[KPL], Y[KPL], Z[KPL];  // the running sum's coefficients
  sl.start(X, Y, Z);
  for (int cs = 0; cs < C; ++cs) {
    const long off = ((long)w * C + cs) * F::L16 * R + r;
    const uint32_t flags = (uint32_t)(sy[off] >> 16);
    if (!(flags & 1u)) {
      B x[KPL], y[KPL];
      uint32_t limb0;  // the flags of coefficient 0, masked off
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const long c = off + (long)sl.coef(t) * L * R;
        x[t] = load<P>(sx + c, R, &limb0);
        y[t] = load<P>(sy + c, R, &limb0);
        if (flags & 2u) y[t] = neg(y[t]);
      }
      sl.add_mixed(X, Y, Z, x, y);
    }
    if (SL::LPC > 1 && half) continue;  // a coefficient's first lane stores it
    int64_t* row = rows + ((long)w * C * R + (long)cs * R + r) * 3 * F::L16;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      int64_t* d = row + sl.coef(t) * L;
#pragma unroll
      for (int i = 0; i < Fp<P>::N; ++i) {
        store_word(d + 2 * i, X[t].v[i]);
        store_word(d + F::L16 + 2 * i, Y[t].v[i]);
        store_word(d + 2 * F::L16 + 2 * i, Z[t].v[i]);
      }
    }
  }
}

// ---- the fixed-base scan, a thread group a column ----------------------------

// 32-bit words of one entry of the fixed-base table: x's words, y's words,
// a flag (nonzero: infinity), padded to whole 16-byte vectors
// (ops/fixed_base.py's point_major).
template <class F>
GT_HD constexpr int fixed_base_entry() { return (2 * F::N + 4) / 4 * 4; }

// Digit w of column j: bits [c w, c w + c) of the scalar's Ls 16-bit limb
// planes sc [Ls, n], zero above the top limb (ops/msm.py's window_digits;
// c <= 16, so two limbs hold it).
GT_HD uint32_t window_digit(const int64_t* sc, long n, long j, int Ls, int c,
                            int w) {
  const int bit = c * w, q = bit >> 4, sh = bit & 15;
  uint32_t v = 0;
  if (q < Ls) v = (uint32_t)sc[(long)q * n + j];
  if (q + 1 < Ls) v |= (uint32_t)sc[(long)(q + 1) * n + j] << 16;
  return (v >> sh) & ((1u << c) - 1u);
}

// sc: [Ls, n] regular-form 16-bit scalar limbs; table: [nwin, 2^c, E]
// words, entry (w, d) = d 2^(c w) G (fixed_base_entry); out: [3*L16, n],
// X over Y over Z.  The plain version (ops/fixed_base.py's
// fixed_base_plain; gnark_tpu's FixedBaseTable._run, fixed_base.py:56, a
// jitted lax.scan through XLA): column j starts at (0 : 1 : 0), adds the
// entry of each window's digit of s_j, w = 0 .. nwin - 1, with the
// complete mixed addition unless the entry is flagged infinite, and leaves
// as (X Z, Y Z^2, Z): the same additions of the same operands in the same
// order, so the same limbs.
//
// Column j runs on the G consecutive threads G j .. G j + G - 1, one group
// inside a warp sharing a FoldShared slot, as a leaf chain does: each
// window every lane computes the digit and reads the entry's flag (so the
// skip is the group's), lane 0 reads its x and y words and adds them with
// fold_add_mixed (the products spread over the group); fold_jacobian at
// the end, then the group stores the result's 3 W words as 16-bit limbs,
// lane j words j, j + G, ...  What bounds it: the nwin mixed additions'
// products a column; the table (0.5 MB for G1 at c = 8) stays in L2 and
// the digits' limbs are read from device memory once.
template <class Curve, int G>
__global__ void __launch_bounds__(LeafBlock<typename Curve::F, G>::THREADS)
    fixed_base_kernel(const int64_t* sc, const uint32_t* table, int64_t* out,
                      int n, int Ls, int c, int nwin) {
  using F = typename Curve::F;
  constexpr int W = F::N, E = fixed_base_entry<F>();
  static_assert(G < 32 && 32 % G == 0, "a group lies inside one warp");
  static_assert(sizeof(FoldShared<F>::A) >= 3 * W * sizeof(uint32_t),
                "the result fits in the slot");
  __shared__ FoldShared<F> slots[LeafBlock<F, G>::THREADS / G];
  const long j = ((long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (j >= n) return;  // the whole group
  const int lane = threadIdx.x % G;
  FoldShared<F>& s = slots[threadIdx.x / G];
  const GroupSync sync{((1u << G) - 1u) << (threadIdx.x % 32 / G * G)};
  Point<F> acc = identity<Curve>();  // lane 0's
  for (int w = 0; w < nwin; ++w) {
    const uint32_t* e =
        table + (((long)w << c) + window_digit(sc, n, j, Ls, c, w)) * E;
    if (e[2 * W]) continue;
    F px, py;
    if (lane == 0) {
      words_to(px, e);
      words_to(py, e + W);
    }
    fold_add_mixed<Curve>(acc, px, py, s, lane, G, sync);
  }
  fold_jacobian<Curve>(acc, s, lane, G, sync);
  uint32_t* sum = reinterpret_cast<uint32_t*>(s.A);  // X, Y, Z words
  if (lane == 0) {
    words_from(sum, acc.X);
    words_from(sum + W, acc.Y);
    words_from(sum + 2 * W, acc.Z);
  }
  sync();
  for (int i = lane; i < 3 * W; i += G) {
    out[2L * i * n + j] = sum[i] & 0xffffu;
    out[(2L * i + 1) * n + j] = sum[i] >> 16;
  }
}

// The same function as fixed_base_kernel, for F = fp^K: column j on a group
// of G lanes split by coefficient (Sliced), as leaf_sliced_kernel runs a
// chain.  Each window every lane reads the flag and its coefficients' words
// of x and y, then Sliced::add_mixed; at the end X Z, Z^2 and Y Z^2 as
// three of Sliced's products, and each coefficient's first lane stores its
// coefficients of X, Y and Z.
template <class Curve, int G, int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    fixed_base_sliced_kernel(const int64_t* sc, const uint32_t* table,
                             int64_t* out, int n, int Ls, int c, int nwin) {
  using F = typename Curve::F;
  using SL = Sliced<Curve, G, THREADS>;
  using P = typename SL::P;
  using B = typename SL::B;
  constexpr int KPL = SL::KPL, N = Fp<P>::N, L = Fp<P>::L16, W = F::N;
  constexpr int E = fixed_base_entry<F>();
  static_assert(G < 32 && 32 % G == 0 && THREADS % 32 == 0,
                "a group lies inside one warp");
  __shared__ typename SL::Slots ex;
  const int tid = threadIdx.x, lane = tid % G;
  const long j = ((long)blockIdx.x * blockDim.x + tid) / G;
  if (j >= n) return;  // the whole group
  const int half = lane / SL::SPAN;
  const SL sl{ex, tid, tid - lane + half * SL::SPAN, lane % SL::SPAN, half,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  B X[KPL], Y[KPL], Z[KPL];  // the running sum's coefficients
  sl.start(X, Y, Z);
  for (int w = 0; w < nwin; ++w) {
    const uint32_t* e =
        table + (((long)w << c) + window_digit(sc, n, j, Ls, c, w)) * E;
    if (e[2 * W]) continue;
    B x[KPL], y[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      words_to(x[t], e + sl.coef(t) * N);
      words_to(y[t], e + W + sl.coef(t) * N);
    }
    sl.add_mixed(X, Y, Z, x, y);
  }
  B XZ[KPL], ZZ[KPL];
  sl.mul(XZ, X, Z);
  sl.mul(ZZ, Z, Z);
  sl.mul(Y, Y, ZZ);
  if (SL::LPC > 1 && half) return;  // a coefficient's first lane stores it
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    int64_t* d = out + (long)sl.coef(t) * L * n + j;
    store(XZ[t], d, n);
    store(Y[t], d + (long)F::L16 * n, n);
    store(Z[t], d + 2L * F::L16 * n, n);
  }
}

// ---- complete point operations over fp^K, a point's coefficients over a group

// The exchange of one group's point operations, by coefficient: a level's
// values and their NR multiples (at most 9: alg 7's second level has 6
// values, 3 of them first operands), and its products' columns (at most 6).
template <class P, int K>
struct PointSlots {
  XSlot<P> v[9][K], r[6][K];
};

// Product k's operand as value a, plus value a2 (7: none): 6 bits a
// product, for SlicedPoint::level's DA and DB.
GT_HD constexpr uint64_t opnd(int k, int a, int a2 = 7) {
  return (uint64_t)(a | a2 << 3) << (6 * k);
}

// ec_complete.cuh's padd (alg 7) and pdbl (alg 9) over F = fp^K (u^K =
// NR) on a group of G lanes that hold a point by coefficient: the first
// SPAN = min(G, K) lanes own distinct coefficients, lane l coefficients l,
// l + SPAN, ... (KPL = K / SPAN of them); where G > K, LPC = G / SPAN
// lanes hold each coefficient, the same values on each (its copies, half
// = 0 .. LPC - 1).  An addition is KPL base additions a lane.  A formula's
// independent products run as one level (level): the lanes write the
// level's values to the group's slots, one sync, each lane computes its
// columns of its products, one sync, each lane reads its columns of all
// of them.  So a point operation is its two levels of products and the
// b3 level between them (mul_b3), in the formula's order: every field
// operation ends canonical, so the columns give FpKOps.mul's limbs and the
// point the plain version's representative.  Every base product is
// inlined (ptxas -O3 miscompiles the fp4 product called as a function,
// ops/inline_check.py).
template <class Curve, int G>
struct SlicedPoint {
  using T = FpKTraits<typename Curve::F>;
  using P = typename T::P;
  using B = Fp<P>;
  using Pt = Point<typename Curve::F>;
  static constexpr int K = T::DEG, NR = T::NR, E = Curve::B3_COEF;
  static constexpr int SPAN = G < K ? G : K, KPL = K / SPAN, LPC = G / SPAN;
  static_assert(K % SPAN == 0 && G % SPAN == 0, "G divides K, or K divides G");
  using Slots = PointSlots<P, K>;

  Slots& s;
  const XSlot<P>* kb3;  // the block's b3 column constants (b3_column)
  int lane0, half;      // this lane's first coefficient and its copy
  GroupSync sync;

  GT_HD int coef(int t) const { return lane0 + SPAN * t; }

  // This lane's coefficients of a point in a scratch of whole points, and
  // back (by a coefficient's first copy), and of the identity (0 : 1 : 0).
  GT_HD void get(const Pt& p, B* X, B* Y, B* Z) const {
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      X[t] = p.X.c[coef(t)];
      Y[t] = p.Y.c[coef(t)];
      Z[t] = p.Z.c[coef(t)];
    }
  }
  GT_HD void put(Pt& p, const B* X, const B* Y, const B* Z) const {
    if (half) return;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      p.X.c[coef(t)] = X[t];
      p.Y.c[coef(t)] = Y[t];
      p.Z.c[coef(t)] = Z[t];
    }
  }
  GT_HD void identity(B* X, B* Y, B* Z) const {
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      X[t] = Z[t] = fp_zero<P>();
      Y[t] = coef(t) == 0 ? fp_one<P>() : fp_zero<P>();
    }
  }

  // Column m's constant of b3 = c u^E: c, times NR where E > m.
  GT_HD static B b3_column(int m) {
    const B c = Curve::b3().c[E];
    return E > m ? mul_const<NR>(c) : c;
  }

  // r_k = a_k b_k for the level's M products, from its NV values v: each
  // lane writes its coefficients of the values (a coefficient's copies
  // share them out) and NR times those of the first NA, one sync; each
  // lane computes its columns of products k = half, half + LPC, ...
  // (column m is sum_s a_(m-s mod K) b_s, a's NR multiple where s > m, so
  // a product's first operand is among the first NA values) into the r
  // slots, one sync; every lane reads its columns of all M.  DA, DB:
  // opnd() of each product's first and second operand.  The k loop stays
  // rolled: one column's code, two base products in flight.
  template <int M, int NV, int NA, uint64_t DA, uint64_t DB>
  GT_INLINE void level(B (*r)[KPL], const B (*v)[KPL]) const {
    static_assert(M <= 6 && NV + NA <= 9 && NV < 7 && NA <= NV, "slots");
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i % LPC == half)
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          slot_put(s.v[i][coef(t)], v[i][t]);
          if (i < NA) slot_put(s.v[NV + i][coef(t)], mul_const<NR>(v[i][t]));
        }
    sync();
#pragma unroll 1
    for (int k = half; k < M; k += LPC) {
      const int a = DA >> (6 * k) & 7, a2 = DA >> (6 * k + 3) & 7;
      const int b = DB >> (6 * k) & 7, b2 = DB >> (6 * k + 3) & 7;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int m = coef(t);
        B acc = fp_zero<P>();
#pragma unroll 2
        for (int i = 0; i < K; ++i) {
          const int j = (m - i + K) % K, an = i > m ? NV : 0;
          B x = slot_get(s.v[an + a][j]), y = slot_get(s.v[b][i]);
          if (a2 != 7) x = add(x, slot_get(s.v[an + a2][j]));
          if (b2 != 7) y = add(y, slot_get(s.v[b2][i]));
          acc = add(acc, ::mul(x, y));
        }
        slot_put(s.r[k][m], acc);
      }
    }
    sync();
#pragma unroll
    for (int k = 0; k < M; ++k)
#pragma unroll
      for (int t = 0; t < KPL; ++t) r[k][t] = slot_get(s.r[k][coef(t)]);
  }

  // r_q = b3 a_q for q < NB (r may be a): column m is a_(m-E mod K) times
  // the block's kb3[m], one base product; the operands through the v
  // slots, a sync before the reads and one after.
  template <int NB>
  GT_INLINE void mul_b3(B (*r)[KPL], const B (*a)[KPL]) const {
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if (q % LPC == half)
#pragma unroll
        for (int t = 0; t < KPL; ++t) slot_put(s.v[q][coef(t)], a[q][t]);
    sync();
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int m = coef(t);
      const B c = slot_get(kb3[m]);
#pragma unroll
      for (int q = 0; q < NB; ++q)
        r[q][t] = ::mul(slot_get(s.v[q][(m - E + K) % K]), c);
    }
    sync();
  }

  // P = 2P: alg 9's Y^2, YZ, Z^2, XY; b3 Z^2; t2 Z3, YZ Z3, t0 Y3, t0 XY
  GT_INLINE void pdbl(B* X, B* Y, B* Z) const {
    B v[6][KPL], r[4][KPL], t2[1][KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      v[0][t] = Y[t];
      v[1][t] = Z[t];
      v[2][t] = X[t];
    }
    level<4, 3, 2, opnd(0, 0) | opnd(1, 0) | opnd(2, 1) | opnd(3, 0),
          opnd(0, 0) | opnd(1, 1) | opnd(2, 1) | opnd(3, 2)>(r, v);
    mul_b3<1>(t2, r + 2);
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const B t0 = r[0][t], b = t2[0][t];
      v[0][t] = dbl(dbl(dbl(t0)));       // Z3 = 8 Y^2
      v[1][t] = sub(t0, add(dbl(b), b));  // t0 = Y^2 - 3 b3 Z^2
      v[2][t] = b;
      v[3][t] = r[1][t];                  // YZ
      v[4][t] = add(t0, b);               // Y3
      v[5][t] = r[3][t];                  // XY
    }
    level<4, 6, 2, opnd(0, 0) | opnd(1, 0) | opnd(2, 1) | opnd(3, 1),
          opnd(0, 2) | opnd(1, 3) | opnd(2, 4) | opnd(3, 5)>(r, v);
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      X[t] = dbl(r[3][t]);
      Y[t] = add(r[2][t], r[0][t]);
      Z[t] = r[1][t];
    }
  }

  // P = P + Q: alg 7's X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
  // (X1+Z1)(X2+Z2) (the sums at the reader); b3 t2, b3 Y3; t3 t1, Y3 t4,
  // Z3 t1, Y3 t0, Z3 t4, t3 t0
  GT_INLINE void padd(B* X, B* Y, B* Z, const B* X2, const B* Y2,
                      const B* Z2) const {
    B v[6][KPL], r[6][KPL], b[2][KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      v[0][t] = X[t];
      v[1][t] = Y[t];
      v[2][t] = Z[t];
      v[3][t] = X2[t];
      v[4][t] = Y2[t];
      v[5][t] = Z2[t];
    }
    level<6, 6, 3,
          opnd(0, 0) | opnd(1, 1) | opnd(2, 2) | opnd(3, 0, 1) | opnd(4, 1, 2) |
              opnd(5, 0, 2),
          opnd(0, 3) | opnd(1, 4) | opnd(2, 5) | opnd(3, 3, 4) | opnd(4, 4, 5) |
              opnd(5, 3, 5)>(r, v);
    B t0[KPL], t1[KPL], t3[KPL], t4[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      t1[t] = r[1][t];
      t3[t] = sub(r[3][t], add(r[0][t], r[1][t]));
      t4[t] = sub(r[4][t], add(r[1][t], r[2][t]));
      b[0][t] = r[2][t];                                // t2
      b[1][t] = sub(r[5][t], add(r[0][t], r[2][t]));  // Y3
      t0[t] = add(dbl(r[0][t]), r[0][t]);              // 3 X1X2
    }
    mul_b3<2>(b, b);
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      v[0][t] = t3[t];
      v[1][t] = add(t1[t], b[0][t]);  // Z3
      v[2][t] = b[1][t];              // Y3
      v[3][t] = sub(t1[t], b[0][t]);  // t1
      v[4][t] = t4[t];
      v[5][t] = t0[t];
    }
    level<6, 6, 3,
          opnd(0, 0) | opnd(1, 2) | opnd(2, 1) | opnd(3, 2) | opnd(4, 1) |
              opnd(5, 0),
          opnd(0, 3) | opnd(1, 4) | opnd(2, 3) | opnd(3, 5) | opnd(4, 4) |
              opnd(5, 5)>(r, v);
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      X[t] = sub(r[0][t], r[1][t]);
      Y[t] = add(r[2][t], r[3][t]);
      Z[t] = add(r[4][t], r[5][t]);
    }
  }

  // P = (X Z, Y Z^2, Z), ec_complete.py's to_jacobian: X Z and Z^2, then
  // Y Z^2, two levels
  GT_INLINE void jacobian(B* X, B* Y, const B* Z) const {
    B v[2][KPL], r[2][KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      v[0][t] = X[t];
      v[1][t] = Z[t];
    }
    level<2, 2, 2, opnd(0, 0) | opnd(1, 1), opnd(0, 1) | opnd(1, 1)>(r, v);
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      X[t] = r[0][t];
      v[0][t] = Y[t];
      v[1][t] = r[1][t];
    }
    level<1, 2, 1, opnd(0, 0), opnd(0, 1)>(r, v);
#pragma unroll
    for (int t = 0; t < KPL; ++t) Y[t] = r[0][t];
  }
};

// The block of a sliced kernel whose groups each run their own point
// operations (the weighted sum, the reduction): b3's columns and the
// slots of its THREADS / G groups (2.9 KB a group).
template <class Curve, int G, int THREADS>
struct GroupsShared {
  using SP = SlicedPoint<Curve, G>;
  XSlot<typename SP::P> kb3[SP::K];
  typename SP::Slots slots[THREADS / G];
};

// A point's coefficients as a lane holds them: coordinate c's coefficient
// m of a point of [3*L16, ...] limb planes at src, limb stride `stride`.
template <class SP>
GT_HD void load_sliced(const SP& sp, const int64_t* src, long stride,
                       typename SP::B* X, typename SP::B* Y,
                       typename SP::B* Z) {
  constexpr long L = Fp<typename SP::P>::L16, L3 = SP::K * L;
#pragma unroll
  for (int t = 0; t < SP::KPL; ++t) {
    const int64_t* c = src + sp.coef(t) * L * stride;
    X[t] = load<typename SP::P>(c, stride);
    Y[t] = load<typename SP::P>(c + L3 * stride, stride);
    Z[t] = load<typename SP::P>(c + 2 * L3 * stride, stride);
  }
}

// The same stored, by a coefficient's first copy (half 0).
template <class SP>
GT_HD void store_sliced(const SP& sp, int64_t* dst, long stride,
                        const typename SP::B* X, const typename SP::B* Y,
                        const typename SP::B* Z) {
  constexpr long L = Fp<typename SP::P>::L16, L3 = SP::K * L;
  if (sp.half) return;
#pragma unroll
  for (int t = 0; t < SP::KPL; ++t) {
    int64_t* c = dst + sp.coef(t) * L * stride;
    store(X[t], c, stride);
    store(Y[t], c + L3 * stride, stride);
    store(Z[t], c + 2 * L3 * stride, stride);
  }
}

// The Horner fold's block over fp^K: b3's columns and the group's slots.
template <class Curve, int G>
struct FoldSlicedShared {
  using SP = SlicedPoint<Curve, G>;
  XSlot<typename SP::P> kb3[SP::K];
  typename SP::Slots slots;
};

// S: [3*L16, nw]; out: [3*L16, 1] = sum_w 2^(c w) S_w, the same function as
// horner_fold_kernel, for F = fp^K: one group of G lanes (SlicedPoint)
// runs the chain, c doublings and one addition a window from the highest
// window that is not the identity (every lane finds it: no shared word),
// each lane loading its coefficients of S[w].  One block of G threads.
// The chain is latency-bound: a doubling is 3 levels, 5 syncs of the
// group, and each lane's columns (at G = 16, four lanes a coefficient,
// one or two products of 4 base products a level) in place of lane 0's
// 16-product schoolbook and the additions between levels.
// SlicedPoint::jacobian maps the sum to (X Z, Y Z^2, Z) before it is
// stored.
template <class Curve, int G>
__global__ void __launch_bounds__(G)
    horner_fold_sliced_kernel(const int64_t* S, int64_t* out, int nw, int c) {
  using SP = SlicedPoint<Curve, G>;
  using Sh = FoldSlicedShared<Curve, G>;
  using B = typename SP::B;
  constexpr int KPL = SP::KPL;
  static_assert(G <= 16 && 32 % G == 0, "a group lies inside one warp");
  __shared__ Sh sh;
  const int tid = threadIdx.x, lane = tid % G;
  for (int m = tid; m < SP::K; m += blockDim.x) slot_put(sh.kb3[m], SP::b3_column(m));
  __syncthreads();
  const SP sp{sh.slots, sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  using IO = FieldIO<typename Curve::F>;
  const long Zoff = 2L * Curve::F::L16 * nw;
  int top = nw - 1;
  while (top > 0 && is_zero(IO::load(S + top + Zoff, nw))) --top;
  B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
  load_sliced(sp, S + top, nw, X, Y, Z);
  for (int w = top - 1; w >= 0; --w) {
    for (int k = 0; k < c; ++k) sp.pdbl(X, Y, Z);
    load_sliced(sp, S + w, nw, X2, Y2, Z2);
    sp.padd(X, Y, Z, X2, Y2, Z2);
  }
  sp.jacobian(X, Y, Z);
  store_sliced(sp, out, 1, X, Y, Z);
}

// Coordinate c (X, Y, Z) of a point.
template <class F>
GT_HD F& coordinate(Point<F>& p, int c) {
  return c == 0 ? p.X : c == 1 ? p.Y : p.Z;
}

// bk: [3*L16, nw, nb], out: [3*L16, nw], scratch: as weighted_sum_kernel's,
// and the same function, for F = fp^K: the same wavefront (wsum_steps),
// the same operations of each step on the same operands in the same
// order, and the same scratch layout.  Each operation runs on one group
// of G lanes (SlicedPoint): every lane reads its coefficients of the
// operands from scratch, the group runs padd or pdbl, and each
// coefficient's first copy writes its coefficients of the result (the
// last step: of out).  The threads of a window's cluster load its
// buckets into scratch a base element each, neighbouring threads
// neighbouring buckets.  No lane holds a whole point and nothing waits
// on a serial lane 0: the template kernel's lane 0 held two 120-word
// points and dealt 16 base products a product through an 11.5 KB slot
// (255 registers, 1.9 KB of spills on an H100), where a group's
// PointSlots are 2.9 KB.  Launch bounds of one block an SM: left to
// itself ptxas capped it at 128 registers and spilled.
template <class Curve, int G, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
    weighted_sum_sliced_kernel(const int64_t* bk, int64_t* out,
                               Point<typename Curve::F>* scratch, int nw,
                               int nb) {
  using SP = SlicedPoint<Curve, G>;
  using Sh = GroupsShared<Curve, G, THREADS>;
  using Pt = typename SP::Pt;
  using P = typename SP::P;
  using B = typename SP::B;
  constexpr int KPL = SP::KPL, D = SP::K, L = Fp<P>::L16;
  static_assert(G <= 16 && 32 % G == 0 && THREADS % G == 0,
                "a group lies inside one warp");
  const int w = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % G;
  const int groups = CLUSTER * (nt / G), group = rank * (nt / G) + tid / G;
  Sh& sh = sliced_shared<Sh, CLUSTER>(rank);
  for (int m = tid; m < D; m += nt) slot_put(sh.kb3[m], SP::b3_column(m));
  const SP sp{sh.slots[tid / G], sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  const long stride = (long)nw * nb;
  Pt* Bk = scratch + (long)w * (nb + nb / 2);
  Pt* T = Bk + nb;
  Pt* W = T + nb / 2 - 1;  // W_k for k < K
  auto hs = [&](int k) { return k >= 2 ? T + (1 << (k - 2)) - 1 : Bk + 1; };
  int K = 0;
  while ((1 << K) < nb) ++K;
  // element e = (coordinate, coefficient) of bucket j, from its limb planes
  for (long o = (long)rank * nt + tid; o < 3L * D * nb; o += (long)CLUSTER * nt) {
    const int j = (int)(o % nb), e = (int)(o / nb);
    coordinate(Bk[j], e / D).c[e % D] =
        load<P>(bk + (long)w * nb + j + (long)e * L * stride, stride);
  }
  wsum_sync<CLUSTER>();  // the buckets, and b3's columns
  B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
  if (K == 0) {
    if (group == 0) {
      sp.get(Bk[0], X, Y, Z);
      store_sliced(sp, out + w, nw, X, Y, Z);
    }
    return;
  }
  const int Dsteps = wsum_steps(K);
  for (int s = 1; s <= Dsteps; ++s) {
    // this step's operations, in weighted_sum_kernel's order
    const int nf = s <= K ? 1 << (K - s) : 0;
    const int per = s < K ? 1 << (K - 1 - s) : 0;
    const int ntr = s * per;
    const int nd = s >= K && s <= 2 * K - 2 ? 2 * K - 1 - s : 0;
    const int nwk = s == Dsteps || (s >= 2 * K - 1 && s <= 3 * K - 3) ? 1 : 0;
    const int nops = nf + ntr + nd + nwk;
    for (int o = group; o < nops; o += groups) {
      const Pt *a, *b = nullptr;  // b: none for a doubling
      Pt* dst = nullptr;          // none: S, into out
      if (o < nf) {
        dst = Bk + o;
        a = Bk + o;
        b = Bk + nf + o;
      } else if (o < nf + ntr) {
        const int q = o - nf, k = K - q / per, j = q % per;
        Pt* Tk = hs(k);
        const Pt* src = s == K - k + 1 ? Bk + (1 << (k - 1)) : Tk;
        dst = Tk + j;
        a = src + j;
        b = src + per + j;
      } else if (o < nf + ntr + nd) {
        dst = hs(K - (o - nf - ntr));
        a = dst;
      } else if (s < Dsteps) {
        const int k = 3 * K - 2 - s;
        dst = W;
        a = k == K - 1 ? hs(K) : W;
        b = hs(k);
      } else {
        a = Bk;
        b = K == 1 ? hs(1) : W;
      }
      sp.get(*a, X, Y, Z);
      if (b) {
        sp.get(*b, X2, Y2, Z2);
        sp.padd(X, Y, Z, X2, Y2, Z2);
      } else {
        sp.pdbl(X, Y, Z);
      }
      if (dst)
        sp.put(*dst, X, Y, Z);
      else
        store_sliced(sp, out + w, nw, X, Y, Z);
    }
    wsum_sync<CLUSTER>();
  }
}

// tot, out: [3*L16, nw, R], scratch: nw * R points, as lane_offsets_kernel's,
// and the same function, for F = fp^K: the same Brent-Kung steps
// (scan_step), each adding A[i - half] to A[i] in the same order, then the
// exclusive shift.  Each addition runs on one group of G lanes
// (SlicedPoint): every lane reads its coefficients of both operands from
// scratch, the group runs padd, and each coefficient's first copy writes
// its coefficients of the sum back to A[i].  A step's additions read and
// write distinct lanes (it writes the lanes -1 mod 2^(d+1) and reads on
// the left those 2^d - 1), so a group's rounds in one step never read
// what it wrote in that step, and the copies need no group sync between
// them; the barrier between two steps orders the rest.  The threads of a
// window's cluster load its totals into scratch, and store the shifted
// output, a base element each, neighbouring threads neighbouring lanes.
// As in the template, a run of steps with fewer additions than a block
// has groups runs on rank 0's block alone, __syncthreads between two.
// The template's lane 0 held two 120-word points and dealt 16 base
// products a product through an 11.5 KB slot (255 registers, spills, 128
// threads a block on an H100); a group's PointSlots are 2.9 KB.  Launch
// bounds of one block an SM: left to itself ptxas capped the other sliced
// kernels at 128 registers and spilled.
template <class Curve, int G, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
    lane_offsets_sliced_kernel(const int64_t* tot, int64_t* out,
                               Point<typename Curve::F>* scratch, int nw,
                               int R) {
  using SP = SlicedPoint<Curve, G>;
  using Sh = GroupsShared<Curve, G, THREADS>;
  using P = typename SP::P;
  using B = typename SP::B;
  constexpr int KPL = SP::KPL, D = SP::K, L = Fp<P>::L16, A = THREADS / G;
  static_assert(G <= 16 && 32 % G == 0 && THREADS % G == 0,
                "a group lies inside one warp");
  const int w = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % G;
  Sh& sh = sliced_shared<Sh, CLUSTER>(rank);
  for (int m = tid; m < D; m += nt) slot_put(sh.kb3[m], SP::b3_column(m));
  const SP sp{sh.slots[tid / G], sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  const long stride = (long)nw * R;
  typename SP::Pt* S = scratch + (long)w * R;
  int K = 0;
  while ((1 << K) < R) ++K;
  // element e = (coordinate, coefficient) of lane r, from its limb planes
  const long elems = 3L * D * R;
  for (long o = (long)rank * nt + tid; o < elems; o += (long)CLUSTER * nt) {
    const int r = (int)(o % R), e = (int)(o / R);
    coordinate(S[r], e / D).c[e % D] =
        load<P>(tot + (long)w * R + r + (long)e * L * stride, stride);
  }
  wsum_sync<CLUSTER>();  // the totals, and b3's columns
  const int steps = K ? 2 * K - 1 : 0;
  auto alone = [&](int s) {  // step s on rank 0's block alone
    return CLUSTER > 1 && s < steps && scan_step(K, R, s).count < A;
  };
  B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
  for (int s = 0; s < steps; ++s) {
    const ScanStep st = scan_step(K, R, s);
    const bool solo = alone(s);
    if (!solo || rank == 0) {
      const int groups = solo ? A : CLUSTER * A;
      for (int o = (solo ? 0 : rank * A) + tid / G; o < st.count;
           o += groups) {
        const int i = st.first + 2 * st.half * o;
        sp.get(S[i - st.half], X, Y, Z);
        sp.get(S[i], X2, Y2, Z2);
        sp.padd(X, Y, Z, X2, Y2, Z2);
        sp.put(S[i], X, Y, Z);
      }
    }
    if (!solo || !alone(s + 1))
      wsum_sync<CLUSTER>();
    else if (rank == 0)
      __syncthreads();
  }
  // out[r] = A[r - 1], lane 0 the identity (0 : 1 : 0)
  for (long o = (long)rank * nt + tid; o < elems; o += (long)CLUSTER * nt) {
    const int r = (int)(o % R), e = (int)(o / R);
    const B v = r ? coordinate(S[r - 1], e / D).c[e % D]
                  : e == D ? fp_one<P>() : fp_zero<P>();
    store(v, out + (long)w * R + r + (long)e * L * stride, stride);
  }
}

// rows, offs, d_sorted, out as buckets_kernel's, and the same function,
// for F = fp^K: the same boundaries, the same complete additions on the
// same operands in the same order, the same runs of RUN buckets a block.
// Each addition runs on one group of G lanes (SlicedPoint): every lane
// reads its coefficients of the row and the offset (or of the two
// prefixes), the group runs padd, and each coefficient's first copy
// writes its coefficients of the prefix to shared memory (or of the
// bucket to out).  The prefixes and the buckets are two rounds of one
// loop, so padd is inlined once (ptxas -O3 miscompiles the fp4 product
// called as a function, ops/inline_check.py).  The template's lane 0
// would hold two 120-word points and deal 16 base products a product
// through an 11.5 KB slot; a group's PointSlots are 2.9 KB.  Launch bounds
// of one block an SM: left to itself ptxas capped the other sliced
// kernels at 128 registers and spilled.
template <class Curve, int G, int THREADS>
struct BucketsSlicedShared {
  using SP = SlicedPoint<Curve, G>;
  XSlot<typename SP::P> kb3[SP::K];  // b3's columns
  BucketsBlock<typename SP::Slots, typename SP::Pt, THREADS / G> run;
};

template <class Curve, int G, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
    buckets_sliced_kernel(const int64_t* rows, const int64_t* offs,
                          const int64_t* d_sorted, int64_t* out, int nw,
                          int C, int R, int nb) {
  using SP = SlicedPoint<Curve, G>;
  using B = typename SP::B;
  using Block = BucketsSlicedShared<Curve, G, THREADS>;
  constexpr int KPL = SP::KPL, GROUPS = THREADS / G;
  constexpr int RUN = buckets_run(GROUPS);
  constexpr int L16 = Curve::F::L16;
  static_assert(G <= 16 && 32 % G == 0 && THREADS % G == 0,
                "a group lies inside one warp");
  Block& sh = sliced_shared<Block>();
  const int per = (nb + RUN - 1) / RUN;  // blocks a window
  const int w = blockIdx.x / per, b0 = blockIdx.x % per * RUN;
  const int cnt = nb - b0 < RUN ? nb - b0 : RUN;
  const int tid = threadIdx.x, lane = tid % G, group = tid / G;
  const long n = (long)C * R;
  for (int m = tid; m < SP::K; m += THREADS) slot_put(sh.kb3[m], SP::b3_column(m));
  for (int t = tid; t <= cnt; t += THREADS)
    sh.run.ends[t] = last_at_most(d_sorted + w * n, n, b0 + t);
  __syncthreads();
  const SP sp{sh.run.slots[group], sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
  // round 0: the prefixes PE_o, o = 0 .. cnt; round 1: the buckets
#pragma unroll 1
  for (int round = 0; round < 2; ++round) {
    for (int o = group; o < cnt + 1 - round; o += GROUPS) {
      long e = 0;
      if (round == 0) {
        e = sh.run.ends[o];
        const long g = e < 0 ? 0 : e, r = g / C;
        load_sliced(sp, rows + (w * n + g % C * R + r) * 3 * L16, 1, X, Y, Z);
        load_sliced(sp, offs + (long)w * R + r, (long)nw * R, X2, Y2, Z2);
      } else {
        sp.get(sh.run.pe[o + 1], X, Y, Z);
        sp.get(sh.run.pe[o], X2, Y2, Z2);
#pragma unroll
        for (int t = 0; t < KPL; ++t) Y2[t] = neg(Y2[t]);
      }
      sp.padd(X, Y, Z, X2, Y2, Z2);
      if (round == 0) {
        if (e < 0)
#pragma unroll
          for (int t = 0; t < KPL; ++t) X[t] = Z[t] = fp_zero<typename SP::P>();
        sp.put(sh.run.pe[o], X, Y, Z);
      } else {
        store_sliced(sp, out + (long)w * nb + b0 + o, (long)nw * nb, X, Y, Z);
      }
    }
    __syncthreads();
  }
}

// ---- the chunked, windowed ladder ---------------------------------------------

constexpr int LADDER_CHUNKS = 16;  // K: chunks a scalar, a thread each
constexpr int LADDER_WINDOW = 4;   // w: bits a window
constexpr int LADDER_TABLE = 1 << LADDER_WINDOW;
constexpr int REDUCE_LANES = 256;  // accumulators a chunk of the reduction
// threads a block: Curve::LADDER_POINTS points (8, or 4 where the table of
// 8 would pass 48 KB of static shared memory) x K chunks
template <class Curve>
constexpr int ladder_threads() { return Curve::LADDER_POINTS * LADDER_CHUNKS; }

// A curve's shipped ladder, fold and reduction (GNARK_MSM_SHAPE): over
// fp^K the sliced kernels' LADDER_GROUP threads a chain in blocks of
// LADDER_THREADS, LADDER_BLOCKS an SM, FOLD_GROUP threads, and the
// reduction's REDUCE_GROUP threads an accumulator in blocks of
// REDUCE_THREADS, REDUCE_CLUSTER blocks a chunk; otherwise ladder_kernel's
// thread a chain, horner_fold_kernel's warp and reduce_kernel's block of
// REDUCE_LANES threads a chunk.
template <class Curve, bool = FpKTraits<typename Curve::F>::SLICED>
struct LadderShape {
  static constexpr int GROUP = Curve::LADDER_GROUP,
                       THREADS = Curve::LADDER_THREADS,
                       BLOCKS = Curve::LADDER_BLOCKS, FOLD = Curve::FOLD_GROUP,
                       REDUCE_GROUP = Curve::REDUCE_GROUP,
                       REDUCE_THREADS = Curve::REDUCE_THREADS,
                       REDUCE_CLUSTER = Curve::REDUCE_CLUSTER;
};
template <class Curve>
struct LadderShape<Curve, false> {
  static constexpr int GROUP = 1, THREADS = ladder_threads<Curve>(),
                       BLOCKS = Curve::LADDER_BLOCKS, FOLD = FOLD_THREADS,
                       REDUCE_GROUP = 1, REDUCE_THREADS = REDUCE_LANES,
                       REDUCE_CLUSTER = 1;
};

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
__global__ void __launch_bounds__(ladder_threads<Curve>(), Curve::LADDER_BLOCKS)
    ladder_kernel(const int64_t* xs, const int64_t* ys, const uint8_t* inf,
                  const int64_t* sc, int64_t* out, int n, int Ls) {
  using F = typename Curve::F;
  using P = Point<F>;
  using IO = FieldIO<F>;
  constexpr int K = LADDER_CHUNKS, w = LADDER_WINDOW;
  constexpr int LADDER_POINTS = Curve::LADDER_POINTS;
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

// A table entry over fp^K, by coordinate and coefficient.
template <class P, int K>
using SlicedEntry = XSlot<P>[3][K];

// The sliced ladder's block: b3's columns, the table of LADDER_TABLE
// multiples of each of its PTS points, and its groups' slots (110.8 KB at
// G = 4 and 128 threads: two points).
template <class Curve, int G, int THREADS>
struct LadderShared {
  using SP = SlicedPoint<Curve, G>;
  using P = typename SP::P;
  static constexpr int CHAINS = THREADS / G;
  static constexpr int PTS = CHAINS >= LADDER_CHUNKS ? CHAINS / LADDER_CHUNKS : 1;
  XSlot<P> kb3[SP::K];
  SlicedEntry<P, SP::K> table[PTS][LADDER_TABLE];
  typename SP::Slots slots[CHAINS];
};

// xs, ys, inf, sc, out as ladder_kernel's, and the same function, for F =
// fp^K.  Chain q = (point q / K, chunk q % K) runs on the G consecutive
// threads G q .. G q + G - 1 (SlicedPoint): a block of T threads runs
// T / G chains, PTS = T / (G K) points (or one point's T / G chunks).  The
// block builds each point's table of 2^w multiples in shared memory by
// ladder_kernel's recipe and levels (table_depth), an entry of a level on
// a group, each lane writing its coefficients; then each chain runs its
// windows, every lane of the group reading the same digit (the table
// lookup is the group's) and only its coefficients of T[digit].  A
// coefficient's first copy stores its limbs of X, Y and Z.  What bounds it
// is the products (65,536 chains of 12 doublings and 3 additions at 4,096
// points, 153 M base products with the tables), so the lanes stay busy:
// at G = 4 a lane holds one coefficient and computes its column of every
// product of a level (at G = 8, two lanes a coefficient, each half of the
// products, it was 1.7x slower on an H100).  A group's slots are 2.9 KB;
// at 128 threads and G = 4 shared memory holds 2 blocks an SM.
template <class Curve, int G, int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    ladder_sliced_kernel(const int64_t* xs, const int64_t* ys,
                         const uint8_t* inf, const int64_t* sc, int64_t* out,
                         int n, int Ls) {
  using SP = SlicedPoint<Curve, G>;
  using Sh = LadderShared<Curve, G, THREADS>;
  using P = typename SP::P;
  using B = typename SP::B;
  constexpr int K = LADDER_CHUNKS, w = LADDER_WINDOW, D = SP::K;
  constexpr int KPL = SP::KPL, L = Fp<P>::L16;
  static_assert(G <= 16 && 32 % G == 0, "a group lies inside one warp");
  Sh& sh = sliced_shared<Sh>();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % G;
  const int chains = nt / G, pts = chains >= K ? chains / K : 1;
  const long q0 = (long)blockIdx.x * chains, i0 = q0 / K;
  const SP sp{sh.slots[tid / G], sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  // b3's columns; T[0] = (0 : 1 : 0) and T[1] = (x : y : 1), or the
  // identity, a thread a (point, coefficient)
  for (int m = tid; m < D; m += nt) slot_put(sh.kb3[m], SP::b3_column(m));
  for (int o = tid; o < pts * D; o += nt) {
    const int k = o / D, m = o % D;
    const long i = i0 + k;
    const B zero = fp_zero<P>(), lead = m == 0 ? fp_one<P>() : zero;
    B x = zero, y = lead, z = zero;
    if (i < n && !inf[i]) {
      x = load<P>(xs + (long)m * L * n + i, n);
      y = load<P>(ys + (long)m * L * n + i, n);
      z = lead;
    }
    SlicedEntry<P, D>* T = sh.table[k];
    slot_put(T[0][0][m], zero);
    slot_put(T[0][1][m], lead);
    slot_put(T[0][2][m], zero);
    slot_put(T[1][0][m], x);
    slot_put(T[1][1][m], y);
    slot_put(T[1][2][m], z);
  }
  __syncthreads();
  auto get = [&](const SlicedEntry<P, D>& e, B* X, B* Y, B* Z) {
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      X[t] = slot_get(e[0][sp.coef(t)]);
      Y[t] = slot_get(e[1][sp.coef(t)]);
      Z[t] = slot_get(e[2][sp.coef(t)]);
    }
  };
  B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
  for (int lev = 1, top = table_depth(LADDER_TABLE - 1); lev <= top; ++lev) {
    for (int o = tid / G; o < pts * LADDER_TABLE; o += chains) {
      const int e = o % LADDER_TABLE;
      if (e < 2 || table_depth(e) != lev) continue;  // the whole group
      SlicedEntry<P, D>* T = sh.table[o / LADDER_TABLE];
      get(T[(e & 1) ? e - 1 : e >> 1], X, Y, Z);
      if (e & 1) {
        get(T[1], X2, Y2, Z2);
        sp.padd(X, Y, Z, X2, Y2, Z2);
      } else {
        sp.pdbl(X, Y, Z);
      }
      if (sp.half == 0)
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          slot_put(T[e][0][sp.coef(t)], X[t]);
          slot_put(T[e][1][sp.coef(t)], Y[t]);
          slot_put(T[e][2][sp.coef(t)], Z[t]);
        }
    }
    __syncthreads();
  }
  const long q = q0 + tid / G;
  if (q >= (long)n * K) return;  // the whole group
  const long i = q / K;
  const int j = (int)(q % K);
  const SlicedEntry<P, D>* T = sh.table[i - i0];
  const int Bc = 16 * Ls / K, nwin = (Bc + w - 1) / w, top = (nwin - 1) * w;
  const int lo = j * Bc;
  get(T[scalar_bits(sc, n, i, lo + top, Bc - top)], X, Y, Z);
  for (int m = nwin - 2; m >= 0; --m) {
    for (int d = 0; d < w; ++d) sp.pdbl(X, Y, Z);
    get(T[scalar_bits(sc, n, i, lo + m * w, w)], X2, Y2, Z2);
    sp.padd(X, Y, Z, X2, Y2, Z2);
  }
  store_sliced(sp, out + (long)j * n + i, (long)K * n, X, Y, Z);
}

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

// pts, out, scratch as reduce_kernel's, and the same function, for F =
// fp^K: the same complete additions on the same operands in the same
// order.  Chunk j runs on a cluster of CLUSTER blocks (one block where
// CLUSTER = 1) whose groups of G lanes (SlicedPoint) hold its
// REDUCE_LANES accumulators s[t] in scratch by coefficient, accumulator t
// on group t (t, t + groups, ... where the cluster has fewer groups):
// each lane reads its coefficients of s[t] and of point t + 256 (r + 1)
// straight from pts, the group adds them and writes s[t] back.  The
// halving tree's level h then adds s[t + h] to s[t] for t < h: a cluster
// barrier before a level whose entries lie on other blocks, and once they
// all lie on rank 0's block (2h <= its groups) the other blocks leave and
// __syncthreads orders the rest.  What bounds it is the latency of its 23
// dependent additions at 4,096 points (15 strided, 8 tree levels), each
// two levels of products and the b3 level: the template kernel ran them
// on one thread a lane, a whole fp4 point and 16 base products a product
// there (255 registers, spills on an H100).  Launch bounds of one block
// an SM: left to itself ptxas capped it at 128 registers and spilled.
template <class Curve, int G, int THREADS, int CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
    reduce_sliced_kernel(const int64_t* pts, int64_t* out,
                         Point<typename Curve::F>* scratch, int n, int K) {
  using SP = SlicedPoint<Curve, G>;
  using Sh = GroupsShared<Curve, G, THREADS>;
  using B = typename SP::B;
  constexpr int KPL = SP::KPL, A = THREADS / G;  // groups a block
  static_assert(G <= 16 && 32 % G == 0 && THREADS % G == 0,
                "a group lies inside one warp");
  const int j = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;
  const int tid = threadIdx.x, lane = tid % G;
  const int groups = CLUSTER * A, group = rank * A + tid / G;
  Sh& sh = sliced_shared<Sh, CLUSTER>(rank);
  for (int m = tid; m < SP::K; m += blockDim.x)
    slot_put(sh.kb3[m], SP::b3_column(m));
  __syncthreads();
  const SP sp{sh.slots[tid / G], sh.kb3, lane % SP::SPAN, lane / SP::SPAN,
              GroupSync{((1u << G) - 1u) << (tid % 32 / G * G)}};
  const long stride = (long)K * n;
  const int64_t* col = pts + (long)j * n;
  typename SP::Pt* s = scratch + (long)j * REDUCE_LANES;
  B X[KPL], Y[KPL], Z[KPL], X2[KPL], Y2[KPL], Z2[KPL];
  // accumulator t starts at point t (the identity past n)
  for (int t = group; t < REDUCE_LANES; t += groups) {
    if (t < n)
      load_sliced(sp, col + t, stride, X, Y, Z);
    else
      sp.identity(X, Y, Z);
    sp.put(s[t], X, Y, Z);
  }
  // round r < M - 1 adds point t + 256 (r + 1) to accumulator t (its
  // group alone reads and writes it: a group sync orders the copies'
  // reads after the first copy's write); then the tree's level h = 128 >>
  // (r - M + 1) adds s[t + h] to s[t] for t < h.  One addition in the
  // code, so one inlined padd.
  constexpr int LEVELS = 8;  // of the tree
  static_assert(1 << LEVELS == REDUCE_LANES, "a tree over the lanes");
  const int M = n > REDUCE_LANES ? (n + REDUCE_LANES - 1) / REDUCE_LANES : 1;
  for (int r = 0; r < M - 1 + LEVELS; ++r) {
    const bool tree = r >= M - 1;
    const int h = tree ? REDUCE_LANES / 2 >> (r - M + 1) : 0;
    if (!tree) {
      sp.sync();
    } else if (2 * h > A) {  // level h reads s[0, 2h): groups 0 .. 2h - 1
      wsum_sync<CLUSTER>();
    } else {
      if (rank) return;
      __syncthreads();
    }
    for (int t = group; t < (tree ? h : REDUCE_LANES); t += groups) {
      sp.get(s[t], X, Y, Z);
      const long i = t + (long)REDUCE_LANES * (r + 1);
      if (tree)
        sp.get(s[t + h], X2, Y2, Z2);
      else if (i < n)
        load_sliced(sp, col + i, stride, X2, Y2, Z2);
      else
        sp.identity(X2, Y2, Z2);
      sp.padd(X, Y, Z, X2, Y2, Z2);
      if (h != 1)
        sp.put(s[t], X, Y, Z);
      else
        store_sliced(sp, out + j, K, X, Y, Z);
    }
  }
}

// ---- C launchers: launch on the given stream, return cudaGetLastError() --

#ifdef __CUDACC__

template <class Curve, int G, int THREADS, int BLOCKS>
int launch_leaf_sliced(const void* sx, const void* sy, void* rows, int nw,
                       int C, int R, void* stream) {
  const long threads = (long)nw * R * G;
  leaf_sliced_kernel<Curve, G, THREADS, BLOCKS>
      <<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0,
         (cudaStream_t)stream>>>((const int64_t*)sx, (const int64_t*)sy,
                                 (int64_t*)rows, nw, C, R);
  return (int)cudaGetLastError();
}

// The leaf of a curve at group width G: leaf_sliced_kernel over fp^K (in
// the curve's LEAF_THREADS and LEAF_BLOCKS), leaf_prefix_kernel otherwise.
template <class Curve, int G>
int launch_leaf_prefix(const void* sx, const void* sy, void* rows, int nw,
                       int C, int R, void* stream) {
  if constexpr (FpKTraits<typename Curve::F>::SLICED) {
    return launch_leaf_sliced<Curve, G, Curve::LEAF_THREADS,
                              Curve::LEAF_BLOCKS>(sx, sy, rows, nw, C, R,
                                                  stream);
  } else {
    constexpr int block = LeafBlock<typename Curve::F, G>::THREADS;
    const long threads = (long)nw * R * G;
    leaf_prefix_kernel<Curve, G><<<(unsigned)((threads + block - 1) / block),
                                   block, 0, (cudaStream_t)stream>>>(
        (const int64_t*)sx, (const int64_t*)sy, (int64_t*)rows, nw, C, R);
    return (int)cudaGetLastError();
  }
}

// A kernel that runs a window (or a chunk) on a cluster of CLUSTER blocks
// of THREADS threads (nw clusters), with SHARED bytes of dynamic shared
// memory a block.  Above 48 KB a block needs the dynamic shared memory
// attribute, which the kernel keeps once set; the cluster is a launch
// attribute.
template <int SHARED, int THREADS, int CLUSTER, class... KArgs, class... Args>
int launch_clusters(void (*kern)(KArgs...), int nw, void* stream,
                    Args... args) {
  constexpr int shared = SHARED;
  static_assert(shared <= 227 * 1024, "the slots pass a block's shared memory");
  static_assert(CLUSTER >= 1 && CLUSTER <= 8, "a portable cluster");
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
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, args...);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// The same, the FoldShared slots of its groups of G threads in the block's
// dynamic shared memory.
template <class F, int G, int THREADS, int CLUSTER, class... KArgs,
          class... Args>
int launch_cluster(void (*kern)(KArgs...), int nw, void* stream,
                   Args... args) {
  return launch_clusters<THREADS / G * (int)sizeof(FoldShared<F>), THREADS,
                         CLUSTER>(kern, nw, stream, args...);
}

template <class Curve, int G, int THREADS, int CLUSTER>
int launch_weighted_sum_sliced(const void* bk, void* out, void* scratch,
                               int nw, int nb, void* stream) {
  return launch_clusters<(int)sizeof(GroupsShared<Curve, G, THREADS>),
                         THREADS, CLUSTER>(
      weighted_sum_sliced_kernel<Curve, G, THREADS, CLUSTER>, nw, stream,
      (const int64_t*)bk, (int64_t*)out, (Point<typename Curve::F>*)scratch,
      nw, nb);
}

// A curve's weighted sum at group width G: weighted_sum_sliced_kernel over
// fp^K, weighted_sum_kernel otherwise.
template <class Curve, int G, int THREADS, int CLUSTER>
int launch_weighted_sum(const void* bk, void* out, void* scratch, int nw,
                        int nb, void* stream) {
  if constexpr (FpKTraits<typename Curve::F>::SLICED)
    return launch_weighted_sum_sliced<Curve, G, THREADS, CLUSTER>(
        bk, out, scratch, nw, nb, stream);
  else
    return launch_cluster<typename Curve::F, G, THREADS, CLUSTER>(
        weighted_sum_kernel<Curve, G, THREADS, CLUSTER>, nw, stream,
        (const int64_t*)bk, (int64_t*)out, (Point<typename Curve::F>*)scratch,
        nw, nb);
}

// The per-chunk reduction over fp^K: a cluster of CLUSTER blocks a chunk.
template <class Curve, int G, int THREADS, int CLUSTER>
int launch_reduce_sliced(const void* pts, void* out, void* scratch, int n,
                         int K, void* stream) {
  return launch_clusters<(int)sizeof(GroupsShared<Curve, G, THREADS>),
                         THREADS, CLUSTER>(
      reduce_sliced_kernel<Curve, G, THREADS, CLUSTER>, K, stream,
      (const int64_t*)pts, (int64_t*)out, (Point<typename Curve::F>*)scratch,
      n, K);
}

// A curve's reduction: reduce_sliced_kernel over fp^K (at its
// LadderShape), reduce_kernel otherwise.
template <class Curve>
int launch_reduce(const void* pts, void* out, void* scratch, int n, int K,
                  void* stream) {
  if constexpr (FpKTraits<typename Curve::F>::SLICED) {
    using LS = LadderShape<Curve>;
    return launch_reduce_sliced<Curve, LS::REDUCE_GROUP, LS::REDUCE_THREADS,
                                LS::REDUCE_CLUSTER>(pts, out, scratch, n, K,
                                                    stream);
  } else {
    reduce_kernel<Curve><<<K, REDUCE_LANES, 0, (cudaStream_t)stream>>>(
        (const int64_t*)pts, (int64_t*)out,
        (Point<typename Curve::F>*)scratch, n, K);
    return (int)cudaGetLastError();
  }
}

template <class Curve, int G, int THREADS, int CLUSTER>
int launch_lane_offsets_sliced(const void* tot, void* out, void* scratch,
                               int nw, int R, void* stream) {
  return launch_clusters<(int)sizeof(GroupsShared<Curve, G, THREADS>),
                         THREADS, CLUSTER>(
      lane_offsets_sliced_kernel<Curve, G, THREADS, CLUSTER>, nw, stream,
      (const int64_t*)tot, (int64_t*)out, (Point<typename Curve::F>*)scratch,
      nw, R);
}

// A curve's lane offsets at group width G: lane_offsets_sliced_kernel over
// fp^K, lane_offsets_kernel otherwise.
template <class Curve, int G, int THREADS, int CLUSTER>
int launch_lane_offsets(const void* tot, void* out, void* scratch, int nw,
                        int R, void* stream) {
  if constexpr (FpKTraits<typename Curve::F>::SLICED)
    return launch_lane_offsets_sliced<Curve, G, THREADS, CLUSTER>(
        tot, out, scratch, nw, R, stream);
  else
    return launch_cluster<typename Curve::F, G, THREADS, CLUSTER>(
        lane_offsets_kernel<Curve, G, THREADS, CLUSTER>, nw, stream,
        (const int64_t*)tot, (int64_t*)out,
        (Point<typename Curve::F>*)scratch, nw, R);
}

template <class Curve, int G, int THREADS, int BLOCKS>
int launch_ladder_sliced(const void* xs, const void* ys, const void* inf,
                         const void* sc, void* out, int n, int Ls,
                         void* stream) {
  constexpr int shared = (int)sizeof(LadderShared<Curve, G, THREADS>);
  static_assert(shared <= 227 * 1024, "the block passes its shared memory");
  auto kern = ladder_sliced_kernel<Curve, G, THREADS, BLOCKS>;
  if (shared > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long chains = (long)n * LADDER_CHUNKS;
  constexpr int per = THREADS / G;
  kern<<<(unsigned)((chains + per - 1) / per), THREADS, shared,
         (cudaStream_t)stream>>>((const int64_t*)xs, (const int64_t*)ys,
                                 (const uint8_t*)inf, (const int64_t*)sc,
                                 (int64_t*)out, n, Ls);
  return (int)cudaGetLastError();
}

template <class Curve, int G>
int launch_horner_fold_sliced(const void* S, void* out, int nw, int c,
                              void* stream) {
  horner_fold_sliced_kernel<Curve, G><<<1, G, 0, (cudaStream_t)stream>>>(
      (const int64_t*)S, (int64_t*)out, nw, c);
  return (int)cudaGetLastError();
}

// A curve's ladder and Horner fold: the sliced kernels over fp^K (at its
// LadderShape), ladder_kernel and horner_fold_kernel otherwise.
template <class Curve>
int launch_ladder(const void* xs, const void* ys, const void* inf,
                  const void* sc, void* out, int n, int Ls, void* stream) {
  if constexpr (FpKTraits<typename Curve::F>::SLICED) {
    using LS = LadderShape<Curve>;
    return launch_ladder_sliced<Curve, LS::GROUP, LS::THREADS, LS::BLOCKS>(
        xs, ys, inf, sc, out, n, Ls, stream);
  } else {
    ladder_kernel<Curve><<<(n + Curve::LADDER_POINTS - 1) /
                               Curve::LADDER_POINTS,
                           ladder_threads<Curve>(), 0, (cudaStream_t)stream>>>(
        (const int64_t*)xs, (const int64_t*)ys, (const uint8_t*)inf,
        (const int64_t*)sc, (int64_t*)out, n, Ls);
    return (int)cudaGetLastError();
  }
}

template <class Curve>
int launch_horner_fold(const void* S, void* out, int nw, int c,
                       void* stream) {
  if constexpr (FpKTraits<typename Curve::F>::SLICED) {
    return launch_horner_fold_sliced<Curve, Curve::FOLD_GROUP>(S, out, nw, c,
                                                               stream);
  } else {
    horner_fold_kernel<Curve><<<1, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)S, (int64_t*)out, nw, c);
    return (int)cudaGetLastError();
  }
}

// The bucket step of a curve at group width G in blocks of THREADS:
// buckets_sliced_kernel over fp^K, buckets_kernel otherwise; a block a run
// of RUN buckets of one window, its shared memory dynamic (G2's above 48
// KB).
template <class Curve, int G, int THREADS>
int launch_buckets(const void* rows, const void* offs, const void* d_sorted,
                   void* out, int nw, int C, int R, int nb, void* stream) {
  using F = typename Curve::F;
  constexpr int RUN = buckets_run(THREADS / G);
  const int blocks = nw * ((nb + RUN - 1) / RUN);
  const auto* r = (const int64_t*)rows;
  const auto* o = (const int64_t*)offs;
  const auto* d = (const int64_t*)d_sorted;
  if constexpr (FpKTraits<F>::SLICED)
    return launch_clusters<(int)sizeof(BucketsSlicedShared<Curve, G, THREADS>),
                           THREADS, 1>(
        buckets_sliced_kernel<Curve, G, THREADS>, blocks, stream, r, o, d,
        (int64_t*)out, nw, C, R, nb);
  else
    return launch_clusters<
        (int)sizeof(BucketsBlock<FoldShared<F>, Point<F>, THREADS / G>),
        THREADS, 1>(buckets_kernel<Curve, G, THREADS>, blocks, stream, r, o,
                    d, (int64_t*)out, nw, C, R, nb);
}

// The fixed-base scan of a curve on the leaf's groups and blocks (LEAF_GROUP
// threads a column, leaf_threads a block; over fp^K LEAF_BLOCKS an SM):
// fixed_base_sliced_kernel over fp^K, fixed_base_kernel otherwise.
template <class Curve>
int launch_fixed_base(const void* sc, const void* table, void* out, int n,
                      int Ls, int c, int nwin, void* stream) {
  constexpr int G = Curve::LEAF_GROUP, block = leaf_threads<Curve>();
  const unsigned blocks = (unsigned)(((long)n * G + block - 1) / block);
  const auto* s = (const int64_t*)sc;
  const auto* t = (const uint32_t*)table;
  auto* o = (int64_t*)out;
  if constexpr (FpKTraits<typename Curve::F>::SLICED)
    fixed_base_sliced_kernel<Curve, G, block, Curve::LEAF_BLOCKS>
        <<<blocks, block, 0, (cudaStream_t)stream>>>(s, t, o, n, Ls, c, nwin);
  else
    fixed_base_kernel<Curve, G><<<blocks, block, 0, (cudaStream_t)stream>>>(
        s, t, o, n, Ls, c, nwin);
  return (int)cudaGetLastError();
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
    return launch_lane_offsets<CURVE, CURVE::LANES_GROUP,                     \
                               CURVE::LANES_THREADS, CURVE::LANES_CLUSTER>(   \
        tot, out, scratch, nw, R, stream);                                    \
  }                                                                           \
  extern "C" int gnark_msm_weighted_sum_##NAME(                               \
      const void* bk, void* out, void* scratch, int nw, int nb,               \
      void* stream) {                                                         \
    return launch_weighted_sum<CURVE, CURVE::WSUM_GROUP, CURVE::WSUM_THREADS, \
                               CURVE::WSUM_CLUSTER>(bk, out, scratch, nw, nb, \
                                                    stream);                  \
  }                                                                           \
  extern "C" int gnark_msm_buckets_##NAME(                                    \
      const void* rows, const void* offs, const void* d_sorted, void* out,    \
      int nw, int C, int R, int nb, void* stream) {                           \
    return launch_buckets<CURVE, CURVE::BUCKETS_GROUP,                        \
                          CURVE::BUCKETS_THREADS>(rows, offs, d_sorted, out,  \
                                                  nw, C, R, nb, stream);      \
  }                                                                           \
  extern "C" int gnark_msm_horner_fold_##NAME(                                \
      const void* S, void* out, int nw, int c, void* stream) {                \
    return launch_horner_fold<CURVE>(S, out, nw, c, stream);                  \
  }                                                                           \
  extern "C" int gnark_msm_ladder_##NAME(                                    \
      const void* xs, const void* ys, const void* inf, const void* sc,        \
      void* out, int n, int Ls, void* stream) {                               \
    return launch_ladder<CURVE>(xs, ys, inf, sc, out, n, Ls, stream);         \
  }                                                                           \
  extern "C" int gnark_msm_reduce_##NAME(const void* pts, void* out,          \
                                         void* scratch, int n, int K,         \
                                         void* stream) {                      \
    return launch_reduce<CURVE>(pts, out, scratch, n, K, stream);             \
  }                                                                           \
  extern "C" int gnark_msm_fixed_base_##NAME(                                 \
      const void* sc, const void* table, void* out, int n, int Ls, int c,     \
      int nwin, void* stream) {                                               \
    return launch_fixed_base<CURVE>(sc, table, out, n, Ls, c, nwin, stream);  \
  }                                                                           \
  GNARK_MSM_SHAPE(NAME, CURVE)

#ifndef GNARK_MSM_BLS24315
GNARK_MSM_LAUNCHERS(g1, G1)
GNARK_MSM_LAUNCHERS(g2, G2)
#endif

#endif  // __CUDACC__
