// The Groth16 quotient's device code over the six scalar fields: the NTT
// as passes over shared-memory tiles, and the quotient's pointwise step,
// built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (gnark_tpu_torch/ops/_cuda.py).  Each kernel
// computes what its plain PyTorch version computes (ops/ntt.py:
// Domain.transform_plain, fr_pointwise_plain) on the same int64 tensors
// of 16-bit limb planes; every field operation ends canonical, so the
// limbs agree bit for bit.
//
// Kernel              replaces (XLA device code, jitted whole)
//   ntt_pass          Domain._transform, gnark_tpu/ops/ntt.py:134 (a
//                     transform in one pass where n fits a tile, else in
//                     a few, all launched from one call, ntt_passes; the
//                     coset pre-scale on the first pass's load, the n^-1
//                     / inverse-coset post-scale on the last pass's store)
//   fr_pointwise      _compute_h's (a b - c) d, gnark_tpu/backend/
//                     groth16.py:543
//
// What bounds them on the H100: memory and launches.  An element is L
// 16-bit planes of int64 (128 bytes at L = 16), and a radix-2 stage does
// one product a butterfly, about 0.5 multiply a byte that it moves
// against the card's 1.673e13 / 3.35e12 = 5 issue slots a byte.  So one
// stage a launch streams the whole array log2 n times.  A pass instead
// loads a tile of 2^(m + c) elements into shared memory (the 16-bit
// planes 2i and 2i + 1 paired into 32-bit word i on the load, one array
// a word, so consecutive threads hit consecutive banks), runs m stages
// there, a __syncthreads() between two, and writes the tile back: a
// contiguous pass takes the last (DIF) stages on 2^m consecutive
// elements, a strided pass the first ones on 2^m rows, 2^lo elements
// apart, of 2^c >= 4 adjacent columns (each plane row of the tile whole
// 32-byte sectors).  At tiles of 2^11 (N = 8) every transform to 2^20 is
// two passes (9 + 11 stages); a smaller one takes the smallest tile that
// needs no more passes, so that its tiles spread over more SMs
// (ntt_tile_log).  The butterflies are the plain version's:
// the same pairs, the same twiddle for each pair, each element's stages
// in the same order.
//
// Twiddles.  Stage s's butterfly at a, a + n / 2^(s+1) takes tw[(a mod
// n / 2^(s+1)) 2^s].  In a contiguous pass that is RT[t 2^ls] (ls = s -
// s0, t the pair's offset in its group) with RT[i] = tw[i 2^(k - m)], i <
// 2^(m - 1): the same half tile of roots for every tile, loaded once a
// block.  In a strided pass it is tw[(r 2^lo + j) 2^s] = RT[r 2^ls] tw[j
// 2^s] (r the row in its group, j the column), so each stage's 2^(m - 1
// - ls) x 2^c twiddles are made from the resident RT and the tile's 2^c
// column roots, one product each, before its butterflies (about one
// product for every m / 2 butterflies).  Both products of roots give the
// canonical tw entry, so the kernel reads about 2^(tlog - 1) + m 2^lo
// table entries instead of the whole [L, n / 2] table.
//
// Shared memory: the tile, the twiddle buffer (2^(tlog - 1)) and a
// strided pass's RT (2^(tlog - 3)), N words an element, one spare word
// every 32 (ntt_pad: the stride-2^ls twiddle reads and the stride-2
// butterflies of the last stages spread over the banks): 110 KB at N = 8
// and 2^11 (two blocks an SM), 69 / 82 KB at N = 10 / 12 and 2^10; less
// at the smaller tiles of smaller transforms.
//
// Kinds: fr_bn254, fr_bls12_381, fr_bls12_377, fr_bls24_315 (N = 8, the
// PTX carry chains), fr_bw6_761 (BLS12-377's fp, N = 12) and fr_bw6_633
// (BLS24-315's fp, N = 10), the last two in field.cuh's portable form.
//
// The plan (ntt_plan: the tile, and each pass's stages and columns) is
// the library's alone: gnark_ntt_plan_<kind> gives it, with each pass's
// shared memory and CUDA's blocks an SM, to Python (ops/_cuda.ntt_plan).
//
// Without __CUDACC__ the pass body ntt_pass, ntt_plan, ntt_passes and
// the pointwise kernel compile as host C++ (the launchers drop out): a
// harness that defines blockIdx, threadIdx, blockDim, gridDim,
// __syncthreads and __global__ runs a launch as threads (every loop
// strides over the block's threads and the grid's blocks, so one thread
// runs every butterfly in turn) with a buffer of ntt_smem_words words as
// its shared memory, and a transform through the same ntt_passes as the
// card's, at any largest tile (tmax >= 3).

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#endif

#include "field.cuh"

// One spare word every 32 words of a shared-memory array.
GT_HD int ntt_pad(int i) { return i + (i >> 5); }

// The shared 32-bit words of a pass at tiles of 2^tlog: the tile, the
// twiddle buffer and a strided pass's RT, N words an element, padded.
template <class P>
GT_HD long ntt_smem_words(int tlog) {
  const int T = 1 << tlog;
  return (long)P::N * (ntt_pad(T) + ntt_pad(T / 2) + ntt_pad(T / 8));
}

template <class P>
GT_HD void sm_put(uint32_t* s, int stride, int i, const Fp<P>& v) {
#pragma unroll
  for (int w = 0; w < P::N; ++w) s[w * stride + i] = v.v[w];
}

template <class P>
GT_HD Fp<P> sm_get(const uint32_t* s, int stride, int i) {
  Fp<P> v;
#pragma unroll
  for (int w = 0; w < P::N; ++w) v.v[w] = s[w * stride + i];
  return v;
}

// One pass of an n = 2^k point transform over [L, n] planes x -> y (y
// may be x): stages s0 .. s0 + m - 1 (DIF in that order, DIT in reverse)
// of every tile, tile by tile with a grid stride.  A tile is 2^m rows of
// 2^c adjacent columns: element e = r 2^c + jj of tile (b, g) is global
// index b 2^(k - s0) + r 2^lo + g 2^c + jj, lo = k - s0 - m (c = 0 and
// lo = 0: 2^m consecutive elements).  pre ([L, n] plane stride
// pre_stride, column step pre_step: 0 for one broadcast value), where
// given, multiplies each element on the load; post likewise on the
// store.  tw: [L, n / 2], plane stride tw_stride.  sm: ntt_smem_words
// words laid out for tiles of 2^tlog (m + c <= tlog).
template <class P, bool DIT>
__device__ void ntt_pass(const int64_t* x, int64_t* y, const int64_t* tw,
                         long tw_stride, const int64_t* pre, long pre_stride,
                         int pre_step, const int64_t* post, long post_stride,
                         int post_step, int k, int s0, int m, int c, int tlog,
                         uint32_t* sm) {
  const long n = 1L << k;
  const int T = 1 << (m + c), C = 1 << c, lo = k - s0 - m;
  const int xs = ntt_pad(1 << tlog), ws = ntt_pad(1 << (tlog - 1)),
            rs = ntt_pad(1 << (tlog - 3));
  uint32_t *X = sm, *W = X + P::N * xs, *R = W + P::N * ws;
  // RT[i] = tw[i 2^(k - m)]: a contiguous pass reads it from W, a
  // strided one builds each stage's twiddles in W from it
  uint32_t* RT = c == 0 ? W : R;
  const int rts = c == 0 ? ws : rs;
  if (m > 0)
    for (int i = threadIdx.x; i < 1 << (m - 1); i += blockDim.x)
      sm_put(RT, rts, ntt_pad(i), load<P>(tw + ((long)i << (k - m)),
                                          tw_stride));
  __syncthreads();
  const long groups = 1L << (lo - c), tiles = n >> (m + c);
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long j0 = (tile & (groups - 1)) << c;
    const long base = ((tile >> (lo - c)) << (k - s0)) + j0;
    for (int e = threadIdx.x; e < T; e += blockDim.x) {
      const long gi = base + ((long)(e >> c) << lo) + (e & (C - 1));
      Fp<P> v = load<P>(x + gi, n);
      if (pre) v = mul(v, load<P>(pre + gi * pre_step, pre_stride));
      sm_put(X, xs, ntt_pad(e), v);
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const int ls = DIT ? m - 1 - i : i, s = s0 + ls;
      const int half = 1 << (m - 1 - ls + c);   // pair distance in e
      if (c > 0) {
        // W[r 2^c + jj] = RT[r 2^ls] tw[(j0 + jj) 2^s], r < 2^(m-1-ls);
        // row 0's are the column roots themselves (RT[0] = 1)
        for (int jj = threadIdx.x; jj < C; jj += blockDim.x)
          sm_put(W, ws, ntt_pad(jj),
                 load<P>(tw + ((j0 + jj) << s), tw_stride));
        __syncthreads();
        for (int f = C + threadIdx.x; f < half; f += blockDim.x)
          sm_put(W, ws, ntt_pad(f),
                 mul(sm_get<P>(R, rs, ntt_pad((f >> c) << ls)),
                     sm_get<P>(W, ws, ntt_pad(f & (C - 1)))));
        __syncthreads();
      }
      for (int g = threadIdx.x; g < T / 2; g += blockDim.x) {
        const int t = g & (half - 1);
        const int ia = ntt_pad((g - t) * 2 + t),
                  ib = ntt_pad((g - t) * 2 + t + half);
        const Fp<P> a = sm_get<P>(X, xs, ia), b = sm_get<P>(X, xs, ib);
        const Fp<P> w = sm_get<P>(W, ws, ntt_pad(c == 0 ? t << ls : t));
        if constexpr (DIT) {
          const Fp<P> bw = mul(b, w);
          sm_put(X, xs, ia, add(a, bw));
          sm_put(X, xs, ib, sub(a, bw));
        } else {
          sm_put(X, xs, ia, add(a, b));
          sm_put(X, xs, ib, mul(sub(a, b), w));
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < T; e += blockDim.x) {
      const long gi = base + ((long)(e >> c) << lo) + (e & (C - 1));
      Fp<P> v = sm_get<P>(X, xs, ntt_pad(e));
      if (post) v = mul(v, load<P>(post + gi * post_step, post_stride));
      store(v, y + gi, n);
    }
    __syncthreads();
  }
}

// The passes of a k-stage transform at tiles of 2^t (t >= 3).
GT_HD int ntt_pass_count(int k, int t) {
  const int rest = k > t ? k - t : 0;
  return 1 + (rest + t - 3) / (t - 2);
}

// log2 of the tiles a transform aims at: about one an SM (132 on the
// H100).
constexpr int NTT_TILES_LOG = 7;

// log2 of a field's largest tile: 2^11 elements at N = 8 words (the
// tile and its twiddles 110 KB of shared memory, two blocks an SM),
// 2^10 at 10 and 12 (69 and 82 KB).
template <class P>
constexpr int NTT_TILE_MAX = P::N == 8 ? 11 : 10;

// The tile of a k-stage transform whose largest tile is 2^tmax: the
// largest 2^t <= 2^tmax that takes no more passes and leaves 2^7 tiles,
// else the smallest that takes no more passes (2^16 runs 128 tiles of
// 2^9, not 32 of 2^11; 2^18 128 of 2^11, whose strided pass reads runs
// of 16 columns); a transform that fits one tile has a tile of its own
// size.
GT_HD int ntt_tile_log(int k, int tmax) {
  int t = 3;
  while (ntt_pass_count(k, t) > ntt_pass_count(k, tmax)) ++t;
  while (t < tmax && k - t - 1 >= NTT_TILES_LOG) ++t;
  return t;
}

// The plan of one n-point transform (k = log2 n) whose largest tile is
// 2^tmax (tmax >= 3): its tile 2^t, t = ntt_tile_log(k, tmax), and its
// passes (s0[i], m[i], c[i]) in DIF order; returns their number.  One
// pass of every stage where k <= t; else the first k - t stages in
// ceil((k - t) / (t - 2)) strided passes, as even as they go, each of m
// stages over 2^(t - m) >= 4 columns, then one contiguous pass of the
// last t.
inline int ntt_plan(long n, int tmax, int* t, int* s0, int* m, int* c) {
  int k = 0;
  while ((1L << k) < n) ++k;
  *t = ntt_tile_log(k, tmax);
  const int mc = k < *t ? k : *t, rest = k - mc;
  const int strided = ntt_pass_count(k, *t) - 1;
  int count = 0;
  for (int s = 0; count < strided; ++count) {
    m[count] = rest / strided + (count < rest % strided);
    s0[count] = s;
    c[count] = *t - m[count];
    s += m[count];
  }
  s0[count] = rest;
  m[count] = mc;
  c[count] = 0;
  return count + 1;
}

// One transform's passes in ntt_plan's order for DIF, in reverse for
// DIT; the first reads x and takes pre, the others run in place on y (a
// tile reads and writes only its own elements), the last takes post.
// pass(src, pre, post, s0, m, c, t) runs one.  Returns the number of
// passes run, or -e for the first pass that returned e != 0.
template <class Pass>
int ntt_passes(const int64_t* x, int64_t* y, const int64_t* pre,
               const int64_t* post, long n, int dit, int tmax, Pass pass) {
  int t, s0[64], m[64], c[64];
  const int count = ntt_plan(n, tmax, &t, s0, m, c);
  for (int i = 0; i < count; ++i) {
    const int p = dit ? count - 1 - i : i;
    const int e = pass(i == 0 ? x : y, i == 0 ? pre : nullptr,
                       i == count - 1 ? post : nullptr, s0[p], m[p], c[p],
                       t);
    if (e != 0) return -e;
  }
  return count;
}

// out = (a b - c) d elementwise over [L, n] planes; d's plane stride
// d_stride and column step d_step (0: one broadcast value).
template <class P>
__global__ void fr_pointwise_kernel(const int64_t* a, const int64_t* b,
                                    const int64_t* c, const int64_t* d,
                                    long d_stride, int d_step, int64_t* out,
                                    long n) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const Fp<P> ab = mul(load<P>(a + i, n), load<P>(b + i, n));
    store(mul(sub(ab, load<P>(c + i, n)), load<P>(d + i * d_step, d_stride)),
          out + i, n);
  }
}

#ifdef __CUDACC__
constexpr int NTT_THREADS = 256;       // the pointwise kernel's block
constexpr int NTT_PASS_THREADS = 256;  // a pass's block: 4 butterflies a
                                       // thread a stage at 2^11

static unsigned ntt_blocks(long work) {
  return (unsigned)((work + NTT_THREADS - 1) / NTT_THREADS);
}

template <class P, bool DIT>
__global__ void __launch_bounds__(NTT_PASS_THREADS)
    ntt_pass_kernel(const int64_t* x, int64_t* y, const int64_t* tw,
                    long tw_stride, const int64_t* pre, long pre_stride,
                    int pre_step, const int64_t* post, long post_stride,
                    int post_step, int k, int s0, int m, int c, int tlog) {
  extern __shared__ __align__(16) uint32_t ntt_smem[];
  ntt_pass<P, DIT>(x, y, tw, tw_stride, pre, pre_stride, pre_step, post,
                   post_stride, post_step, k, s0, m, c, tlog, ntt_smem);
}

// The blocks an SM of a pass kernel at tiles of 2^tlog on the current
// device, and its SMs.  On a device's first call the kernel's dynamic
// shared memory limit is raised to the field's largest tile's, once.
// The attribute and occupancy calls cost more host time than a small
// transform's launches, so each is made once; 0, or cudaError.
template <class P, bool DIT>
static int ntt_occupancy(int tlog, int* per_sm, int* sms) {
  static std::atomic<int> cache[64][NTT_TILE_MAX<P> + 1];   // device, tlog
  static std::atomic<int> sm_count[64];                     // device
  const auto kernel = ntt_pass_kernel<P, DIT>;
  int dev = 0, e;
  if ((e = cudaGetDevice(&dev))) return e;
  if (dev >= 64 || tlog < 3 || tlog > NTT_TILE_MAX<P>)
    return (int)cudaErrorInvalidValue;
  if (sm_count[dev].load() == 0) {
    int count = 0;
    if ((e = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             4 * (int)ntt_smem_words<P>(NTT_TILE_MAX<P>))) ||
        (e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                    dev)))
      return e;
    sm_count[dev].store(count);
  }
  *sms = sm_count[dev].load();
  *per_sm = cache[dev][tlog].load();
  if (*per_sm > 0) return 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, kernel, NTT_PASS_THREADS, 4 * ntt_smem_words<P>(tlog))))
    return e;
  if (*per_sm < 1) *per_sm = 1;
  cache[dev][tlog].store(*per_sm);
  return 0;
}

// One transform at the field's largest tile: its passes on ``stream``,
// each over min(tiles, resident blocks) blocks (a block keeps its RT for
// all its tiles); returns their number, or -cudaError.
template <class P, bool DIT>
static int launch_ntt(const int64_t* x, int64_t* y, const int64_t* tw,
                      long tw_stride, const int64_t* pre, long pre_stride,
                      int pre_step, const int64_t* post, long post_stride,
                      int post_step, long n, cudaStream_t stream) {
  int k = 0;
  while ((1L << k) < n) ++k;
  return ntt_passes(x, y, pre, post, n, DIT, NTT_TILE_MAX<P>,
                    [&](const int64_t* src, const int64_t* pr,
                        const int64_t* po, int s0, int m, int c, int t) {
                      int per_sm, sms;
                      const int e = ntt_occupancy<P, DIT>(t, &per_sm, &sms);
                      if (e) return e;
                      const long tiles = n >> (m + c),
                                 resident = (long)per_sm * sms;
                      ntt_pass_kernel<P, DIT>
                          <<<(unsigned)(tiles < resident ? tiles : resident),
                             NTT_PASS_THREADS, 4 * ntt_smem_words<P>(t),
                             stream>>>(src, y, tw, tw_stride, pr, pre_stride,
                                       pre_step, po, post_stride, post_step,
                                       k, s0, m, c, t);
                      return (int)cudaGetLastError();
                    });
}

// The passes that launch_ntt runs for an n-point transform, in its
// order, six ints each into out: s0, m, c, log2 of the tile, the dynamic
// shared memory of a block in bytes, and the blocks an SM that CUDA's
// occupancy allows.  Returns their number, or -cudaError.
template <class P, bool DIT>
static int ntt_plan_out(long n, int* out) {
  int i = 0;
  return ntt_passes(nullptr, nullptr, nullptr, nullptr, n, DIT,
                    NTT_TILE_MAX<P>,
                    [&](const int64_t*, const int64_t*, const int64_t*,
                        int s0, int m, int c, int t) {
                      int per_sm = 0, sms = 0;
                      const int e = ntt_occupancy<P, DIT>(t, &per_sm, &sms);
                      const int row[6] = {s0, m, c, t,
                                          4 * (int)ntt_smem_words<P>(t),
                                          per_sm};
                      for (int j = 0; j < 6 && !e; ++j) out[i++] = row[j];
                      return e;
                    });
}

// One launch of the pointwise step; returns 1, or -cudaError.
template <class P>
static int launch_fr_pointwise(const void* a, const void* b, const void* c,
                               const void* d, long d_stride, int d_step,
                               void* out, long n, void* stream) {
  fr_pointwise_kernel<P><<<ntt_blocks(n), NTT_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (const int64_t*)c,
      (const int64_t*)d, d_stride, d_step, (int64_t*)out, n);
  const int e = (int)cudaGetLastError();
  return e ? -e : 1;
}

#define GNARK_NTT_LAUNCHERS(NAME, FIELD)                                      \
  extern "C" int gnark_ntt_##NAME(                                            \
      const void* x, void* y, const void* tw, long tw_stride,                 \
      const void* pre, long pre_stride, int pre_step, const void* post,       \
      long post_stride, int post_step, long n, int dit, void* stream) {       \
    const int64_t *xi = (const int64_t*)x, *twi = (const int64_t*)tw,         \
                  *prei = (const int64_t*)pre, *posti = (const int64_t*)post; \
    return dit ? launch_ntt<FIELD, true>(                                     \
                     xi, (int64_t*)y, twi, tw_stride, prei, pre_stride,       \
                     pre_step, posti, post_stride, post_step, n,              \
                     (cudaStream_t)stream)                                    \
               : launch_ntt<FIELD, false>(                                    \
                     xi, (int64_t*)y, twi, tw_stride, prei, pre_stride,       \
                     pre_step, posti, post_stride, post_step, n,              \
                     (cudaStream_t)stream);                                   \
  }                                                                           \
  extern "C" int gnark_ntt_plan_##NAME(long n, int dit, int* out) {           \
    return dit ? ntt_plan_out<FIELD, true>(n, out)                            \
               : ntt_plan_out<FIELD, false>(n, out);                          \
  }                                                                           \
  extern "C" int gnark_fr_pointwise_##NAME(                                   \
      const void* a, const void* b, const void* c, const void* d,             \
      long d_stride, int d_step, void* out, long n, void* stream) {           \
    return launch_fr_pointwise<FIELD>(a, b, c, d, d_stride, d_step, out, n,   \
                                      stream);                                \
  }

GNARK_NTT_LAUNCHERS(fr_bn254, BN254Fr)
GNARK_NTT_LAUNCHERS(fr_bls12_381, BLS12381Fr)
GNARK_NTT_LAUNCHERS(fr_bls12_377, BLS12377Fr)
GNARK_NTT_LAUNCHERS(fr_bls24_315, BLS24315Fr)
GNARK_NTT_LAUNCHERS(fr_bw6_761, BLS12377Fp)
GNARK_NTT_LAUNCHERS(fr_bw6_633, BLS24315Fp)

#endif  // __CUDACC__
