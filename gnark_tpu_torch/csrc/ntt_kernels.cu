// The Groth16 quotient's device code over the six scalar fields: one
// radix-2 NTT butterfly stage, and the quotient's pointwise step, built
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (gnark_tpu_torch/ops/_cuda.py).  Each kernel
// computes what its plain PyTorch version computes (ops/ntt.py:
// Domain.transform_plain, fr_pointwise_plain) on the same int64 tensors
// of 16-bit limb planes; every field operation ends canonical, so the
// limbs agree bit for bit.
//
// Kernel              replaces (XLA device code, jitted whole)
//   ntt_stage         Domain._transform, gnark_tpu/ops/ntt.py:134 (one
//                     of its log2 n stages a launch, all of a transform's
//                     launches from one call, ntt_stages; the coset
//                     pre-scale fused into the first, the n^-1 /
//                     inverse-coset post-scale into the last)
//   fr_pointwise      _compute_h's (a b - c) d, gnark_tpu/backend/
//                     groth16.py:543
//
// What bounds them on the H100: memory.  A stage reads and writes each
// element once (L 16-bit planes of int64, 8 bytes a 16-bit limb: 128 bytes
// an element at L = 16) and does one product a butterfly, 136 32-bit
// multiplies at N = 8: about 0.5 multiply a byte against the card's
// 1.673e13 / 3.35e12 = 5 issue slots a byte.  So the design is the
// simplest that streams: one thread a butterfly, threads along the minor
// (element) axis so that each plane's loads coalesce, the 16-bit planes
// 2i and 2i + 1 paired into 32-bit word i in registers (field.cuh's load
// and store).  The first stage reads the input and writes the output; the
// later stages run in place on the output (a butterfly reads and writes
// only its own two elements), so a transform needs one [L, n] buffer, as
// the plain version does.  Running the stages whose span fits a block
// in one shared-memory launch would cut the passes from log2 n to a few;
// that is later work.
//
// Kinds: fr_bn254, fr_bls12_381, fr_bls12_377, fr_bls24_315 (N = 8, the
// PTX carry chains), fr_bw6_761 (BLS12-377's fp, N = 12) and fr_bw6_633
// (BLS24-315's fp, N = 10), the last two in field.cuh's portable form.
//
// Without __CUDACC__ the kernels and ntt_stages compile as host C++ (the
// launchers drop out): a harness that defines blockIdx, threadIdx,
// blockDim, gridDim and __global__ runs a launch as one thread (every
// kernel loops over its work with a grid stride) and a transform through
// the same ntt_stages as the card's.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

// One radix-2 stage s of an n-point transform over [L, n] planes x -> y
// (y may be x): butterfly g of the n / 2 pairs takes a = x[i], b =
// x[i + half] with half = n >> (s + 1), i = (g / half) 2 half + g % half,
// and twiddle w = tw[(g % half) 2^s] (tw: [L, n / 2], plane stride
// tw_stride); DIF gives u = a + b, v = (a - b) w, DIT bw = b w, u = a +
// bw, v = a - bw.  pre ([L, n]), where given, multiplies a and b first;
// post, where given, multiplies u and v (its plane stride post_stride,
// its column step post_step: 0 for one broadcast value).  At n = 1 there
// is no butterfly: the one element is scaled by pre and post.
template <class P, bool DIT>
__global__ void ntt_stage_kernel(const int64_t* x, int64_t* y,
                                 const int64_t* tw, long tw_stride,
                                 const int64_t* pre, const int64_t* post,
                                 long post_stride, int post_step, long n,
                                 int s) {
  const long pairs = n > 1 ? n / 2 : 1;
  const long half = n >> (s + 1);
  for (long g = (long)blockIdx.x * blockDim.x + threadIdx.x; g < pairs;
       g += (long)gridDim.x * blockDim.x) {
    if (n == 1) {
      Fp<P> v = load<P>(x, n);
      if (pre) v = mul(v, load<P>(pre, n));
      if (post) v = mul(v, load<P>(post, post_stride));
      store(v, y, n);
      continue;
    }
    const long t = g & (half - 1);      // half is a power of two
    const long ia = (g - t) * 2 + t, ib = ia + half;
    Fp<P> a = load<P>(x + ia, n), b = load<P>(x + ib, n);
    if (pre) {
      a = mul(a, load<P>(pre + ia, n));
      b = mul(b, load<P>(pre + ib, n));
    }
    const Fp<P> w = load<P>(tw + (t << s), tw_stride);
    Fp<P> u, v;
    if constexpr (DIT) {
      const Fp<P> bw = mul(b, w);
      u = add(a, bw);
      v = sub(a, bw);
    } else {
      u = add(a, b);
      v = mul(sub(a, b), w);
    }
    if (post) {
      u = mul(u, load<P>(post + ia * post_step, post_stride));
      v = mul(v, load<P>(post + ib * post_step, post_stride));
    }
    store(u, y + ia, n);
    store(v, y + ib, n);
  }
}

// The stages of one n-point transform over [L, n] planes x -> y, in the
// plain version's order (DIF s = 0 .. k - 1, DIT k - 1 .. 0, k = log2 n;
// one with s = 0 at n = 1): stage(src, pre, post, s) runs stage s, the
// first from x, the rest in place on y (a butterfly reads and writes only
// its own two elements); pre goes to the first, post to the last.
// Returns the number of stages run, or -e for the first stage that
// returned e != 0.
template <class Stage>
int ntt_stages(const int64_t* x, int64_t* y, const int64_t* pre,
               const int64_t* post, long n, int dit, Stage stage) {
  int k = 0;
  while ((1L << k) < n) ++k;
  const int count = k > 0 ? k : 1;
  for (int i = 0; i < count; ++i) {
    const int s = k == 0 ? 0 : dit ? k - 1 - i : i;
    const int e = stage(i == 0 ? x : y, i == 0 ? pre : nullptr,
                        i == count - 1 ? post : nullptr, s);
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
constexpr int NTT_THREADS = 256;

static unsigned ntt_blocks(long work) {
  return (unsigned)((work + NTT_THREADS - 1) / NTT_THREADS);
}

// One transform: its log2 n stage launches (one at n = 1) on ``stream``;
// returns their number, or -cudaError.
template <class P, bool DIT>
static int launch_ntt(const int64_t* x, int64_t* y, const int64_t* tw,
                      long tw_stride, const int64_t* pre,
                      const int64_t* post, long post_stride, int post_step,
                      long n, cudaStream_t stream) {
  const unsigned blocks = ntt_blocks(n > 1 ? n / 2 : 1);
  return ntt_stages(x, y, pre, post, n, DIT,
                    [&](const int64_t* src, const int64_t* pr,
                        const int64_t* po, int s) {
                      ntt_stage_kernel<P, DIT>
                          <<<blocks, NTT_THREADS, 0, stream>>>(
                              src, y, tw, tw_stride, pr, po, post_stride,
                              post_step, n, s);
                      return (int)cudaGetLastError();
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
      const void* pre, const void* post, long post_stride, int post_step,     \
      long n, int dit, void* stream) {                                        \
    const int64_t *xi = (const int64_t*)x, *twi = (const int64_t*)tw,         \
                  *prei = (const int64_t*)pre, *posti = (const int64_t*)post; \
    return dit ? launch_ntt<FIELD, true>(xi, (int64_t*)y, twi, tw_stride,     \
                                         prei, posti, post_stride, post_step, \
                                         n, (cudaStream_t)stream)             \
               : launch_ntt<FIELD, false>(xi, (int64_t*)y, twi, tw_stride,    \
                                          prei, posti, post_stride,           \
                                          post_step, n, (cudaStream_t)stream);\
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
