// Integer-multiply ceiling microbenchmark for the H100, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through ctypes (gnark_tpu_torch/ops/_cuda.py).
//
// Replaces make(op) of scripts/dev_vpu_microbench.py (its pl.pallas_call),
// the TPU's vector-unit microbenchmark that the limb-arithmetic design was
// held against.  Per element, STEPS = 128 steps on each of four
// independent chains against a second operand y, then the sum of the four
// accumulators.  The four TPU ops keep their values:
//   mul_u32        a = a * y                  (mod 2^32)
//   mul16_u32      a = (a & 0xffff) * (y & 0xffff)
//   add_u32        a = a + y                  (mod 2^32)
//   fma_f32        a = fma(a, y, y)           (one rounding)
// and three more are the multiply-adds that csrc/field.cuh's Montgomery
// product compiles to:
//   mad_wide_u32   a_k = lo32(a_{k+1}) * y + a_k   (mod 2^64; mad.wide.u32;
//                  the multiplicand comes from the next chain, the last
//                  chain's from the first, so that the 64-bit addend is no
//                  function of the product and the instruction keeps it)
//   mad_lo_hi_u32  (lo, hi) = (lo * y + hi, hi32(lo * y) + lo)
//                                             (mad.lo.u32 and mad.hi.u32)
//   montmul_bn254  a = a * y * R^-1 mod p     (field.cuh's mul, 136 32-bit
//                  multiplies; each element is eight 32-bit limbs; the
//                  caller picks the steps per chain, and four chains or
//                  one: one chain on one element times the latency of a
//                  dependent product)
//   montmul_bls24315  the same over BLS24-315's fp (ten 32-bit limbs,
//                  R = 2^320, field.cuh's portable product: 210
//                  multiplies), whose latency prices the critical paths
//                  of the BLS24-315 kernels
//
// What bounds it on the H100: the issue rate of the one instruction, by
// design: 24 bytes of traffic per element against 512 operations.  The
// TPU version chains one (256, 512) block 64 times in one dispatch to hide
// a dispatch latency; here one launch covers enough elements to fill 132
// SMs at full occupancy, one thread per element.  Every step is inline
// PTX, asm volatile, so that the compiler's front end neither folds a
// chain (128 adds of y are one multiply-add) nor picks another
// instruction.  ptxas still optimises across asm statements: it summed the
// four chains of one y into a single chain (sum of (x + k) y^s is
// (4x + 6) y^s).  So each chain reads y through a volatile load of its
// own: four registers that hold one value, which ptxas cannot know.  The
// SASS says what was issued (chip_smoke.py --sass counts it); ptxas pairs
// two dependent adds into one three-input IADD3.
//
// Tensors are the package's: int64, one 32-bit value in each element's low
// half (montmul_bn254: [16, n] planes of 16-bit limbs, as the MSM kernels
// read them); float32 for fma_f32.  The integer outputs are int64: the low
// 32 bits of the sum for the 32-bit ops, all 64 bits for mad_wide_u32, and
// lo + hi (mod 2^32) summed over the chains for mad_lo_hi_u32.

#include <cuda_runtime.h>

#include "field.cuh"

constexpr int STEPS = 128;  // per chain; 4 chains: 512 steps per element

enum Op { MUL_U32, MUL16_U32, ADD_U32, MAD_WIDE_U32, MAD_LO_HI_U32 };

template <int OP>
__global__ void __launch_bounds__(256)
    chain_u32_kernel(const int64_t* x, const int64_t* y, int64_t* out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x0 = (uint32_t)x[i];
  const volatile int64_t* yv = y;
  uint32_t yk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) yk[k] = (uint32_t)yv[i];
  if (OP == MAD_WIDE_U32) {
    uint64_t a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = (uint64_t)(x0 + (uint32_t)k);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t lo = (uint32_t)a[(k + 1) % 4];
        asm volatile("mad.wide.u32 %0, %1, %2, %0;"
                     : "+l"(a[k]) : "r"(lo), "r"(yk[k]));
      }
    }
    out[i] = (int64_t)(a[0] + a[1] + a[2] + a[3]);
  } else if (OP == MAD_LO_HI_U32) {
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo[k] = x0 + (uint32_t)k;
      hi[k] = 0;
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t nl, nh;
        asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                     : "=r"(nl) : "r"(lo[k]), "r"(yk[k]), "r"(hi[k]));
        asm volatile("mad.hi.u32 %0, %1, %2, %1;"
                     : "=r"(nh) : "r"(lo[k]), "r"(yk[k]));
        lo[k] = nl;
        hi[k] = nh;
      }
    }
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) sum += lo[k] + hi[k];
    out[i] = (int64_t)sum;
  } else {
    uint32_t a[4], y16[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = x0 + (uint32_t)k;
      y16[k] = yk[k] & 0xffffu;
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (OP == MUL_U32) {
          asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(a[k]) : "r"(yk[k]));
        } else if (OP == MUL16_U32) {
          asm volatile(
              "and.b32 %0, %0, 0xffff;\n\t"
              "mul.lo.u32 %0, %0, %1;"
              : "+r"(a[k]) : "r"(y16[k]));
        } else {
          asm volatile("add.u32 %0, %0, %1;" : "+r"(a[k]) : "r"(yk[k]));
        }
      }
    }
    out[i] = (int64_t)(uint32_t)(a[0] + a[1] + a[2] + a[3]);
  }
}

__global__ void __launch_bounds__(256)
    chain_fma_f32_kernel(const float* x, const float* y, float* out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const volatile float* yv = y;
  float a[4], yk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = x[i] + (float)k;
    yk[k] = yv[i];
  }
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(a[k]) : "f"(yk[k]));
  }
  // the plain version's order: ((a0 + a1) + a2) + a3
  out[i] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// x, y, out: [2N, n] int64 planes of 16-bit limbs of the field P (N
// words), Montgomery form, < p.  Chain k starts at 2^k x (field
// doublings); the output is the field sum of the CHAINS accumulators.
// ``steps`` products per chain.
template <class P, int CHAINS>
__global__ void __launch_bounds__(128)
    chain_montmul_kernel(const int64_t* x, const int64_t* y, int64_t* out,
                         long n, int steps) {
  using F = Fp<P>;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const F y0 = load<P>(y + i, n);
  F a[CHAINS];
  a[0] = load<P>(x + i, n);
#pragma unroll
  for (int k = 1; k < CHAINS; ++k) a[k] = dbl(a[k - 1]);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) a[k] = mul(a[k], y0);
  }
#pragma unroll
  for (int k = 1; k < CHAINS; ++k) a[0] = add(a[0], a[k]);
  store(a[0], out + i, n);
}

// ---- C launchers: launch on the given stream, return cudaGetLastError() --

extern "C" int gnark_microbench_steps() { return STEPS; }

extern "C" int gnark_microbench_u32(int op, const void* x, const void* y,
                                    void* out, long n, void* stream) {
  const int block = 256;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* xp = (const int64_t*)x;
  const int64_t* yp = (const int64_t*)y;
  int64_t* op_ = (int64_t*)out;
  switch (op) {
    case MUL_U32:
      chain_u32_kernel<MUL_U32><<<grid, block, 0, st>>>(xp, yp, op_, n);
      break;
    case MUL16_U32:
      chain_u32_kernel<MUL16_U32><<<grid, block, 0, st>>>(xp, yp, op_, n);
      break;
    case ADD_U32:
      chain_u32_kernel<ADD_U32><<<grid, block, 0, st>>>(xp, yp, op_, n);
      break;
    case MAD_WIDE_U32:
      chain_u32_kernel<MAD_WIDE_U32><<<grid, block, 0, st>>>(xp, yp, op_, n);
      break;
    case MAD_LO_HI_U32:
      chain_u32_kernel<MAD_LO_HI_U32><<<grid, block, 0, st>>>(xp, yp, op_, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gnark_microbench_fma_f32(const void* x, const void* y,
                                        void* out, long n, void* stream) {
  const int block = 256;
  chain_fma_f32_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)out, n);
  return (int)cudaGetLastError();
}

template <class P>
int launch_montmul(const void* x, const void* y, void* out, long n, int steps,
                   int chains, void* stream) {
  const int block = 128;
  const unsigned grid = (unsigned)((n + block - 1) / block);
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* xp = (const int64_t*)x;
  const int64_t* yp = (const int64_t*)y;
  if (chains == 4)
    chain_montmul_kernel<P, 4><<<grid, block, 0, st>>>(xp, yp, (int64_t*)out,
                                                       n, steps);
  else if (chains == 1)
    chain_montmul_kernel<P, 1><<<grid, block, 0, st>>>(xp, yp, (int64_t*)out,
                                                       n, steps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int gnark_microbench_montmul(const void* x, const void* y,
                                        void* out, long n, int steps,
                                        int chains, void* stream) {
  return launch_montmul<BN254Fp>(x, y, out, n, steps, chains, stream);
}

extern "C" int gnark_microbench_montmul_bls24315(const void* x, const void* y,
                                                 void* out, long n, int steps,
                                                 int chains, void* stream) {
  return launch_montmul<BLS24315Fp>(x, y, out, n, steps, chains, stream);
}
