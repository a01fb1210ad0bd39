// The MSM kernels of msm_kernels.cu for BLS24-315's G1 over its
// 10-word base field
// (kind g1_bls24315): a library of its own, built by an nvcc of its
// own beside the others (gnark_tpu_torch/ops/_cuda.py).

#define GNARK_MSM_BLS24315
#include "msm_kernels.cu"

#ifdef __CUDACC__
GNARK_MSM_LAUNCHERS(g1_bls24315, G1Bls24)
#endif
