// Complete projective point formulas for a = 0 curves (Renes, Costello,
// Batina 2015, algorithms 7-9), templated on the curve's field.
//
// Device counterpart of gnark_tpu_torch/ops/ec_complete.py (which ports
// gnark_tpu/ops/ec_complete.py::CompleteOps).  Same formulas, in the same
// order as ec_complete.py:168-233; every field operation is canonical, so
// the results equal the plain path's limb for limb.  The identity is the
// class (0 : Y : 0) with Y != 0.
//
// What bounds this on the H100: the field products (12M + 2 b3-muls for
// add, 8M + 1 for doubling), i.e. the integer multiply rate; a point is 3
// elements held in registers.  The mixed addition (alg 8) runs as levels
// of products over a thread group: msm_kernels.cu's fold_add_mixed.

#pragma once

#include "field.cuh"

// The point functions are compiled once per curve and called, not
// inlined at every call site: fully inlined fp2 formulas made nvcc take
// minutes on the kernels that call them several times.
#ifdef __CUDACC__
#define GT_POINT __host__ __device__ __noinline__
#else
#define GT_POINT inline
#endif

// Uniform load/store/constants over Fp and Fp2.
template <class F>
struct FieldIO;

template <class P>
struct FieldIO<Fp<P>> {
  using F = Fp<P>;
  GT_HD static F load(const int64_t* s, long stride, uint32_t* flags = nullptr) {
    return ::load<P>(s, stride, flags);
  }
  GT_HD static F zero() { return fp_zero<P>(); }
  GT_HD static F one() { return fp_one<P>(); }
};

template <class P>
struct FieldIO<Fp2<P>> {
  using F = Fp2<P>;
  GT_HD static F load(const int64_t* s, long stride, uint32_t* flags = nullptr) {
    return load2<P>(s, stride, flags);
  }
  GT_HD static F zero() { return {fp_zero<P>(), fp_zero<P>()}; }
  GT_HD static F one() { return {fp_one<P>(), fp_zero<P>()}; }
};

template <class F>
struct Point {
  F X, Y, Z;
};

template <class Curve>
GT_HD Point<typename Curve::F> identity() {
  using IO = FieldIO<typename Curve::F>;
  return {IO::zero(), IO::one(), IO::zero()};
}

// Point k-th coordinate limb l at src[(k * L16 + l) * stride].
template <class Curve>
GT_HD Point<typename Curve::F> load_point(const int64_t* src, long stride) {
  using F = typename Curve::F;
  using IO = FieldIO<F>;
  const long c = (long)F::L16 * stride;
  return {IO::load(src, stride), IO::load(src + c, stride),
          IO::load(src + 2 * c, stride)};
}

template <class Curve>
GT_HD void store_point(const Point<typename Curve::F>& P, int64_t* dst,
                       long stride) {
  using F = typename Curve::F;
  const long c = (long)F::L16 * stride;
  store(P.X, dst, stride);
  store(P.Y, dst + c, stride);
  store(P.Z, dst + 2 * c, stride);
}

// alg 7: complete projective addition
template <class Curve>
GT_POINT Point<typename Curve::F> padd(const Point<typename Curve::F>& P,
                                    const Point<typename Curve::F>& Q) {
  using F = typename Curve::F;
  F t0 = mul(P.X, Q.X);
  F t1 = mul(P.Y, Q.Y);
  F t2 = mul(P.Z, Q.Z);
  F t3 = mul(add(P.X, P.Y), add(Q.X, Q.Y));
  t3 = sub(t3, add(t0, t1));
  F t4 = mul(add(P.Y, P.Z), add(Q.Y, Q.Z));
  t4 = sub(t4, add(t1, t2));
  F Y3 = mul(add(P.X, P.Z), add(Q.X, Q.Z));
  Y3 = sub(Y3, add(t0, t2));
  t0 = add(dbl(t0), t0);  // 3 X1X2
  t2 = Curve::mul_b3(t2);
  F Z3 = add(t1, t2);
  t1 = sub(t1, t2);
  Y3 = Curve::mul_b3(Y3);
  F X3 = sub(mul(t3, t1), mul(t4, Y3));
  Y3 = add(mul(t1, Z3), mul(Y3, t0));
  Z3 = add(mul(Z3, t4), mul(t0, t3));
  return {X3, Y3, Z3};
}

// alg 9: complete doubling
template <class Curve>
GT_POINT Point<typename Curve::F> pdbl(const Point<typename Curve::F>& P) {
  using F = typename Curve::F;
  F t0 = sqr(P.Y);
  F Z3 = dbl(dbl(dbl(t0)));  // 8 Y^2
  F t1 = mul(P.Y, P.Z);
  F t2 = Curve::mul_b3(sqr(P.Z));
  F X3 = mul(t2, Z3);
  F Y3 = add(t0, t2);
  Z3 = mul(t1, Z3);
  t1 = dbl(t2);
  t2 = add(t1, t2);  // 3 b3 Z^2
  t0 = sub(t0, t2);
  Y3 = add(mul(t0, Y3), X3);
  t1 = mul(P.X, P.Y);
  X3 = dbl(mul(t0, t1));
  return {X3, Y3, Z3};
}
