// Jacobian point formulas for a = 0 curves, templated on the curve's
// field: dbl-2009-l, add-2007-bl and madd-2007-bl with the degenerate
// cases resolved.
//
// Device counterpart of gnark_tpu_torch/ops/ec.py::CurveOps (which ports
// gnark_tpu/ops/ec.py).  Same formulas and the same case order as
// ec.py's double, add and add_mixed; every field operation is canonical, so
// the results equal the plain path's limb for limb.  Z == 0 is infinity;
// the identity that the plain path builds is (0 : 1 : 0).
//
// What bounds this on the H100: the field products (2M + 5S for a
// doubling, 11M + 5S for an add, 7M + 4S for a mixed add), i.e. the
// integer multiply rate.

#pragma once

#include "ec_complete.cuh"

// dbl-2009-l; infinity doubles to a point with Z = 2YZ = 0
template <class Curve>
GT_POINT Point<typename Curve::F> jdbl(const Point<typename Curve::F>& P) {
  using F = typename Curve::F;
  F A = sqr(P.X);
  F B = sqr(P.Y);
  F YZ = mul(P.Y, P.Z);
  F XB = add(P.X, B);
  F C = sqr(B);
  F t = sqr(XB);
  F D = dbl(sub(sub(t, A), C));
  F E = add(add(A, A), A);
  F G = sqr(E);
  F X3 = sub(G, dbl(D));
  F eightC = dbl(dbl(dbl(C)));
  F Y3 = sub(mul(E, sub(D, X3)), eightC);
  F Z3 = dbl(YZ);
  return {X3, Y3, Z3};
}

// madd-2007-bl: P (Jacobian) + (x2, y2) (affine, not infinity).  P
// infinite gives (x2 : y2 : 1); P == Q doubles; P == -Q gives (0 : 1 : 0).
template <class Curve>
GT_POINT Point<typename Curve::F> jadd_mixed(const Point<typename Curve::F>& P,
                                             const typename Curve::F& x2,
                                             const typename Curve::F& y2) {
  using F = typename Curve::F;
  using IO = FieldIO<F>;
  if (is_zero(P.Z)) return {x2, y2, IO::one()};
  F Z1Z1 = sqr(P.Z);
  F Y2Z1 = mul(y2, P.Z);
  F U2 = mul(x2, Z1Z1);
  F S2 = mul(Y2Z1, Z1Z1);
  F H = sub(U2, P.X);
  F dS = sub(S2, P.Y);
  if (is_zero(H)) {
    if (is_zero(dS)) return jdbl<Curve>(P);
    return identity<Curve>();
  }
  F HH = sqr(H);
  F I = dbl(dbl(HH));
  F r = dbl(dS);
  F ZH = add(P.Z, H);
  F J = mul(H, I);
  F V = mul(P.X, I);
  F rr = sqr(r);
  F zh2 = sqr(ZH);
  F X3 = sub(sub(rr, J), dbl(V));
  F a = mul(r, sub(V, X3));
  F YJ = mul(P.Y, J);
  F Y3 = sub(a, dbl(YJ));
  F Z3 = sub(sub(zh2, Z1Z1), HH);
  return {X3, Y3, Z3};
}

// add-2007-bl, unified: an infinite operand gives the other one; P == Q
// doubles; P == -Q gives (0 : 1 : 0).
template <class Curve>
GT_POINT Point<typename Curve::F> jadd(const Point<typename Curve::F>& P,
                                       const Point<typename Curve::F>& Q) {
  using F = typename Curve::F;
  if (is_zero(Q.Z)) return P;
  if (is_zero(P.Z)) return Q;
  F Z1Z1 = sqr(P.Z);
  F Z2Z2 = sqr(Q.Z);
  F Y1Z2 = mul(P.Y, Q.Z);
  F Y2Z1 = mul(Q.Y, P.Z);
  F U1 = mul(P.X, Z2Z2);
  F U2 = mul(Q.X, Z1Z1);
  F S1 = mul(Y1Z2, Z2Z2);
  F S2 = mul(Y2Z1, Z1Z1);
  F H = sub(U2, U1);
  F dS = sub(S2, S1);
  if (is_zero(H)) {
    if (is_zero(dS)) return jdbl<Curve>(P);
    return identity<Curve>();
  }
  F I = sqr(dbl(H));
  F r = dbl(dS);
  F J = mul(H, I);
  F V = mul(U1, I);
  F rr = sqr(r);
  F X3 = sub(sub(rr, J), dbl(V));
  F Z12 = add(P.Z, Q.Z);
  F a = mul(r, sub(V, X3));
  F SJ = mul(S1, J);
  F zz = sqr(Z12);
  F Y3 = sub(a, dbl(SJ));
  F Z3 = mul(sub(sub(zz, Z1Z1), Z2Z2), H);
  return {X3, Y3, Z3};
}
