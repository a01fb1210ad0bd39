"""Jacobian EC ops over limb planes, in plain PyTorch (counterpart of
gnark_tpu/ops/ec.py::CurveOps).

Short Weierstrass, a = 0.  A point batch is a tuple (X, Y, Z) of field
element batches; Z == 0 encodes infinity.  Generic over the field ops
(FieldOps for G1, Fp2Ops or FpKOps for G2).  Setup's fixed-base step and the
conversion of results to affine use these; the MSM uses the complete
formulas of ec_complete.py.
"""

from __future__ import annotations

import torch

from gnark_tpu_torch.ops.ec_complete import _many


class CurveOps:
    """EC group ops bound to a field-ops object F (FieldOps or Fp2Ops)."""

    def __init__(self, F, b=None):
        self.F = F
        self.b = b   # curve coefficient: the MSM builds CompleteOps from it

    def inf(self, n, device):
        z = self.F.zeros(n, device)
        return (z, self.F.ones(n, device), z.clone())

    def from_affine(self, xy):
        x, y = xy
        return (x, y, self.F.ones_like(x))

    def is_inf(self, P):
        return self.F.is_zero(P[2])

    def neg(self, P):
        X, Y, Z = P
        return (X, self.F.neg(Y), Z)

    def select(self, mask, P, Q):
        F = self.F
        return tuple(F.select(mask, a, b) for a, b in zip(P, Q))

    # -- group law ------------------------------------------------------------

    def double(self, P):
        """dbl-2009-l (2M + 5S).  Infinity doubles to infinity."""
        F = self.F
        X, Y, Z = P
        A, B, YZ = _many(F.mul, (X, X), (Y, Y), (Y, Z))
        XB = F.add(X, B)
        C, t = _many(F.mul, (B, B), (XB, XB))
        D = F.double(F.sub(F.sub(t, A), C))
        E = F.add(F.add(A, A), A)
        G = F.sqr(E)
        X3 = F.sub(G, F.double(D))
        eightC = F.double(F.double(F.double(C)))
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), eightC)
        Z3 = F.double(YZ)
        return (X3, Y3, Z3)

    def add(self, P, Q):
        """Unified Jacobian add (add-2007-bl + masked degenerate cases)."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1, Z2Z2, Y1Z2, Y2Z1 = _many(
            F.mul, (Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1))
        U1, U2, S1, S2 = _many(
            F.mul, (X1, Z2Z2), (X2, Z1Z1), (Y1Z2, Z2Z2), (Y2Z1, Z1Z1))
        H, dS = _many(F.sub, (U2, U1), (S2, S1))
        H2 = F.double(H)
        I = F.sqr(H2)
        r = F.double(dS)
        J, V, rr = _many(F.mul, (H, I), (U1, I), (r, r))
        X3 = F.sub(F.sub(rr, J), F.double(V))
        Z12 = F.add(Z1, Z2)
        a, SJ, zz = _many(F.mul, (r, F.sub(V, X3)), (S1, J), (Z12, Z12))
        Y3 = F.sub(a, F.double(SJ))
        Z3 = F.mul(F.sub(F.sub(zz, Z1Z1), Z2Z2), H)
        R = (X3, Y3, Z3)

        same_x = F.is_zero(H)
        same_y = F.is_zero(dS)
        p_inf = F.is_zero(Z1)
        q_inf = F.is_zero(Z2)
        R = self.select(same_x & same_y & ~p_inf & ~q_inf, self.double(P), R)
        R = self.select(same_x & ~same_y & ~p_inf & ~q_inf,
                        self.inf(X3.shape[1:], X3.device), R)
        R = self.select(p_inf, Q, R)
        return self.select(q_inf, P, R)

    def add_mixed(self, P, xy, q_inf):
        """P (Jacobian) + Q (affine, with an explicit infinity mask);
        madd-2007-bl (7M + 4S)."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2 = xy
        Z1Z1, Y2Z1 = _many(F.mul, (Z1, Z1), (Y2, Z1))
        U2, S2 = _many(F.mul, (X2, Z1Z1), (Y2Z1, Z1Z1))
        H, dS = _many(F.sub, (U2, X1), (S2, Y1))
        HH = F.sqr(H)
        I = F.double(F.double(HH))
        r = F.double(dS)
        ZH = F.add(Z1, H)
        J, V, rr, zh2 = _many(F.mul, (H, I), (X1, I), (r, r), (ZH, ZH))
        X3 = F.sub(F.sub(rr, J), F.double(V))
        a, YJ = _many(F.mul, (r, F.sub(V, X3)), (Y1, J))
        Y3 = F.sub(a, F.double(YJ))
        Z3 = F.sub(F.sub(zh2, Z1Z1), HH)
        R = (X3, Y3, Z3)

        same_x = F.is_zero(H)
        same_y = F.is_zero(dS)
        p_inf = F.is_zero(Z1)
        R = self.select(same_x & same_y & ~p_inf & ~q_inf, self.double(P), R)
        R = self.select(same_x & ~same_y & ~p_inf & ~q_inf,
                        self.inf(X3.shape[1:], X3.device), R)
        R = self.select(p_inf & ~q_inf, self.from_affine(xy), R)
        return self.select(q_inf, P, R)

    # -- conversions ------------------------------------------------------------

    def to_affine(self, P):
        """Batch Jacobian [L, n] -> affine via one batch inversion.
        Returns (x, y, inf_mask); infinity maps to (0, 0, True)."""
        F = self.F
        X, Y, Z = P
        zinv = F.batch_inv(Z) if hasattr(F, "batch_inv") else F.inv(Z)
        zinv2 = F.sqr(zinv)
        zinv3 = F.mul(zinv, zinv2)
        x, y = _many(F.mul, (X, zinv2), (Y, zinv3))
        return x, y, self.is_inf(P)


def points_to_host(G: CurveOps, P) -> list:
    """Jacobian point batch [L, n] -> host affine points (None = inf)."""
    x, y, inf = G.to_affine(P)
    xs, ys = G.F.unpack(x), G.F.unpack(y)
    infs = inf.cpu().tolist()
    return [None if infs[i] else (xs[i], ys[i]) for i in range(len(xs))]


def points_to_device(G: CurveOps, points, zero, device):
    """Host affine points (None = inf) -> (x, y, inf) limb planes."""
    xs = G.F.pack([zero if p is None else p[0] for p in points], device)
    ys = G.F.pack([zero if p is None else p[1] for p in points], device)
    inf = torch.tensor([p is None for p in points], device=device)
    return xs, ys, inf
