"""Complete projective EC formulas for a = 0 curves, in plain PyTorch
(counterpart of gnark_tpu/ops/ec_complete.py::CompleteOps).

Renes-Costello-Batina 2015, algorithms 7-9: homogeneous (X : Y : Z)
formulas correct for every input pair (identity, P == Q, P == -Q) with no
branch.  The identity is the class (0 : Y : 0), Y != 0.  The operation
order is gnark_tpu's, and csrc/ec_complete.cuh repeats it, so a kernel and
this module give the same limbs for the same inputs.
"""

from __future__ import annotations

import torch

from gnark_tpu_torch.ops.limbs import _col, _limb_list


class CompleteOps:
    """Complete projective group ops bound to field ops F and curve b.

    b is the curve coefficient in regular form: an int for fp, a tuple of
    coefficients for an extension (fp2's (c0, c1), fp4's four).  b3 = 3b
    goes through ``mul_small`` when it is a small fp constant (BN254 G1:
    9) and through a Montgomery product with the constant otherwise
    (BN254 G2, BLS24-315 G2).
    """

    def __init__(self, F, b):
        self.F = F
        self.b = b
        ext = hasattr(F, "base")
        spec = F.base.spec if ext else F.spec
        q, R = spec.modulus, spec.R
        b3 = [3 * c % q for c in (b if ext else (b,))]
        self._b3_small = b3[0] if not ext and b3[0] < (1 << 12) else None
        self._b3_mont = [x for c in b3 for x in _limb_list(c * R % q, spec.L)]
        self._b3_dev = {}

    def _b3_planes(self, device):
        """b3 in Montgomery form, one [L] (fp) or [kL] (fp^k) column."""
        c = self._b3_dev.get(device)
        if c is None:
            c = torch.tensor(self._b3_mont, dtype=torch.int64, device=device)
            self._b3_dev[device] = c
        return c

    # -- constructors / conversions ----------------------------------------

    def inf(self, n, device):
        z = self.F.zeros(n, device)
        return (z, self.F.ones(n, device), z.clone())

    def neg(self, P):
        X, Y, Z = P
        return (X, self.F.neg(Y), Z)

    def select(self, mask, P, Q):
        F = self.F
        return tuple(F.select(mask, a, b) for a, b in zip(P, Q))

    def mask_inf(self, P, valid):
        """Force invalid lanes to the identity class (0 : 1 : 0): the RCB
        proof needs X = 0 too, not only Z = 0."""
        F = self.F
        X, Y, Z = P
        return (F.select(valid, X, torch.zeros_like(X)),
                F.select(valid, Y, F.ones_like(Y)),
                F.select(valid, Z, torch.zeros_like(Z)))

    def to_jacobian(self, P):
        """Projective -> Jacobian: (XZ, YZ^2, Z) (same affine point)."""
        F = self.F
        X, Y, Z = P
        return (F.mul(X, Z), F.mul(Y, F.sqr(Z)), Z)

    # -- b3 const-mul --------------------------------------------------------

    def _mul_b3(self, a):
        if self._b3_small is not None:
            return self.F.mul_small(a, self._b3_small)
        return self.F.mul(a, _col(self._b3_planes(a.device), a.ndim))

    # -- group law (RCB15 algorithms 7-9, a = 0) ----------------------------
    # The formulas are gnark_tpu's (ec_complete.py:168-233); independent
    # field operations run as one batch along the last axis, which cuts
    # the number of torch calls (the plain path is dispatch-bound).

    def add(self, P, Q):
        """Complete projective addition (alg 7): 12M + 2 b3-muls."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        xy1, xy2, yz1, yz2, xz1, xz2 = _many(
            F.add, (X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))
        t0, t1, t2, t3, t4, Y3 = _many(
            F.mul, (X1, X2), (Y1, Y2), (Z1, Z2), (xy1, xy2), (yz1, yz2),
            (xz1, xz2))
        s01, s12, s02 = _many(F.add, (t0, t1), (t1, t2), (t0, t2))
        t3, t4, Y3 = _many(F.sub, (t3, s01), (t4, s12), (Y3, s02))
        t2, Y3 = _split(self._mul_b3(torch.cat([t2, Y3], -1)), 2)
        t0d, Z3 = _many(F.add, (t0, t0), (t1, t2))
        t0 = F.add(t0d, t0)                   # 3 X1X2
        t1 = F.sub(t1, t2)
        m = _many(F.mul, (t3, t1), (t4, Y3), (t1, Z3), (Y3, t0), (Z3, t4),
                  (t0, t3))
        X3 = F.sub(m[0], m[1])
        Y3, Z3 = _many(F.add, (m[2], m[3]), (m[4], m[5]))
        return (X3, Y3, Z3)

    def add_mixed(self, P, xy, q_inf):
        """Complete mixed addition (alg 8, Z2 = 1): 11M + 2 b3-muls; an
        affine point flagged infinite leaves P unchanged."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2 = xy
        s1, s2 = _many(F.add, (X1, Y1), (X2, Y2))
        t0, t1, t3, xz, yz = _many(
            F.mul, (X1, X2), (Y1, Y2), (s1, s2), (X2, Z1), (Y2, Z1))
        t01, t4, t5, t0d = _many(
            F.add, (t0, t1), (xz, X1), (yz, Y1), (t0, t0))
        t3 = F.sub(t3, t01)
        t0_3 = F.add(t0d, t0)                 # 3 X1X2
        tz, Y3 = _split(self._mul_b3(torch.cat([Z1, t4], -1)), 2)
        Z3 = F.add(t1, tz)
        t1 = F.sub(t1, tz)
        m = _many(F.mul, (t3, t1), (t5, Y3), (t1, Z3), (Y3, t0_3),
                  (Z3, t5), (t0_3, t3))
        X3 = F.sub(m[0], m[1])
        Y3, Z3 = _many(F.add, (m[2], m[3]), (m[4], m[5]))
        return self.select(q_inf, P, (X3, Y3, Z3))

    def double(self, P):
        """Complete doubling (alg 9): 6M + 2S + 1 b3-mul."""
        F = self.F
        X, Y, Z = P
        t0, t1, zz, xy = _many(F.mul, (Y, Y), (Y, Z), (Z, Z), (X, Y))
        t2 = self._mul_b3(zz)                     # b3 Z^2
        y2 = F.double(t0)
        y4 = F.double(y2)
        Z3, Y3, t1d = _many(F.add, (y4, y4), (t0, t2), (t2, t2))  # 8 Y^2
        X3, Z3 = _many(F.mul, (t2, Z3), (t1, Z3))
        t2 = F.add(t1d, t2)                       # 3 b3 Z^2
        t0 = F.sub(t0, t2)
        a, b = _many(F.mul, (t0, Y3), (t0, xy))
        Y3, X3 = _many(F.add, (a, X3), (b, b))
        return (X3, Y3, Z3)


def _split(x, k):
    n = x.shape[-1] // k
    return [x[..., i * n:(i + 1) * n] for i in range(k)]


def _many(fn, *pairs):
    """Apply a binary field op to several same-shape operand pairs in one
    call, concatenated along the last axis."""
    r = fn(torch.cat([a for a, _ in pairs], -1),
           torch.cat([b for _, b in pairs], -1))
    return _split(r, len(pairs))
