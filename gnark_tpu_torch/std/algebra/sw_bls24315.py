"""In-circuit BLS24-315 curve operations and pairing (for circuits over
BW6-633, whose scalar field = BLS24-315's base field; counterpart of
gnark_tpu/std/algebra/sw_bls24315.py, its hint under gnark_tpu's name).

Reference: std/algebra/sw_bls24315/{g1.go, g2.go, pairing.go} — affine
short-Weierstrass gadgets (incomplete formulas, same honest-prover
caveat as sw_bls12377) and the optimal-ate Miller loop + x-chain final
exponentiation as E24 gadget arithmetic.

The Miller loop mirrors the host optimal-ate pairing
(curves/pairing_bw6.PairingBLS24Ate) operation-for-operation — affine
E(Fp24) points, D-twist untwist (x z^2, y z^3), NAF(|x|) loop with
trailing conjugation for the negative seed — so gadget output equals
the host pairing output coefficient-for-coefficient (differential-
tested through the big-int engine).
"""

from __future__ import annotations

from gnark_tpu_torch.backend.hints import register_as_reference
from gnark_tpu_torch.curves import BLS24_315
from gnark_tpu_torch.curves.pairing_bw6 import naf_digits
from gnark_tpu_torch.std.algebra import sw_bls12377
from gnark_tpu_torch.std.algebra.fields_bls24315 import (
    E2, E4, E24, flat_to_tower, tower_to_flat)

X_PARAM = BLS24_315.x_param       # -0xbfcfffff (negative seed)
FP = BLS24_315.fp.modulus
FR = BLS24_315.fr.modulus
NAF = naf_digits(-X_PARAM)        # weight 5: 2^32 - 2^30 - 2^22 + 2^20 - 1

# ---- GLV endomorphism parameters (sw_bls24315/g1.go DecomposeScalar) -----
# lambda = x^4 - 1: lambda^2 + lambda + 1 = x^8 - x^4 + 1 = r; beta is the
# matching cube root of unity in fp with phi(P) = (beta*x, y) = [lambda]P
# (checked in tests/test_recursion_bls24.py::test_glv_constants).
GLV_LAMBDA = (X_PARAM ** 4 - 1) % FR
GLV_BETA = 39705142672498995661671850106945620852186608752525090699191017895721506694646055668218723303426
# lattice: v1 = (lambda, -1), v2 = (1, x^4); det = lambda*x^4 + 1 = r
_X4 = X_PARAM ** 4


@register_as_reference
def decompose_scalar_bls24315(q, ins, n):
    """Hint: s -> (s1, s2, k) with s1 + lambda*s2 = s + k*r (babai
    rounding + nonnegative normalization, as sw_bls12377)."""
    s = ins[0] % FR
    a = (s * _X4 + FR // 2) // FR
    b = (s + FR // 2) // FR
    s1 = s - a * GLV_LAMBDA - b
    s2 = a - b * _X4
    guard = 0
    while s1 < 0 or s2 < 0 or (s1 <= GLV_LAMBDA and s2 <= GLV_LAMBDA):
        s1 += GLV_LAMBDA + 1
        s2 += GLV_LAMBDA
        guard += 1
        assert guard < 8, "GLV normalization runaway"
    k, rem = divmod(s1 + GLV_LAMBDA * s2 - s, FR)
    assert rem == 0
    return [s1, s2, k]


class G1Gadget(sw_bls12377.G1Gadget):
    """Affine BLS24-315 G1 ops (g1.go analog): the generic affine/GLV
    machinery from sw_bls12377 bound to this curve's constants."""

    CURVE = BLS24_315
    FR_MOD = FR
    LAMBDA = GLV_LAMBDA
    BETA_GLV = GLV_BETA
    DECOMP_HINT = staticmethod(decompose_scalar_bls24315)


class G2Gadget:
    """Affine G2 ops on E4 coordinate pairs (g2.go analog)."""

    def __init__(self, api):
        self.api = api
        self.e4 = E4(api)

    def add(self, P, Q):
        F = self.e4
        lam = F.mul(F.sub(Q[1], P[1]), F.inverse(F.sub(Q[0], P[0])))
        x3 = F.sub(F.sub(F.sqr(lam), P[0]), Q[0])
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def double(self, P):
        F = self.e4
        lam = F.mul(F.mul_by_fp(F.sqr(P[0]), 3),
                    F.inverse(F.mul_by_fp(P[1], 2)))
        x3 = F.sub(F.sqr(lam), F.mul_by_fp(P[0], 2))
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def neg(self, P):
        return (P[0], self.e4.neg(P[1]))


def _e4_tuple(x):
    """Flatten an E4 gadget value ((a0,a1),(b0,b1)) or accept a host
    4-tuple (c0..c3 over the quartic basis v^i): returns v-basis list.

    E4 basis (1, u, v, u v) vs quartic v-basis (1, v, v^2=u, v^3=u v):
    quartic coefficient order is (e2[0][0], e4[1][0][0]...) — handled by
    index map below."""
    if len(x) == 4:                       # host quartic tuple
        return list(x)
    # tower ((a0 + a1 u) + (b0 + b1 u) v) -> quartic (a0, b0, a1, b1)
    (a0, a1), (b0, b1) = x
    return [a0, b0, a1, b1]


class PairingGadget:
    """Optimal-ate pairing as E24 circuit arithmetic (pairing.go analog),
    mirroring curves/pairing_bw6.PairingBLS24Ate exactly."""

    def __init__(self, api):
        self.api = api
        self.e24 = E24(api)
        self.e4 = E4(api)
        self.e2 = E2(api)

    # E24 element from G1/G2 coordinates (flat zeta-power placement)

    def _embed_fp(self, v):
        flat = [0] * 24
        flat[0] = v
        return flat_to_tower(flat)

    def _embed_g1(self, P):
        return (self._embed_fp(P[0]), self._embed_fp(P[1]))

    def _untwist_g2(self, Q):
        """E'(Fp4) -> E(Fp24), D-twist: (x, y) -> (x z^2, y z^3); the
        quartic coefficient i (of v = z^6) lands at z^(6i+2) / z^(6i+3)."""
        xq, yq = [0] * 24, [0] * 24
        for i, c in enumerate(_e4_tuple(Q[0])):
            xq[6 * i + 2] = c
        for i, c in enumerate(_e4_tuple(Q[1])):
            yq[6 * i + 3] = c
        return (flat_to_tower(xq), flat_to_tower(yq))

    def _line(self, T, Q, P):
        """Chord/tangent through T,Q evaluated at P; returns (T+Q, l)."""
        K = self.e24
        xT, yT = T
        xQ, yQ = Q
        if T is Q:
            num = K.mul(self._embed_fp(3), K.sqr(xT))
            den = K.add(yT, yT)
        else:
            num = K.sub(yQ, yT)
            den = K.sub(xQ, xT)
        lam = K.mul(num, K.inverse(den))
        x3 = K.sub(K.sub(K.sqr(lam), xT), xQ)
        y3 = K.sub(K.mul(lam, K.sub(xT, x3)), yT)
        l = K.sub(K.sub(P[1], yT), K.mul(lam, K.sub(P[0], xT)))
        return (x3, y3), l

    def miller_loop(self, pairs):
        """prod f_{|x|}(Q_i, P_i) conjugated (x < 0); pairs of
        ((x, y) G1 vars, ((x, y) E4) G2)."""
        K = self.e24
        f_total = None
        for P, Q in pairs:
            Pe = self._embed_g1(P)
            Qe = self._untwist_g2(Q)
            Qneg = (Qe[0], (K.e12.neg(Qe[1][0]), K.e12.neg(Qe[1][1])))
            f = K.one()
            T = Qe
            for bit_pos in range(len(NAF) - 2, -1, -1):
                f = K.sqr(f)
                T, l = self._line(T, T, Pe)
                f = K.mul(f, l)
                d = NAF[bit_pos]
                if d:
                    T, l = self._line(T, Qe if d > 0 else Qneg, Pe)
                    f = K.mul(f, l)
            f_total = f if f_total is None else K.mul(f_total, f)
        return K.conjugate(f_total)

    def _powu(self, a):
        """a^x for the SIGNED seed x (cyclotomic input: inverse = conj)."""
        K = self.e24
        an = K.conjugate(a)
        r = a if NAF[-1] > 0 else an
        for bit_pos in range(len(NAF) - 2, -1, -1):
            r = K.sqr(r)
            d = NAF[bit_pos]
            if d > 0:
                r = K.mul(r, a)
            elif d < 0:
                r = K.mul(r, an)
        return K.conjugate(r)         # NAF encodes |x|; x < 0

    def final_exp(self, f):
        """f^(3 (p^24-1)/r) via the x-chain
        (x-1)^2 (x+p) (x^2+p^2) (x^4+p^4-1) + 3 after the easy part —
        matching the host PairingBLS24Ate.final_exp exactly."""
        K = self.e24
        f = K.mul(K.conjugate(f), K.inverse(f))
        f = K.mul(K.frobenius(f, 4), f)
        t = K.mul(self._powu(f), K.conjugate(f))                   # f^(x-1)
        t = K.mul(self._powu(t), K.conjugate(t))                   # ^(x-1)
        t = K.mul(self._powu(t), K.frobenius(t, 1))                # ^(x+p)
        t = K.mul(self._powu(self._powu(t)), K.frobenius(t, 2))    # ^(x2+p2)
        t4 = self._powu(self._powu(self._powu(self._powu(t))))
        t = K.mul(K.mul(t4, K.frobenius(t, 4)), K.conjugate(t))    # x4+p4-1
        return K.mul(t, K.mul(K.sqr(f), f))                        # * f^3

    def pair(self, P, Q):
        return self.final_exp(self.miller_loop([(P, Q)]))
