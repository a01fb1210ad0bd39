"""In-circuit BLS12-377 curve operations and pairing (for circuits over
BW6-761, whose scalar field = BLS12-377's base field; counterpart of
gnark_tpu/std/algebra/sw_bls12377.py, its hint under gnark_tpu's name).

Reference: std/algebra/sw_bls12377/{g1.go, g2.go, pairing.go} — affine
short-Weierstrass gadgets (incomplete formulas: the in-circuit ladder
assumes no identity/equal-x degeneracies, which holds for honest
prover data; same caveat as the reference) and the optimal-ate Miller
loop + final exponentiation as E12 gadget arithmetic.

The Miller loop mirrors curves/pairing.py exactly (affine E(Fp12)
points, untwist (x w^2, y w^3)) so gadget output == host pairing output
coefficient-for-coefficient — differential-tested through the big-int
engine.
"""

from __future__ import annotations

import functools

from gnark_tpu_torch.backend.hints import register_as_reference
from gnark_tpu_torch.curves import BLS12_377
from gnark_tpu_torch.curves.host import HostFp2
from gnark_tpu_torch.std.algebra.fields_bls12377 import E2, E12

X_PARAM = BLS12_377.x_param  # 9586122913090633729 (positive)
FP = BLS12_377.fp.modulus
FR = BLS12_377.fr.modulus

# ---- GLV endomorphism parameters (g1.go:209 DecomposeScalar) -------------
# lambda = x^2 - 1 is a cube root of unity mod r (lambda^2+lambda+1 = 0);
# beta is the matching cube root in fp with phi(P) = (beta*x, y) = [lambda]P.
GLV_LAMBDA = (X_PARAM * X_PARAM - 1) % FR
GLV_BETA = 80949648264912719408558363140637477264845294720710499478137287262712535938301461879813459410945
# short lattice basis for the split: v1 = (lambda, -1), v2 = (1, x^2);
# det = lambda*x^2 + 1 = r
_X2 = X_PARAM * X_PARAM


@register_as_reference
def decompose_scalar_bls12377(q, ins, n):
    """Hint: s -> (s1, s2, k) with s1 + lambda*s2 = s + k*r, s1/s2
    nonnegative ~128-bit with the high bits set (babai rounding on the
    GLV lattice + the reference's (lambda+1, lambda) normalization)."""
    s = ins[0] % FR
    a = (s * _X2 + FR // 2) // FR
    b = (s + FR // 2) // FR
    s1 = s - a * GLV_LAMBDA - b
    s2 = a - b * _X2
    guard = 0
    while s1 < 0 or s2 < 0 or (s1 <= GLV_LAMBDA and s2 <= GLV_LAMBDA):
        s1 += GLV_LAMBDA + 1
        s2 += GLV_LAMBDA
        guard += 1
        assert guard < 8, "GLV normalization runaway"
    k, rem = divmod(s1 + GLV_LAMBDA * s2 - s, FR)
    assert rem == 0
    return [s1, s2, k]


@functools.lru_cache(maxsize=None)
def frobenius_gammas(power: int = 1):
    """gamma_i = xi^(i (p^power - 1) / 6) in fp2, i in 0..5 (host ints)."""
    F2 = HostFp2(FP, -5)
    xi = (0, 1)
    e = (FP ** power - 1) // 6
    g1 = _fp2_pow(F2, xi, e)
    out = [(1, 0)]
    for _ in range(5):
        out.append(F2.mul(out[-1], g1))
    return out


def _fp2_pow(F2, a, e):
    r = F2.one
    while e:
        if e & 1:
            r = F2.mul(r, a)
        a = F2.mul(a, a)
        e >>= 1
    return r


# ---- affine curve gadgets ------------------------------------------------------


class G1Gadget:
    """Affine BLS12-377 G1 ops on circuit variables (g1.go analog).
    Incomplete formulas: callers must avoid identity / x1 == x2 cases.

    Class attributes parameterize the inner curve so 2-chain siblings
    (sw_bls24315) reuse the gadget with their own GLV constants."""

    CURVE = BLS12_377
    FR_MOD = FR
    LAMBDA = GLV_LAMBDA
    BETA_GLV = GLV_BETA
    DECOMP_HINT = staticmethod(decompose_scalar_bls12377)

    def __init__(self, api):
        self.api = api

    def add(self, P, Q):
        api = self.api
        lam = api.div_unchecked(api.sub(Q[1], P[1]), api.sub(Q[0], P[0]))
        x3 = api.sub(api.sub(api.mul(lam, lam), P[0]), Q[0])
        y3 = api.sub(api.mul(lam, api.sub(P[0], x3)), P[1])
        return (x3, y3)

    def double(self, P):
        api = self.api
        lam = api.div_unchecked(api.mul(api.mul(P[0], P[0]), 3),
                                api.mul(P[1], 2))
        x3 = api.sub(api.mul(lam, lam), api.mul(P[0], 2))
        y3 = api.sub(api.mul(lam, api.sub(P[0], x3)), P[1])
        return (x3, y3)

    def neg(self, P):
        return (P[0], self.api.neg(P[1]))

    def assert_is_on_curve(self, P):
        api = self.api
        y2 = api.mul(P[1], P[1])
        x3b = api.add(api.mul(api.mul(P[0], P[0]), P[0]), self.CURVE.b)
        api.assert_is_equal(y2, x3b)

    def scalar_mul_var(self, Q, s):
        """[s]Q for a VARIABLE point and scalar via GLV (g1.go:234
        varScalarMul): decompose s = s1 + lambda*s2 (hint, verified
        in-circuit), run a 128-iteration joint double-and-add over
        (Q, phi(Q)) instead of a 253-bit ladder — the endomorphism
        phi(x, y) = (beta*x, y) acts as multiplication by lambda."""
        api = self.api
        sd = api.new_hint(self.DECOMP_HINT, 3, s)
        s1, s2, k = sd
        # s1 + lambda*s2 == s + k*r over the outer field (no wrap: both
        # sides are far below the outer modulus)
        api.assert_is_equal(api.add(s1, api.mul(s2, self.LAMBDA)),
                            api.add(s, api.mul(k, self.FR_MOD)))
        nbits = self.LAMBDA.bit_length() + 1
        s1b = api.to_binary(s1, nbits)
        s2b = api.to_binary(s2, nbits)

        phiQ = (api.mul(Q[0], self.BETA_GLV), Q[1])
        negQ, negPhiQ = self.neg(Q), self.neg(phiQ)

        def pick(bit, P, Pneg):
            # only y differs under negation
            return (P[0], api.select(bit, P[1], Pneg[1]))

        # Acc = [2](Q + phi(Q)) +- Q +- phi(Q): high bits guaranteed set
        # by the decomposition, keeping the incomplete adds off their
        # degenerate cases for honest inputs (g1.go:289-300)
        acc = self.add(Q, phiQ)
        acc = self.double(acc)
        acc = self.add(acc, pick(s1b[nbits - 1], Q, negQ))
        acc = self.add(acc, pick(s2b[nbits - 1], phiQ, negPhiQ))

        for i in range(nbits - 2, 0, -1):
            B = self.add(pick(s1b[i], Q, negQ), pick(s2b[i], phiQ, negPhiQ))
            acc = self.add(self.double(acc), B)

        # bit 0: conditionally subtract Q / phi(Q)
        accQ = self.add(acc, negQ)
        acc = (api.select(s1b[0], acc[0], accQ[0]),
               api.select(s1b[0], acc[1], accQ[1]))
        accP = self.add(acc, negPhiQ)
        acc = (api.select(s2b[0], acc[0], accP[0]),
               api.select(s2b[0], acc[1], accP[1]))
        return acc

    def scalar_mul_const_base(self, base, scalar, nb_bits=None):
        """scalar * base for a CONSTANT host affine base point.

        Seeds the accumulator with the base (dodging the identity — the
        same offset trick as g1.go varScalarMul) and subtracts the
        host-precomputed 2^(nb_bits-1) * base at the end.  Incomplete-add
        caveat: degenerate chords occur only for adversarially chosen
        scalars, not for honest verifier inputs."""
        api = self.api
        if nb_bits is None:
            nb_bits = self.FR_MOD.bit_length()
        bits = api.to_binary(scalar, nb_bits)
        acc = base
        for i in range(nb_bits - 1, -1, -1):
            if i == nb_bits - 1:
                S = self.double(acc)       # acc == base: tangent, not chord
            else:
                acc = self.double(acc)
                S = self.add(acc, base)
            acc = (api.select(bits[i], S[0], acc[0]),
                   api.select(bits[i], S[1], acc[1]))
        host = self.CURVE.host_g1
        corr = host.neg(host.scalar_mul(base, pow(2, nb_bits - 1)))
        return self.add(acc, corr)

    def msm_with_constants(self, points, scalars, nb_bits=None):
        """sum scalars[i] * points[i] for CONSTANT host points (vk.K) —
        the verifier's public-input fold."""
        acc = None
        for P, s in zip(points, scalars):
            term = self.scalar_mul_const_base(P, s, nb_bits)
            acc = term if acc is None else self.add(acc, term)
        return acc


class G2Gadget:
    """Affine G2 ops on E2 coordinate pairs (g2.go analog)."""

    def __init__(self, api):
        self.api = api
        self.e2 = E2(api)

    def add(self, P, Q):
        F = self.e2
        lam = F.mul(F.sub(Q[1], P[1]), F.inverse(F.sub(Q[0], P[0])))
        x3 = F.sub(F.sub(F.sqr(lam), P[0]), Q[0])
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def double(self, P):
        F = self.e2
        lam = F.mul(F.mul_by_fp(F.sqr(P[0]), 3),
                    F.inverse(F.mul_by_fp(P[1], 2)))
        x3 = F.sub(F.sqr(lam), F.mul_by_fp(P[0], 2))
        y3 = F.sub(F.mul(lam, F.sub(P[0], x3)), P[1])
        return (x3, y3)

    def neg(self, P):
        return (P[0], self.e2.neg(P[1]))


# ---- pairing gadget --------------------------------------------------------------


class PairingGadget:
    """Optimal-ate pairing as E12 circuit arithmetic (pairing.go analog).

    Works on untwisted affine E(Fp12) points exactly like the host
    Pairing (curves/pairing.py), so results agree coefficient-wise.
    """

    def __init__(self, api):
        self.api = api
        self.e12 = E12(api)
        self.e2 = E2(api)

    # E12 element from G1/G2 coordinates

    def _embed_g1(self, P):
        K = self.e12
        z6 = K.e6.zero()
        x = ((( P[0], 0), (0, 0), (0, 0)), z6)
        y = ((( P[1], 0), (0, 0), (0, 0)), z6)
        return (x, y)

    def _untwist_g2(self, Q):
        """(x w^2, y w^3): w^2 = v, w^3 = v*w."""
        K = self.e12
        z2 = self.e2.zero()
        x = (((z2), (Q[0]), (z2)), K.e6.zero())      # x * v in c0
        y = (K.e6.zero(), ((z2), (Q[1]), (z2)))      # y * v in c1 (=v*w)
        return (x, y)

    def _line(self, T, Q, P):
        """Chord/tangent through T,Q evaluated at P; returns (T+Q, l)."""
        K = self.e12
        xT, yT = T
        xQ, yQ = Q
        if T is Q:
            num = K.mul(self._e12_fp(3), K.sqr(xT))
            den = K.add(yT, yT)
        else:
            num = K.sub(yQ, yT)
            den = K.sub(xQ, xT)
        lam = K.mul(num, K.inverse(den))
        x3 = K.sub(K.sub(K.sqr(lam), xT), xQ)
        y3 = K.sub(K.mul(lam, K.sub(xT, x3)), yT)
        l = K.sub(K.sub(P[1], yT), K.mul(lam, K.sub(P[0], xT)))
        return (x3, y3), l

    def _e12_fp(self, k):
        K = self.e12
        one = K.one()
        return (((k, 0), (0, 0), (0, 0)), K.e6.zero())

    def miller_loop(self, pairs):
        """prod f_ate(Q_i, P_i); pairs of ((x,y) G1 vars, ((x,y) E2) G2)."""
        K = self.e12
        f_total = K.one()
        first = True
        for P, Q in pairs:
            Pe = self._embed_g1(P)
            Qe = self._untwist_g2(Q)
            f = K.one()
            T = Qe
            for bit in bin(X_PARAM)[3:]:
                f = K.sqr(f)
                T, l = self._line(T, T, Pe)
                f = K.mul(f, l)
                if bit == "1":
                    T, l = self._line(T, Qe, Pe)
                    f = K.mul(f, l)
            f_total = f if first else K.mul(f_total, f)
            first = False
        return f_total

    def final_exp(self, f):
        """f^(3(p^12-1)/r): easy part (conj/frobenius), hard part by the
        BLS12 x-chain (u-1)^2 (u+p)(u^2+p^2-1) + 3 — matches the host
        pairing (curves/pairing.py) exactly.  In the cyclotomic subgroup
        the unitary inverse is conjugation (1 constraint-free negate)."""
        K = self.e12
        f = K.mul(K.conjugate(f), K.inverse(f))
        f = K.mul(K.frobenius(K.frobenius(f)), f)

        def powu(x):
            return K.pow_const(x, X_PARAM)

        t0 = K.mul(powu(f), K.conjugate(f))                 # f^(u-1)
        t0 = K.mul(powu(t0), K.conjugate(t0))               # ^(u-1)
        t0 = K.mul(powu(t0), K.frobenius(t0))               # ^(u+p)
        t0 = K.mul(K.mul(powu(powu(t0)),                    # ^(u^2+p^2-1)
                         K.frobenius(K.frobenius(t0))),
                   K.conjugate(t0))
        return K.mul(t0, K.mul(K.sqr(f), f))                # * f^3

    def pair(self, P, Q):
        return self.final_exp(self.miller_loop([(P, Q)]))
