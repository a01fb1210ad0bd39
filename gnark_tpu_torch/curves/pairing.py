"""Host-side optimal-ate pairings for BN and BLS12 curves.

Pairings sit on the verifier path only (reference call sites:
internal/backend/bn254/groth16/verify.go:58-84 MillerLoop /
FinalExponentiation, setup.go:268 Pair), so this is exact python-int
arithmetic, generic over CurveSpec — not a device kernel.  The heavy
prover math stays in ops/ (device).

Tower layout: fp12 = fp2[w]/(w^6 - xi) stored as 6 fp2 coefficients
(w-basis).  The standard fp2 -> fp6 -> fp12 towers are regroupings of
this basis (a0 = (c0, c2, c4), a1 = (c1, c3, c5), v = w^2); inversion
uses the tower formulas via that regrouping.  The w-basis makes both the
twist embedding (x*w^2, y*w^3) and Frobenius (c_i -> conj(c_i) *
xi^(i(p-1)/6)) trivial.

Miller loop runs in affine coordinates over E(Fp12) on untwisted points:
host ints make inversions cheap, and one code path covers D- and M-type
twists (the untwist map differs, nothing else).
"""

from __future__ import annotations

import dataclasses
import functools

from gnark_tpu_torch.curves.host import HostFp2


class Fp12:
    """fp12 = fp2[w]/(w^6 - xi) on tuples of 6 fp2 pairs."""

    def __init__(self, p: int, beta: int, xi: tuple):
        self.F2 = HostFp2(p, beta)
        self.p = p
        self.xi = xi
        self.zero = ((0, 0),) * 6
        self.one = ((1, 0),) + ((0, 0),) * 5

    def from_fp2(self, c, power: int = 0):
        out = [(0, 0)] * 6
        out[power] = c
        return tuple(out)

    def from_int(self, v):
        return self.from_fp2((v % self.p, 0))

    def add(self, a, b):
        F = self.F2
        return tuple(F.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        F = self.F2
        return tuple(F.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        F = self.F2
        return tuple(F.neg(x) for x in a)

    def mul(self, a, b):
        """Schoolbook with w^6 = xi reduction."""
        F = self.F2
        cols = [(0, 0)] * 11
        for i in range(6):
            if a[i] == (0, 0):
                continue
            for j in range(6):
                if b[j] == (0, 0):
                    continue
                cols[i + j] = F.add(cols[i + j], F.mul(a[i], b[j]))
        out = list(cols[:6])
        for k in range(6, 11):
            out[k - 6] = F.add(out[k - 6], F.mul(cols[k], self.xi))
        return tuple(out)

    def sqr(self, a):
        return self.mul(a, a)

    def conj(self, a):
        """Conjugation over fp6 (negate odd-w coefficients) = a^(p^6)."""
        F = self.F2
        return tuple(F.neg(c) if i & 1 else c for i, c in enumerate(a))

    # -- tower regrouping for inversion --------------------------------------

    def _fp6_mul(self, a, b):
        """(b0, b1, b2) basis (1, v, v^2), v^3 = xi."""
        F = self.F2
        t = [(0, 0)] * 5
        for i in range(3):
            for j in range(3):
                t[i + j] = F.add(t[i + j], F.mul(a[i], b[j]))
        return (F.add(t[0], F.mul(t[3], self.xi)),
                F.add(t[1], F.mul(t[4], self.xi)),
                t[2])

    def _fp6_inv(self, a):
        F = self.F2
        a0, a1, a2 = a
        xi = self.xi
        c0 = F.sub(F.mul(a0, a0), F.mul(xi, F.mul(a1, a2)))
        c1 = F.sub(F.mul(xi, F.mul(a2, a2)), F.mul(a0, a1))
        c2 = F.sub(F.mul(a1, a1), F.mul(a0, a2))
        t = F.add(F.mul(a0, c0),
                  F.mul(xi, F.add(F.mul(a2, c1), F.mul(a1, c2))))
        tinv = F.inv(t)
        return (F.mul(c0, tinv), F.mul(c1, tinv), F.mul(c2, tinv))

    def inv(self, a):
        """(a0 + a1 w)^-1 = (a0 - a1 w) / (a0^2 - v a1^2), fp6 components."""
        F = self.F2
        a0 = (a[0], a[2], a[4])
        a1 = (a[1], a[3], a[5])
        a1sq = self._fp6_mul(a1, a1)
        v_a1sq = (F.mul(a1sq[2], self.xi), a1sq[0], a1sq[1])  # * v
        t = tuple(F.sub(x, y) for x, y in zip(self._fp6_mul(a0, a0), v_a1sq))
        tinv = self._fp6_inv(t)
        r0 = self._fp6_mul(a0, tinv)
        r1 = self._fp6_mul(a1, tinv)
        return (r0[0], F.neg(r1[0]), r0[1], F.neg(r1[1]), r0[2], F.neg(r1[2]))

    def eq(self, a, b):
        return a == b

    # -- Frobenius --------------------------------------------------------------

    @functools.cached_property
    def _frob_gammas(self):
        """xi^(i(p-1)/6) for i in 0..5 (fp2 exponentiation)."""
        F = self.F2
        e = (self.p - 1) // 6
        g1 = self._fp2_pow(self.xi, e)
        out = [F.one]
        for _ in range(5):
            out.append(F.mul(out[-1], g1))
        return out

    def _fp2_pow(self, a, e: int):
        F = self.F2
        r = F.one
        while e:
            if e & 1:
                r = F.mul(r, a)
            a = F.mul(a, a)
            e >>= 1
        return r

    def frob(self, a):
        """a^p: conjugate fp2 coefficients, scale by gamma_i."""
        F = self.F2
        g = self._frob_gammas
        return tuple(F.mul((c[0], (-c[1]) % self.p), g[i])
                     for i, c in enumerate(a))

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        r = self.one
        while e:
            if e & 1:
                r = self.mul(r, a)
            a = self.mul(a, a)
            e >>= 1
        return r


@dataclasses.dataclass
class Pairing:
    """Optimal-ate pairing bound to a CurveSpec (families: bn, bls)."""

    curve: "CurveSpec"

    @functools.cached_property
    def fp12(self) -> Fp12:
        c = self.curve
        return Fp12(c.fp.modulus, c.fp2_beta % c.fp.modulus, c.fp6_xi)

    @functools.cached_property
    def _twist_d(self) -> bool:
        """D-type (y^2 = x^3 + b/xi) vs M-type (b*xi), detected from b2."""
        F2 = self.fp12.F2
        b = self.curve.b
        if F2.eq(self.curve.b2, F2.mul((b, 0), F2.inv(self.curve.fp6_xi))):
            return True
        if F2.eq(self.curve.b2, F2.mul((b, 0), self.curve.fp6_xi)):
            return False
        raise ValueError("b2 is neither b/xi nor b*xi — check fp6_xi")

    def _untwist(self, Q):
        """E'(fp2) -> E(fp12).  D: (x w^2, y w^3); M: (x w^4/xi, y w^3/xi)."""
        K = self.fp12
        x, y = Q
        if self._twist_d:
            return (K.from_fp2(x, 2), K.from_fp2(y, 3))
        xi_inv = K.F2.inv(self.curve.fp6_xi)
        return (K.from_fp2(K.F2.mul(x, xi_inv), 4),
                K.from_fp2(K.F2.mul(y, xi_inv), 3))

    def _embed_g1(self, P):
        K = self.fp12
        return (K.from_int(P[0]), K.from_int(P[1]))

    # -- E(fp12) affine group law ------------------------------------------------

    def _line(self, T, Q, P):
        """Line through T, Q (or tangent at T if T == Q) evaluated at P;
        also returns T + Q.  Affine coordinates over fp12."""
        K = self.fp12
        xT, yT = T
        xQ, yQ = Q
        if K.eq(xT, xQ):
            if K.eq(yT, yQ):
                if yT == K.zero:
                    raise ArithmeticError("unexpected 2-torsion in Miller loop")
                num = K.mul(K.from_int(3), K.sqr(xT))
                den = K.add(yT, yT)
            else:
                # vertical line x - xT; T + Q = infinity.  Cannot happen for
                # r-torsion inputs with an ate loop count < r.
                raise ArithmeticError("unexpected infinity in Miller loop")
        else:
            num = K.sub(yQ, yT)
            den = K.sub(xQ, xT)
        lam = K.mul(num, K.inv(den))
        x3 = K.sub(K.sub(K.sqr(lam), xT), xQ)
        y3 = K.sub(K.mul(lam, K.sub(xT, x3)), yT)
        # l(P) = yP - yT - lam (xP - xT)
        l = K.sub(K.sub(P[1], yT), K.mul(lam, K.sub(P[0], xT)))
        return (x3, y3), l

    def _frob_point(self, Q):
        K = self.fp12
        return (K.frob(Q[0]), K.frob(Q[1]))

    def miller_loop(self, pairs) -> tuple:
        """prod of Miller functions f_{ate}(Q_i, P_i); pairs of host affine
        (P in G1, Q in G2); None entries (infinity) are skipped."""
        K = self.fp12
        f_total = K.one
        c = self.curve
        if c.family == "bn":
            loop = 6 * c.x_param + 2
        else:
            loop = c.x_param
        neg = loop < 0
        loop = abs(loop)
        for P, Q in pairs:
            if P is None or Q is None:
                continue
            Pe = self._embed_g1(P)
            Qe = self._untwist(Q)
            f = K.one
            T = Qe
            for bit in bin(loop)[3:]:
                f = K.sqr(f)
                T, l = self._line(T, T, Pe)
                f = K.mul(f, l)
                if bit == "1":
                    T, l = self._line(T, Qe, Pe)
                    f = K.mul(f, l)
            if neg:
                # f_{-u} = 1 / (f_u * v_{uQ}); verticals vanish after the
                # final exponentiation (even embedding degree), and the easy
                # part turns inversion into conjugation.
                f = K.conj(f)
                T = (T[0], K.neg(T[1]))
            if c.family == "bn":
                # two extra additions with pi(Q) and -pi^2(Q)
                Q1 = self._frob_point(Qe)
                Q2 = self._frob_point(Q1)
                Q2 = (Q2[0], K.neg(Q2[1]))
                T, l = self._line(T, Q1, Pe)
                f = K.mul(f, l)
                T, l = self._line(T, Q2, Pe)
                f = K.mul(f, l)
            f_total = K.mul(f_total, f)
        return f_total

    def final_exp(self, f) -> tuple:
        """f^((p^12 - 1)/r): easy part via conj/frob; hard part by the
        BLS12 x-chain (p^4-p^2+1)/r = (u-1)^2 (u+p)(u^2+p^2-1) + 3
        (Hayashida et al.), generic square-and-multiply for BN."""
        K = self.fp12
        p, r = self.curve.fp.modulus, self.curve.fr.modulus
        # easy: f^(p^6 - 1) then ^(p^2 + 1)
        f = K.mul(K.conj(f), K.inv(f))
        f = K.mul(K.frob(K.frob(f)), f)
        if self.curve.family != "bls":
            return K.pow(f, (p ** 4 - p ** 2 + 1) // r)
        # hard part, cyclotomic subgroup: inverse == conjugate
        u = self.curve.x_param

        def powu(x, e):
            """x^e for signed e; inverse is conjugation here."""
            out = K.pow(x, abs(e))
            return K.conj(out) if e < 0 else out

        t0 = K.mul(powu(f, u), K.conj(f))           # f^(u-1)
        t0 = K.mul(powu(t0, u), K.conj(t0))         # f^((u-1)^2)
        t0 = K.mul(powu(t0, u), K.frob(t0))         # ^(u+p)
        t0 = K.mul(K.mul(powu(powu(t0, u), u),      # ^(u^2+p^2-1)
                         K.frob(K.frob(t0))),
                   K.conj(t0))
        return K.mul(t0, K.mul(K.sqr(f), f))        # * f^3

    def pair(self, P, Q) -> tuple:
        """Full pairing e(P, Q) in GT (fp12)."""
        return self.final_exp(self.miller_loop([(P, Q)]))

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1."""
        return self.final_exp(self.miller_loop(pairs)) == self.fp12.one


@functools.lru_cache(maxsize=None)
def pairing_for(curve):
    fam = getattr(curve, "family", "")
    if fam == "bw6":
        from gnark_tpu_torch.curves.pairing_bw6 import PairingBW6
        return PairingBW6(curve)
    if fam == "bls24":
        # optimal ate: 32-bit NAF loop + x-chain final exp, ~17x faster
        # than the Tate/full-exponent variant (kept for cross-checks)
        from gnark_tpu_torch.curves.pairing_bw6 import PairingBLS24Ate
        return PairingBLS24Ate(curve)
    return Pairing(curve)
