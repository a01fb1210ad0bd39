"""In-circuit BLS12-377 extension-field towers (E2, E6, E12; counterpart
of gnark_tpu/std/algebra/fields_bls12377.py).

Reference: std/algebra/fields_bls12377/{e2.go, e6.go, e12.go} — circuit
gadgets computing fp2/fp6/fp12 arithmetic where the circuit's scalar
field IS the BLS12-377 base field (i.e. circuits compiled over BW6-761,
whose fr equals BLS12-377's fp — the 2-chain property).

Tower: fp2 = fp[u]/(u^2 + 5), fp6 = fp2[v]/(v^3 - u),
fp12 = fp6[w]/(w^2 - v); elements are (nested) tuples of api variables.
"""

from __future__ import annotations

BETA = -5            # u^2 = -5 (matches curves.BLS12_377.fp2_beta)
# xi = u: fp6 non-residue (matches curves.BLS12_377.fp6_xi == (0, 1))


class E2:
    """(a0, a1) = a0 + a1*u."""

    def __init__(self, api):
        self.api = api

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def add(self, a, b):
        api = self.api
        return (api.add(a[0], b[0]), api.add(a[1], b[1]))

    def sub(self, a, b):
        api = self.api
        return (api.sub(a[0], b[0]), api.sub(a[1], b[1]))

    def neg(self, a):
        api = self.api
        return (api.neg(a[0]), api.neg(a[1]))

    def mul(self, a, b):
        api = self.api
        v0 = api.mul(a[0], b[0])
        v1 = api.mul(a[1], b[1])
        c0 = api.add(v0, api.mul(v1, BETA))
        c1 = api.sub(api.mul(api.add(a[0], a[1]), api.add(b[0], b[1])),
                     api.add(v0, v1))
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_fp(self, a, k):
        api = self.api
        return (api.mul(a[0], k), api.mul(a[1], k))

    def mul_by_nonresidue(self, a):
        """a * u (the fp6 tower non-residue xi = u): (a0 + a1 u) u =
        beta*a1 + a0 u."""
        api = self.api
        return (api.mul(a[1], BETA), a[0])

    def conjugate(self, a):
        return (a[0], self.api.neg(a[1]))

    def inverse(self, a):
        api = self.api
        norm = api.sub(api.mul(a[0], a[0]),
                       api.mul(api.mul(a[1], a[1]), BETA))
        ninv = api.inverse(norm)
        return (api.mul(a[0], ninv), api.neg(api.mul(a[1], ninv)))

    def assert_is_equal(self, a, b):
        self.api.assert_is_equal(a[0], b[0])
        self.api.assert_is_equal(a[1], b[1])

    def select(self, cond, a, b):
        api = self.api
        return (api.select(cond, a[0], b[0]), api.select(cond, a[1], b[1]))


class E6:
    """(b0, b1, b2) over E2, basis (1, v, v^2), v^3 = u."""

    def __init__(self, api):
        self.api = api
        self.e2 = E2(api)

    def zero(self):
        z = self.e2.zero()
        return (z, z, z)

    def one(self):
        return (self.e2.one(), self.e2.zero(), self.e2.zero())

    def add(self, a, b):
        F = self.e2
        return tuple(F.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        F = self.e2
        return tuple(F.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        F = self.e2
        return tuple(F.neg(x) for x in a)

    def mul(self, a, b):
        F = self.e2
        t = [F.zero()] * 5
        for i in range(3):
            for j in range(3):
                t[i + j] = F.add(t[i + j], F.mul(a[i], b[j]))
        return (F.add(t[0], F.mul_by_nonresidue(t[3])),
                F.add(t[1], F.mul_by_nonresidue(t[4])),
                t[2])

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_nonresidue(self, a):
        """a * v: (b0 + b1 v + b2 v^2) v = u*b2 + b0 v + b1 v^2."""
        F = self.e2
        return (F.mul_by_nonresidue(a[2]), a[0], a[1])

    def inverse(self, a):
        F = self.e2
        a0, a1, a2 = a
        c0 = F.sub(F.sqr(a0), F.mul_by_nonresidue(F.mul(a1, a2)))
        c1 = F.sub(F.mul_by_nonresidue(F.sqr(a2)), F.mul(a0, a1))
        c2 = F.sub(F.sqr(a1), F.mul(a0, a2))
        t = F.add(F.mul(a0, c0),
                  F.mul_by_nonresidue(F.add(F.mul(a2, c1), F.mul(a1, c2))))
        tinv = F.inverse(t)
        return (F.mul(c0, tinv), F.mul(c1, tinv), F.mul(c2, tinv))

    def assert_is_equal(self, a, b):
        for x, y in zip(a, b):
            self.e2.assert_is_equal(x, y)

    def select(self, cond, a, b):
        return tuple(self.e2.select(cond, x, y) for x, y in zip(a, b))


class E12:
    """(c0, c1) over E6: c0 + c1*w, w^2 = v."""

    def __init__(self, api):
        self.api = api
        self.e6 = E6(api)
        self.e2 = self.e6.e2

    def zero(self):
        return (self.e6.zero(), self.e6.zero())

    def one(self):
        return (self.e6.one(), self.e6.zero())

    def add(self, a, b):
        F = self.e6
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def sub(self, a, b):
        F = self.e6
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def mul(self, a, b):
        F = self.e6
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        c0 = F.add(v0, F.mul_by_nonresidue(v1))
        c1 = F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])),
                   F.add(v0, v1))
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def conjugate(self, a):
        """a^(p^6): negate the w coefficient."""
        return (a[0], self.e6.neg(a[1]))

    def inverse(self, a):
        F = self.e6
        t = F.sub(F.sqr(a[0]), F.mul_by_nonresidue(F.sqr(a[1])))
        tinv = F.inverse(t)
        return (F.mul(a[0], tinv), F.neg(F.mul(a[1], tinv)))

    def div(self, a, b):
        return self.mul(a, self.inverse(b))

    def assert_is_equal(self, a, b):
        self.e6.assert_is_equal(a[0], b[0])
        self.e6.assert_is_equal(a[1], b[1])

    def select(self, cond, a, b):
        return (self.e6.select(cond, a[0], b[0]),
                self.e6.select(cond, a[1], b[1]))

    # ---- cyclotomic / Frobenius helpers (final exponentiation) -----------

    def frobenius(self, a, power: int = 1):
        """a^(p^power) via coefficient conjugation + gamma constants."""
        from gnark_tpu_torch.std.algebra import sw_bls12377 as sw
        gammas = sw.frobenius_gammas(power)
        F2 = self.e2

        def frob_e2(c):
            if power % 2 == 1:
                return F2.conjugate(c)
            return c

        # flatten to w-basis: element = sum_i c_i w^i with
        # c = [a0b0, a1b0, a0b1, a1b1, a0b2, a1b2] (w^2 = v)
        coeffs = [a[0][0], a[1][0], a[0][1], a[1][1], a[0][2], a[1][2]]
        out = []
        for i, c in enumerate(coeffs):
            fc = frob_e2(c)
            out.append(F2.mul(fc, gammas[i]) if i else fc)
        return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))

    def pow_const(self, a, e: int):
        """a^e for fixed positive exponent (square-and-multiply)."""
        assert e > 0
        bits = bin(e)[3:]
        r = a
        for b in bits:
            r = self.sqr(r)
            if b == "1":
                r = self.mul(r, a)
        return r
