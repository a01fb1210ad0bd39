"""In-circuit BLS24-315 extension-field towers (E2, E4, E12, E24;
counterpart of gnark_tpu/std/algebra/fields_bls24315.py).

Reference: std/algebra/fields_bls24315/{e2.go, e4.go, e12.go, e24.go} —
circuit gadgets computing fp2/fp4/fp12/fp24 arithmetic where the
circuit's scalar field IS the BLS24-315 base field (circuits compiled
over BW6-633, whose fr equals BLS24-315's fp — the 2-chain property).

Tower: fp2 = fp[u]/(u^2 - 13), fp4 = fp2[v]/(v^2 - u),
fp12 = fp4[w]/(w^3 - v), fp24 = fp12[z]/(z^2 - w); elements are nested
tuples of api variables.

The host pairing (curves/pairing_bw6.PairingBLS24Ate) works in the FLAT
basis fp[zeta]/(zeta^24 - 13); the tower basis monomial
u^a v^b w^c z^d equals zeta^(12a + 6b + 2c + d) (u = zeta^12,
v = zeta^6, w = zeta^2, z = zeta), so tower<->flat conversion is a pure
re-indexing of coefficients — `tower_to_flat` / `flat_to_tower` below —
and the p^e-Frobenius (a permutation + constant scaling of flat
coefficients) costs only constant-multiplications in-circuit.
"""

from __future__ import annotations

import functools

from gnark_tpu_torch.curves import BLS24_315

BETA = 13            # u^2 = 13 (curves.BLS24_315.g2_tower_c)
FP = BLS24_315.fp.modulus

# flat exponent of each tower leaf slot, in tower iteration order
# (E24 slot d, E12 slot c, E4 slot b, E2 slot a)
_TOWER_EXP = [
    (d, c, b, a, 12 * a + 6 * b + 2 * c + d)
    for d in range(2) for c in range(3) for b in range(2) for a in range(2)
]


def tower_to_flat(x):
    """Nested tower tuples -> 24-list ordered by flat zeta exponent."""
    out = [None] * 24
    for d, c, b, a, e in _TOWER_EXP:
        out[e] = x[d][c][b][a]
    return out


def flat_to_tower(f):
    """24 coefficients (flat zeta-power order) -> nested tower tuples."""
    def leaf(d, c, b):
        return (f[12 * 0 + 6 * b + 2 * c + d], f[12 * 1 + 6 * b + 2 * c + d])

    return tuple(
        tuple((leaf(d, c, 0), leaf(d, c, 1)) for c in range(3))
        for d in range(2))


@functools.lru_cache(maxsize=None)
def frobenius_consts(power: int):
    """Flat-basis p^power-Frobenius: coefficient i moves to slot
    (i p^e mod 24) scaled by 13^((i p^e) // 24)."""
    pe = FP ** power
    return tuple(((i * pe) % 24, pow(BETA, (i * pe) // 24, FP))
                 for i in range(24))


class E2:
    """(a0, a1) = a0 + a1*u, u^2 = 13."""

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
        """a * u: (a0 + a1 u) u = 13 a1 + a0 u."""
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


class E4:
    """(b0, b1) over E2: b0 + b1*v, v^2 = u."""

    def __init__(self, api):
        self.api = api
        self.e2 = E2(api)

    def zero(self):
        z = self.e2.zero()
        return (z, z)

    def one(self):
        return (self.e2.one(), self.e2.zero())

    def add(self, a, b):
        F = self.e2
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def sub(self, a, b):
        F = self.e2
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def neg(self, a):
        F = self.e2
        return (F.neg(a[0]), F.neg(a[1]))

    def mul(self, a, b):
        F = self.e2
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        c0 = F.add(v0, F.mul_by_nonresidue(v1))
        c1 = F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])),
                   F.add(v0, v1))
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_fp(self, a, k):
        F = self.e2
        return (F.mul_by_fp(a[0], k), F.mul_by_fp(a[1], k))

    def mul_by_nonresidue(self, a):
        """a * v: (b0 + b1 v) v = u b1 + b0 v."""
        F = self.e2
        return (F.mul_by_nonresidue(a[1]), a[0])

    def inverse(self, a):
        F = self.e2
        t = F.sub(F.sqr(a[0]), F.mul_by_nonresidue(F.sqr(a[1])))
        tinv = F.inverse(t)
        return (F.mul(a[0], tinv), F.neg(F.mul(a[1], tinv)))

    def assert_is_equal(self, a, b):
        self.e2.assert_is_equal(a[0], b[0])
        self.e2.assert_is_equal(a[1], b[1])

    def select(self, cond, a, b):
        return (self.e2.select(cond, a[0], b[0]),
                self.e2.select(cond, a[1], b[1]))


class E12:
    """(c0, c1, c2) over E4, basis (1, w, w^2), w^3 = v."""

    def __init__(self, api):
        self.api = api
        self.e4 = E4(api)

    def zero(self):
        z = self.e4.zero()
        return (z, z, z)

    def one(self):
        return (self.e4.one(), self.e4.zero(), self.e4.zero())

    def add(self, a, b):
        F = self.e4
        return tuple(F.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        F = self.e4
        return tuple(F.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        F = self.e4
        return tuple(F.neg(x) for x in a)

    def mul(self, a, b):
        F = self.e4
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
        """a * w: (c0 + c1 w + c2 w^2) w = v c2 + c0 w + c1 w^2."""
        F = self.e4
        return (F.mul_by_nonresidue(a[2]), a[0], a[1])

    def inverse(self, a):
        F = self.e4
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
            self.e4.assert_is_equal(x, y)

    def select(self, cond, a, b):
        return tuple(self.e4.select(cond, x, y) for x, y in zip(a, b))


class E24:
    """(d0, d1) over E12: d0 + d1*z, z^2 = w."""

    def __init__(self, api):
        self.api = api
        self.e12 = E12(api)
        self.e4 = self.e12.e4
        self.e2 = self.e4.e2

    def zero(self):
        return (self.e12.zero(), self.e12.zero())

    def one(self):
        return (self.e12.one(), self.e12.zero())

    def add(self, a, b):
        F = self.e12
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def sub(self, a, b):
        F = self.e12
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def mul(self, a, b):
        F = self.e12
        v0 = F.mul(a[0], b[0])
        v1 = F.mul(a[1], b[1])
        c0 = F.add(v0, F.mul_by_nonresidue(v1))
        c1 = F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])),
                   F.add(v0, v1))
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def conjugate(self, a):
        """a^(p^12): negate the z coefficient (the flat-basis gamma is
        -1 — see curves/pairing_bw6.Fp6Poly.conj)."""
        return (a[0], self.e12.neg(a[1]))

    def inverse(self, a):
        F = self.e12
        t = F.sub(F.sqr(a[0]), F.mul_by_nonresidue(F.sqr(a[1])))
        tinv = F.inverse(t)
        return (F.mul(a[0], tinv), F.neg(F.mul(a[1], tinv)))

    def div(self, a, b):
        return self.mul(a, self.inverse(b))

    def assert_is_equal(self, a, b):
        self.e12.assert_is_equal(a[0], b[0])
        self.e12.assert_is_equal(a[1], b[1])

    def select(self, cond, a, b):
        return (self.e12.select(cond, a[0], b[0]),
                self.e12.select(cond, a[1], b[1]))

    def frobenius(self, a, power: int = 1):
        """a^(p^power) via the flat basis: fp coefficients are Frobenius
        -fixed, so the map is a permutation + constant scaling of the 24
        flat coefficients (free re-indexing + constant muls)."""
        api = self.api
        flat = tower_to_flat(a)
        out = [0] * 24
        for i, (j, c) in enumerate(frobenius_consts(power)):
            out[j] = flat[i] if c == 1 else api.mul(flat[i], c)
        return flat_to_tower(out)
