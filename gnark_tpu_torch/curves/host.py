"""Host-side (python-int) field and curve arithmetic.

This is the exact-arithmetic oracle (the analog of the reference's
big.Int test engine, test/engine.go:44) and the engine for small host-side
work: generator tables, proof assembly, verification-side pairings.
Performance-critical bulk work lives in ops/ (device kernels) instead.
"""

from __future__ import annotations



class HostFp:
    """Prime field on python ints."""

    def __init__(self, p: int):
        self.p = p
        self.zero = 0
        self.one = 1

    def add(self, a, b): return (a + b) % self.p
    def sub(self, a, b): return (a - b) % self.p
    def neg(self, a): return (-a) % self.p
    def mul(self, a, b): return a * b % self.p
    def sqr(self, a): return a * a % self.p
    def inv(self, a): return pow(a, -1, self.p) if a else 0
    def is_zero(self, a): return a == 0
    def eq(self, a, b): return a == b
    def from_int(self, v): return v % self.p


class HostFp2:
    """fp2 = fp[u]/(u^2 - beta) on pairs of python ints."""

    def __init__(self, p: int, beta: int):
        self.p = p
        self.beta = beta % p
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b): return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)
    def sub(self, a, b): return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)
    def neg(self, a): return ((-a[0]) % self.p, (-a[1]) % self.p)

    def mul(self, a, b):
        p, beta = self.p, self.beta
        v0 = a[0] * b[0] % p
        v1 = a[1] * b[1] % p
        c0 = (v0 + beta * v1) % p
        c1 = ((a[0] + a[1]) * (b[0] + b[1]) - v0 - v1) % p
        return (c0, c1)

    def sqr(self, a): return self.mul(a, a)

    def inv(self, a):
        p, beta = self.p, self.beta
        norm = (a[0] * a[0] - beta * a[1] * a[1]) % p
        ninv = pow(norm, -1, p)
        return (a[0] * ninv % p, (-a[1]) * ninv % p)

    def is_zero(self, a): return a == (0, 0)
    def eq(self, a, b): return a == b
    def from_int(self, v): return (v % self.p, 0)


class HostCurve:
    """Affine-coordinate group ops over any host field (a = 0 curves).

    Points are (x, y) tuples; None is infinity.
    """

    def __init__(self, field, b):
        self.F = field
        self.b = b

    def is_on_curve(self, P):
        if P is None:
            return True
        F = self.F
        x, y = P
        return F.eq(F.sqr(y), F.add(F.mul(F.sqr(x), x), self.b))

    def neg(self, P):
        return None if P is None else (P[0], self.F.neg(P[1]))

    def add(self, P, Q):
        F = self.F
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if F.eq(x1, x2):
            if F.eq(y1, y2):
                if F.is_zero(y1):
                    return None
                lam = F.mul(F.add(F.add(F.sqr(x1), F.sqr(x1)), F.sqr(x1)),
                            F.inv(F.add(y1, y1)))
            else:
                return None
        else:
            lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, P):
        return self.add(P, P)

    def scalar_mul(self, P, k: int):
        if k < 0:
            return self.neg(self.scalar_mul(P, -k))
        R = None
        Q = P
        while k:
            if k & 1:
                R = self.add(R, Q)
            Q = self.double(Q)
            k >>= 1
        return R

    def msm(self, points, scalars):
        acc = None
        for P, s in zip(points, scalars):
            acc = self.add(acc, self.scalar_mul(P, s))
        return acc


class HostFpK:
    """fp^k = fp[u]/(u^k - c): k-tuples of python ints (binomial
    extension; used for BLS24's fp4 G2 coordinate field — reference
    gnark-crypto E4; here one generic quartic/sextic tower node)."""

    def __init__(self, p: int, k: int, c: int):
        self.p = p
        self.k = k
        self.c = c % p
        self.zero = (0,) * k
        self.one = (1,) + (0,) * (k - 1)

    def add(self, a, b):
        p = self.p
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub(self, a, b):
        p = self.p
        return tuple((x - y) % p for x, y in zip(a, b))

    def neg(self, a):
        p = self.p
        return tuple((-x) % p for x in a)

    def mul(self, a, b):
        p, k, c = self.p, self.k, self.c
        t = [0] * (2 * k - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    if bj:
                        t[i + j] += ai * bj
        out = list(t[:k])
        for m in range(k, 2 * k - 1):
            out[m - k] += t[m] * c
        return tuple(v % p for v in out)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """Extended-Euclid on polynomials over fp."""
        p, k, c = self.p, self.k, self.c
        A = list(a) + [0]
        B = [(-c) % p] + [0] * (k - 1) + [1]
        u = [1] + [0] * k
        v = [0] * (k + 1)

        def deg(f):
            for i in range(len(f) - 1, -1, -1):
                if f[i] % p:
                    return i
            return -1

        while True:
            da, db = deg(A), deg(B)
            if da < 0:
                A, B, u, v = B, A, v, u
                da, db = deg(A), deg(B)
            if da == 0:
                break
            if da < db:
                A, B, u, v = B, A, v, u
                da, db = db, da
            lead = A[da] * pow(B[db], -1, p) % p
            sh = da - db
            for i in range(db + 1):
                A[i + sh] = (A[i + sh] - lead * B[i]) % p
            for i in range(k + 1 - sh):
                u[i + sh] = (u[i + sh] - lead * v[i]) % p
        cinv = pow(A[0], -1, p)
        return tuple(x * cinv % p for x in u[:k])

    def is_zero(self, a):
        return all(x % self.p == 0 for x in a)

    def eq(self, a, b):
        return all((x - y) % self.p == 0 for x, y in zip(a, b))

    def from_int(self, v):
        return (v % self.p,) + (0,) * (self.k - 1)
