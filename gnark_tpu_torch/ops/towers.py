"""Extension field ops on limb planes (counterpart of
gnark_tpu/ops/towers.py::Fp2Ops and FpKOps).

An fp2 element batch is an ``int64[2L, ...]`` tensor: c0 limbs stacked over
c1 limbs (element = c0 + u*c1, u^2 = beta).  An fp^k element batch is
``int64[kL, ...]``, coefficient i of u^i at rows iL .. (i+1)L - 1 (u^k = c;
BLS24-315's G2 lives over fp4 with c = 13).  Same ops protocol as
FieldOps, so ec.py and ec_complete.py run unchanged over G1 and G2.
Every operation ends canonical, so any formula for a product gives the
same limbs.
"""

from __future__ import annotations

import functools

import torch

from gnark_tpu_torch.fields.spec import FieldSpec
from gnark_tpu_torch.ops.limbs import FieldOps, field_ops


class Fp2Ops:
    """fp2 = fp[u]/(u^2 - beta) for a small signed non-residue beta (-1 for
    BN254 and BLS12-381, -5 for BLS12-377)."""

    def __init__(self, base: FieldOps, beta: int):
        if not 1 <= abs(beta) < (1 << 12):
            raise ValueError(f"fp2 needs a small nonzero beta, got {beta}")
        self.base = base
        self.beta = beta
        self.L = 2 * base.L

    def _split(self, a):
        Lb = self.base.L
        return a[:Lb], a[Lb:]

    def _join(self, c0, c1):
        return torch.cat([c0, c1], dim=0)

    # -- constructors ------------------------------------------------------

    def zeros(self, n, device):
        shape = (n,) if isinstance(n, int) else tuple(n)
        return torch.zeros((self.L,) + shape, dtype=torch.int64,
                           device=device)

    def ones(self, n, device):
        return self._join(self.base.ones(n, device),
                          self.base.zeros(n, device))

    def ones_like(self, a):
        c0, c1 = self._split(a)
        return self._join(self.base.ones_like(c0), torch.zeros_like(c1))

    def pack(self, pairs, device):
        """[(c0, c1), ...] host ints -> [2L, n] Montgomery limb planes."""
        pairs = list(pairs)
        return self._join(self.base.pack([x for x, _ in pairs], device),
                          self.base.pack([y for _, y in pairs], device))

    def unpack(self, arr):
        Lb = self.base.L
        return list(zip(self.base.unpack(arr[:Lb]),
                        self.base.unpack(arr[Lb:])))

    # -- arithmetic --------------------------------------------------------
    # c0 and c1 go through the base field as one batch: the halves are
    # concatenated along the last axis, which halves the op count.

    def _pair(self, fn, a, b):
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        r = fn(torch.cat([a0, a1], -1), torch.cat([b0, b1], -1))
        n = a0.shape[-1]
        return self._join(r[..., :n], r[..., n:])

    def add(self, a, b):
        return self._pair(self.base.add, a, b)

    def sub(self, a, b):
        return self._pair(self.base.sub, a, b)

    def neg(self, a):
        a0, a1 = self._split(a)
        r = self.base.neg(torch.cat([a0, a1], -1))
        n = a0.shape[-1]
        return self._join(r[..., :n], r[..., n:])

    def double(self, a):
        return self.add(a, a)

    def _mul_beta(self, x):
        """x * beta, by a small-constant product (gnark_tpu's addition
        chain gives the same canonical value)."""
        F = self.base
        r = F.mul_small(x, abs(self.beta))
        return F.neg(r) if self.beta < 0 else r

    def mul(self, a, b):
        """Karatsuba, as gnark_tpu's Fp2Ops.mul: the three base products
        run as one batch."""
        F = self.base
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        n = a0.shape[-1]
        v = F.mul(torch.cat([a0, a1, F.add(a0, a1)], -1),
                  torch.cat([b0, b1, F.add(b0, b1)], -1))
        v0, v1, s = v[..., :n], v[..., n:2 * n], v[..., 2 * n:]
        c0 = F.add(v0, self._mul_beta(v1))
        c1 = F.sub(F.sub(s, v0), v1)
        return self._join(c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """(c0 - u c1) / (c0^2 - beta c1^2); the norms of a [2L, n] batch
        are inverted with one batch inversion (0 maps to 0)."""
        F = self.base
        a0, a1 = self._split(a)
        norm = F.sub(F.sqr(a0), self._mul_beta(F.sqr(a1)))
        shape = norm.shape
        ninv = F.batch_inv(norm.reshape(F.L, -1)).reshape(shape)
        return self._join(F.mul(a0, ninv), F.neg(F.mul(a1, ninv)))

    # -- predicates --------------------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(0)

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(0), a, b)


@functools.lru_cache(maxsize=None)
def fp2_ops(spec: FieldSpec, beta: int) -> Fp2Ops:
    return Fp2Ops(field_ops(spec), beta)


class FpKOps:
    """fp^k = fp[u]/(u^k - c), k-tuples of base elements stacked into
    [kL, ...] planes (gnark_tpu/ops/towers.py::FpKOps).  The k^2 base
    products of a product run as one batch along the last axis; the
    inverse of k = 4 goes down the tower fp4 = fp2[u]/(u^2 - v), fp2 =
    fp[v]/(v^2 - c) to one batch inversion in fp (gnark_tpu exponentiates
    by q + q^2 + q^3: the inverse is one value, so both give the same
    limbs)."""

    def __init__(self, base: FieldOps, k: int, c: int):
        if k < 2 or not 1 <= abs(c) < (1 << 12):
            raise ValueError(f"fp^k needs k >= 2 and a small c, got {k}, {c}")
        self.base = base
        self.k = k
        self.c = c
        self.L = k * base.L

    def _split(self, a):
        Lb = self.base.L
        return [a[i * Lb:(i + 1) * Lb] for i in range(self.k)]

    def _join(self, parts):
        return torch.cat(parts, dim=0)

    def _batched(self, fn, *groups):
        """fn over several lists of same-shape base operands at once: the
        i-th entries of each list are concatenated along the last axis,
        one call, and split back."""
        n = groups[0][0].shape[-1]
        r = fn(*(torch.cat(g, -1) for g in groups))
        return [r[..., i * n:(i + 1) * n] for i in range(len(groups[0]))]

    # -- constructors ------------------------------------------------------

    def zeros(self, n, device):
        shape = (n,) if isinstance(n, int) else tuple(n)
        return torch.zeros((self.L,) + shape, dtype=torch.int64,
                           device=device)

    def ones(self, n, device):
        F = self.base
        return self._join([F.ones(n, device)]
                          + [F.zeros(n, device)] * (self.k - 1))

    def ones_like(self, a):
        c0 = self._split(a)[0]
        return self._join([self.base.ones_like(c0)]
                          + [torch.zeros_like(c0)] * (self.k - 1))

    def pack(self, tuples, device):
        """[(c0, .., c_{k-1}), ...] host ints -> [kL, n] Montgomery planes."""
        tuples = list(tuples)
        return self._join([self.base.pack([t[i] for t in tuples], device)
                           for i in range(self.k)])

    def unpack(self, arr):
        return list(zip(*(self.base.unpack(p) for p in self._split(arr))))

    # -- arithmetic --------------------------------------------------------

    def _each(self, fn, *xs):
        xs = torch.broadcast_tensors(*xs)
        return self._join(self._batched(fn, *(self._split(x) for x in xs)))

    def add(self, a, b):
        return self._each(self.base.add, a, b)

    def sub(self, a, b):
        return self._each(self.base.sub, a, b)

    def neg(self, a):
        return self._each(self.base.neg, a)

    def double(self, a):
        return self.add(a, a)

    def _mul_c(self, xs):
        """[x * c for x in xs] in one small-constant product."""
        F = self.base
        r = self._batched(lambda t: F.mul_small(t, abs(self.c)), xs)
        return self._batched(F.neg, r) if self.c < 0 else r

    def mul(self, a, b):
        """Schoolbook, as gnark_tpu's FpKOps.mul: the k^2 base products
        in one batch, the columns i + j = m summed, then column k + m
        times c added to column m."""
        F, k = self.base, self.k
        a, b = torch.broadcast_tensors(a, b)
        A, B = self._split(a), self._split(b)
        t = self._batched(F.mul, [A[i] for i in range(k) for _ in range(k)],
                          [B[j] for _ in range(k) for j in range(k)])
        terms = [[t[i * k + m - i] for i in range(max(0, m - k + 1),
                                                  min(m, k - 1) + 1)]
                 for m in range(2 * k - 1)]
        cols = [ts[0] for ts in terms]
        for r in range(1, k):                  # one batched add a round
            ms = [m for m in range(2 * k - 1) if len(terms[m]) > r]
            sums = self._batched(F.add, [cols[m] for m in ms],
                                 [terms[m][r] for m in ms])
            for m, v in zip(ms, sums):
                cols[m] = v
        high = self._mul_c(cols[k:])
        low = self._batched(F.add, cols[:k - 1], high)
        return self._join(low + [cols[k - 1]])

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """a^-1 for k = 4 (0 maps to 0): with v = u^2 (v^2 = c), a = A0 +
        A1 u over fp2 = fp[v], A0 = a0 + a2 v, A1 = a1 + a3 v; a^-1 = (A0 -
        A1 u) / N with N = A0^2 - v A1^2, and N^-1 = (n0 - n1 v) / (n0^2 -
        c n1^2), one batch inversion in fp."""
        if self.k != 4:
            raise NotImplementedError(f"fp^{self.k} inverse")
        F = self.base
        a0, a1, a2, a3 = self._split(a)

        def fp2_mul(x, y):                     # lists of (c0, c1) pairs
            p = self._batched(F.mul, [u for u, _ in x] + [w for _, w in x],
                              [u for u, _ in y] + [w for _, w in y])
            s = self._batched(F.mul, [F.add(u, w) for u, w in x],
                              [F.add(u, w) for u, w in y])
            m = len(x)
            c_hi = self._mul_c(p[m:])
            return [(F.add(p[i], c_hi[i]), F.sub(F.sub(s[i], p[i]), p[m + i]))
                    for i in range(m)]

        (s0,), (s1,) = fp2_mul([(a0, a2)], [(a0, a2)]), fp2_mul([(a1, a3)],
                                                             [(a1, a3)])
        # N = A0^2 - v A1^2, v (x + y v) = c y + x v
        n0 = F.sub(s0[0], self._mul_c([s1[1]])[0])
        n1 = F.sub(s0[1], s1[0])
        n00, n11 = self._batched(F.mul, [n0, n1], [n0, n1])
        d = F.sub(n00, self._mul_c([n11])[0])
        shape = d.shape
        dinv = F.batch_inv(d.reshape(F.L, -1)).reshape(shape)
        m0, m1 = self._batched(F.mul, [n0, n1], [dinv, dinv])
        ninv = (m0, F.neg(m1))
        (r0, r2), (q1, q3) = fp2_mul([(a0, a2), (a1, a3)], [ninv, ninv])
        return self._join([r0, F.neg(q1), r2, F.neg(q3)])

    # -- predicates --------------------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(0)

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(0), a, b)


@functools.lru_cache(maxsize=None)
def fpk_ops(spec: FieldSpec, k: int, c: int) -> FpKOps:
    return FpKOps(field_ops(spec), k, c)
