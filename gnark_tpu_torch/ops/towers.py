"""Quadratic extension field ops on limb planes (counterpart of
gnark_tpu/ops/towers.py::Fp2Ops; ``FpKOps`` is not ported yet).

An fp2 element batch is an ``int64[2L, ...]`` tensor: c0 limbs stacked over
c1 limbs (element = c0 + u*c1, u^2 = beta).  Same ops protocol as
FieldOps, so ec.py and ec_complete.py run unchanged over G1 and G2.
"""

from __future__ import annotations

import functools

import torch

from gnark_tpu_torch.fields.spec import FieldSpec
from gnark_tpu_torch.ops.limbs import FieldOps, field_ops


class Fp2Ops:
    """fp2 = fp[u]/(u^2 - beta); only BN254's beta = -1 is ported."""

    def __init__(self, base: FieldOps, beta: int):
        if beta != -1:
            raise NotImplementedError(f"fp2 with beta={beta}")
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
        """x * beta = -x."""
        return self.base.neg(x)

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
