"""Radix-2 NTT over fr limb planes, in plain PyTorch (counterpart of
gnark_tpu/ops/ntt.py::Domain, which is XLA there too).

DIF consumes natural order and produces bit-reversed order; DIT consumes
bit-reversed and produces natural, so the Groth16 quotient chains
DIF -> DIT without a permutation.  Each butterfly stage is one reshape
[L, blocks, 2, half] and one vectorized add/sub/mul over the whole array.
"""

from __future__ import annotations

import numpy as np
import torch

from gnark_tpu_torch.fields.spec import FieldSpec
from gnark_tpu_torch.ops.limbs import field_ops


def bit_reverse_perm(n: int) -> np.ndarray:
    """Permutation idx such that x[idx] is the bit-reversal reordering
    (copy of gnark_tpu.ops.ntt.bit_reverse_perm)."""
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class Domain:
    """Evaluation domain of size n (a power of two) over a scalar field,
    with its twiddle and coset tables on ``device``.  The coset generator
    is the field's multiplicative generator, as in gnark_tpu."""

    def __init__(self, spec: FieldSpec, n: int, device):
        assert n > 0 and n & (n - 1) == 0, "domain size must be a power of two"
        self.spec = spec
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = torch.device(device)
        self.F = field_ops(spec)
        p = spec.modulus
        self.omega = spec.root_of_unity(n)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(n, -1, p)
        self.coset_gen = spec.multiplicative_generator % p
        self.coset_gen_inv = pow(self.coset_gen, -1, p)
        self._tables = {}

    def _powers(self, base: int, n: int):
        """[L, n] Montgomery planes of 1, base, ..., base^(n-1)."""
        F, p = self.F, self.spec.modulus
        out = F.ones(1, self.device)
        k = 1
        while k < n:
            step = F.pack([pow(base, k, p)], self.device)
            out = torch.cat([out, F.mul(out, step)], dim=1)
            k *= 2
        return out[:, :n]

    def table(self, name: str):
        if name in self._tables:
            return self._tables[name]
        brev = torch.from_numpy(
            bit_reverse_perm(self.n).astype(np.int64)).to(self.device)
        if name == "tw":
            t = self._powers(self.omega, self.n // 2)
        elif name == "itw":
            t = self._powers(self.omega_inv, self.n // 2)
        elif name == "coset":
            t = self._powers(self.coset_gen, self.n)
        elif name == "coset_brev":
            t = self.table("coset")[:, brev]
        elif name == "icoset_ninv":
            # g^-j * n^-1: fused post-scale of the inverse coset transform
            t = self.F.mul(self._powers(self.coset_gen_inv, self.n),
                           self.F.pack([self.n_inv], self.device))
        elif name == "icoset_ninv_brev":
            t = self.table("icoset_ninv")[:, brev]
        else:
            raise KeyError(name)
        self._tables[name] = t
        return t

    def fft(self, x, order: str = "DIF", coset: bool = False):
        """Forward NTT.  DIF: natural coeffs -> bit-reversed evals;
        DIT: bit-reversed coeffs -> natural evals."""
        pre = None
        if coset:
            pre = self.table("coset" if order == "DIF" else "coset_brev")
        return self._transform(x, self.table("tw"), pre, None, order)

    def ifft(self, x, order: str = "DIF", coset: bool = False):
        """Inverse NTT (scaled by 1/n).  DIF: natural evals -> bit-reversed
        coeffs; DIT: bit-reversed evals -> natural coeffs."""
        if coset:
            post = self.table(
                "icoset_ninv_brev" if order == "DIF" else "icoset_ninv")
        else:
            post = self.F.pack([self.n_inv], self.device)
        return self._transform(x, self.table("itw"), None, post, order)

    def _transform(self, x, tw, pre, post, order):
        F, k, n, L = self.F, self.log_n, self.n, self.spec.L
        assert x.shape == (L, n), (x.shape, n)
        if pre is not None:
            x = F.mul(x, pre)
        stages = range(k) if order == "DIF" else range(k - 1, -1, -1)
        for s in stages:
            blocks = 1 << s
            half = n >> (s + 1)
            w = tw[:, ::blocks].unsqueeze(1)          # [L, 1, half]
            xs = x.reshape(L, blocks, 2, half)
            a, b = xs[:, :, 0], xs[:, :, 1]
            if order == "DIF":
                u = F.add(a, b)
                v = F.mul(F.sub(a, b), w)
            else:
                bw = F.mul(b, w)
                u = F.add(a, bw)
                v = F.sub(a, bw)
            x = torch.stack([u, v], dim=2).reshape(L, n)
        if post is not None:
            x = F.mul(x, post)
        return x
