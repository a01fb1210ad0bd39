"""Radix-2 NTT over fr limb planes (counterpart of
gnark_tpu/ops/ntt.py::Domain, whose ``_dispatch`` jits each whole
transform, ``_transform``, into one XLA program).

DIF consumes natural order and produces bit-reversed order; DIT consumes
bit-reversed and produces natural, so the Groth16 quotient chains
DIF -> DIT without a permutation.

Every transform routes by device, as ops/msm.py's kernels do: on CUDA
tensors one call of _cuda.ntt_transform, which launches csrc/
ntt_kernels.cu's ``ntt_stage_kernel`` once a butterfly stage (the coset
pre-scale fused into the first stage, the n^-1 / inverse-coset
post-scale into the last, one scaling launch at n = 1), on CPU tensors
the plain version,
``Domain.transform_plain``: each stage one reshape [L, blocks, 2, half]
and one vectorized add/sub/mul over the whole array.  ``fr_pointwise``,
the Groth16 quotient's (a b - c) d, routes the same way.  Any other device
raises; nothing on the card falls back to the plain version.
``plain_on_cuda`` counts plain versions run on CUDA tensors (by a
comparison, never by a transform).
"""

from __future__ import annotations

import numpy as np
import torch

from gnark_tpu_torch.fields.spec import FieldSpec
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops.limbs import field_ops
from gnark_tpu_torch.ops.msm import _device_route

plain_on_cuda = dict.fromkeys(_cuda.NTT_KERNELS, 0)


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

    def operands(self, inverse: bool, order: str, coset: bool):
        """(twiddles, pre-scale, post-scale) of one transform: the coset
        powers before a forward coset transform, n^-1 (times the inverse
        coset powers) after an inverse one."""
        if not inverse:
            pre = None
            if coset:
                pre = self.table("coset" if order == "DIF" else "coset_brev")
            return self.table("tw"), pre, None
        if coset:
            post = self.table(
                "icoset_ninv_brev" if order == "DIF" else "icoset_ninv")
        else:
            post = self.F.pack([self.n_inv], self.device)
        return self.table("itw"), None, post

    def fft(self, x, order: str = "DIF", coset: bool = False):
        """Forward NTT.  DIF: natural coeffs -> bit-reversed evals;
        DIT: bit-reversed coeffs -> natural evals."""
        return self._transform(x, *self.operands(False, order, coset), order)

    def ifft(self, x, order: str = "DIF", coset: bool = False):
        """Inverse NTT (scaled by 1/n).  DIF: natural evals -> bit-reversed
        coeffs; DIT: bit-reversed evals -> natural coeffs."""
        return self._transform(x, *self.operands(True, order, coset), order)

    def _transform(self, x, tw, pre, post, order):
        if _device_route(x, "ntt"):
            return self.transform_kernel(x, tw, pre, post, order)
        return self.transform_plain(x, tw, pre, post, order)

    def transform_kernel(self, x, tw, pre, post, order):
        """The kernel route: one _cuda.ntt_transform call."""
        assert x.shape == (self.spec.L, self.n), (x.shape, self.n)
        return _cuda.ntt_transform(
            x.contiguous(), tw.contiguous(),
            None if pre is None else pre.contiguous(),
            None if post is None else post.contiguous(), order == "DIT",
            _cuda.fr_kind(self.spec))

    def transform_plain(self, x, tw, pre, post, order):
        """The plain version: the stages as torch ops on the whole array."""
        if x.is_cuda:
            plain_on_cuda["ntt"] += 1
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


def fr_pointwise_plain(F, a, b, c, d):
    """(a b - c) d over limb planes; d may be one value ([L, 1])."""
    if a.is_cuda:
        plain_on_cuda["fr_pointwise"] += 1
    return F.mul(F.sub(F.mul(a, b), c), d)


def fr_pointwise(spec: FieldSpec, a, b, c, d):
    """The Groth16 quotient's pointwise step (a b - c) d over ``spec``: one
    launch of csrc/ntt_kernels.cu's fr_pointwise_kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _device_route(a, "fr_pointwise"):
        return _cuda.fr_pointwise(a.contiguous(), b.contiguous(),
                                  c.contiguous(), d.contiguous(),
                                  _cuda.fr_kind(spec))
    return fr_pointwise_plain(field_ops(spec), a, b, c, d)
