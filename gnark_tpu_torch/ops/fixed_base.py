"""Batch fixed-base scalar multiplication (counterpart of
gnark_tpu/ops/fixed_base.py::FixedBaseTable, whose scan is XLA there),
with its scan in CUDA.

The per-window multiples of the base are a small host-computed table; on
the device each scalar becomes nwin digit gathers from the table plus an
nwin-step loop of mixed adds:

    result_j = sum_w table[w][digit_w(s_j)],   table[w][d] = d * 2^(cw) * G

``fixed_base`` launches csrc/msm_kernels.cu's fixed_base_kernel (over fp4
fixed_base_sliced_kernel) on CUDA tensors and runs ``fixed_base_plain``
on CPU tensors; any other device raises, and there is no fallback from
the kernel to the plain version.  The adds are the complete projective
ones (ec_complete.py, alg 8: no doubling for the P == Q case, no
selects), about two thirds of the Jacobian mixed addition's products;
the sum is returned as a Jacobian batch, the same points.
"""

from __future__ import annotations

import torch

from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.msm import (
    _count_plain, _device_route, complete_ops, split_points, window_digits)


def point_major(tx, ty, tinf):
    """The kernel's copy of a table ([nwin, L, 2^c] coordinates, [nwin,
    2^c] flags): int32 [nwin, 2^c, E], entry (w, d) as x's 32-bit words
    (limbs 2i and 2i + 1 in word i), y's words, the infinity flag and
    zeros up to E = _cuda.entry_words(L) words."""
    nwin, L, m = tx.shape
    out = torch.zeros((nwin, m, _cuda.entry_words(L)), dtype=torch.int64,
                      device=tx.device)
    for k, t in enumerate((tx, ty)):
        out[..., k * L // 2:(k + 1) * L // 2] = (
            t[:, 0::2] | t[:, 1::2] << 16).transpose(1, 2)
    out[..., L] = tinf.to(torch.int64)
    return (out - (out >> 31 << 32)).to(torch.int32)   # two's complement


class FixedBaseTable:
    """Window table for one base point, held on ``device``."""

    def __init__(self, G: CurveOps, host_curve, base, scalar_bits: int,
                 device, c: int = 8):
        """base: host affine point; coordinates are packed with G.F.pack."""
        self.G = G
        self.c = c
        self.nwin = -(-scalar_bits // c)
        rows_x, rows_y, rows_inf = [], [], []
        step = base
        zero = host_curve.F.zero
        for _ in range(self.nwin):
            # row: 0 (infinity sentinel), step, 2*step, ..., (2^c - 1)*step
            pts = [None, step]
            for _ in range(2, 1 << c):
                pts.append(host_curve.add(pts[-1], step))
            rows_x.append([zero if p is None else p[0] for p in pts])
            rows_y.append([zero if p is None else p[1] for p in pts])
            rows_inf.append([p is None for p in pts])
            for _ in range(c):
                step = host_curve.double(step)
        # [nwin, L, 2^c] coordinates and [nwin, 2^c] infinity flags (the
        # plain version's), and on the card the kernel's point-major copy
        self.tx = torch.stack([G.F.pack(r, device) for r in rows_x])
        self.ty = torch.stack([G.F.pack(r, device) for r in rows_y])
        self.tinf = torch.tensor(rows_inf, device=device)
        self.points = (point_major(self.tx, self.ty, self.tinf)
                       if self.tx.is_cuda else None)

    def __call__(self, scalars):
        """scalars: [Ls, n] regular-form limb planes -> Jacobian batch."""
        return split_points(fixed_base(self, scalars), self.G.F.L)


def fixed_base_plain(table: FixedBaseTable, scalars):
    """[3L, n]: column j = sum_w table[w][digit_w(s_j)], Jacobian, X over
    Y over Z; scalars [Ls, n] regular-form limb planes.  A loop of batched
    complete mixed additions over every column, window by window."""
    _count_plain(scalars, "fixed_base")
    GC = complete_ops(table.G)
    n = scalars.shape[-1]
    digits = window_digits(scalars, table.c)[:table.nwin]   # [nwin, n]
    acc = GC.inf(n, scalars.device)
    for w in range(table.nwin):
        d = digits[w]
        acc = GC.add_mixed(acc, (table.tx[w][:, d], table.ty[w][:, d]),
                           table.tinf[w][d])
    return torch.cat(GC.to_jacobian(acc))


def fixed_base(table: FixedBaseTable, scalars):
    """fixed_base_plain's [3L, n] batch: the kernel on CUDA tensors (one
    launch; the scalars made contiguous, as setup's slices of its planes
    may not be), the plain version on CPU tensors; raises on any other
    device."""
    if _device_route(scalars, "fixed_base"):
        return _cuda.fixed_base(scalars.contiguous(), table.points, table.c,
                                _cuda.kind_of(table.G))
    return fixed_base_plain(table, scalars)


def batch_scalar_mul(G: CurveOps, host_curve, base, scalars, c: int = 8):
    """One-shot batch s_j * base (gnark_tpu's batch_scalar_mul): a table of
    ``c``-bit windows for the scalars' full width, on the scalars'
    device.  scalars: [Ls, n] regular-form limb planes -> Jacobian batch."""
    table = FixedBaseTable(G, host_curve, base, scalars.shape[0] * 16,
                           scalars.device, c)
    return table(scalars)
