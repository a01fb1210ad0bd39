"""Batch fixed-base scalar multiplication in plain PyTorch (counterpart of
gnark_tpu/ops/fixed_base.py::FixedBaseTable, which is XLA there too).

The per-window multiples of the base are a small host-computed table; on
the device each scalar becomes nwin digit gathers from the table plus an
nwin-step loop of mixed adds:

    result_j = sum_w table[w][digit_w(s_j)],   table[w][d] = d * 2^(cw) * G
"""

from __future__ import annotations

import torch

from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.msm import window_digits


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
        # [nwin, L, 2^c] coordinates and [nwin, 2^c] infinity flags
        self.tx = torch.stack([G.F.pack(r, device) for r in rows_x])
        self.ty = torch.stack([G.F.pack(r, device) for r in rows_y])
        self.tinf = torch.tensor(rows_inf, device=device)

    def __call__(self, scalars):
        """scalars: [Ls, n] regular-form limb planes -> Jacobian batch."""
        G = self.G
        n = scalars.shape[-1]
        digits = window_digits(scalars, self.c)[:self.nwin]   # [nwin, n]
        acc = G.inf(n, scalars.device)
        for w in range(self.nwin):
            d = digits[w]
            acc = G.add_mixed(acc, (self.tx[w][:, d], self.ty[w][:, d]),
                              self.tinf[w][d])
        return acc
