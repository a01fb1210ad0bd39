"""Batch fixed-base scalar multiplication in plain PyTorch (counterpart of
gnark_tpu/ops/fixed_base.py::FixedBaseTable, which is XLA there too).

The per-window multiples of the base are a small host-computed table; on
the device each scalar becomes nwin digit gathers from the table plus an
nwin-step loop of mixed adds:

    result_j = sum_w table[w][digit_w(s_j)],   table[w][d] = d * 2^(cw) * G

The adds are the complete projective ones (ec_complete.py, alg 8: no
doubling for the P == Q case, no selects), about two thirds of the
Jacobian mixed addition's products; the sum is returned as a Jacobian
batch, the same points.
"""

from __future__ import annotations

import torch

from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.msm import complete_ops, window_digits


# A table entry (a host point addition) costs about as much as 60-100
# columns of a window on the card: BN254's two tables at c = 8 (16,320
# entries) took 0.69 s on an H100's host, a window 0.24 us a G1 and 0.97
# us a G2 column at 2^21 points (chip_smoke.py phase 14)
ENTRY_COLUMNS = 85


def window_width(n: int, scalar_bits: int) -> int:
    """The window width c in 8..13 that makes an n-point batch cheapest:
    nwin(c) windows of n columns each, and nwin(c) 2^c host table
    entries.  8 below about 2^17 points, 12 at 2^21."""
    return min(range(8, 14), key=lambda c: -(-scalar_bits // c) * (
        n + ENTRY_COLUMNS * (1 << c)))


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
        GC = complete_ops(self.G)
        n = scalars.shape[-1]
        digits = window_digits(scalars, self.c)[:self.nwin]   # [nwin, n]
        acc = GC.inf(n, scalars.device)
        for w in range(self.nwin):
            d = digits[w]
            acc = GC.add_mixed(acc, (self.tx[w][:, d], self.ty[w][:, d]),
                               self.tinf[w][d])
        return GC.to_jacobian(acc)
