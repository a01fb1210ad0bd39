"""Mesh-sharded MSM: points and scalars split over a mesh axis, one local
MSM a rank, and the per-rank partial points summed (counterpart of
gnark_tpu/parallel/sharded_msm.py).

The reference's NbTasks decomposition (gnark-crypto MultiExpConfig{NbTasks},
internal/backend/bn254/groth16/prove.go:155-241) splits Pippenger's
windows over goroutines; here the point vector is split over the ranks of
one mesh axis, every rank runs the port's own plan on its slice (``msm``'s
rule: the ladder below LADDER_MAX points, the windowed plan from there),
and the tiny per-rank partials are all-gathered over the axis's process
group and summed by the ``reduce`` kernel, the port's counterpart of the
XLA ``_reduce`` that the reference folds them with.  The cross-rank
traffic is one point a rank.

The contract is SPMD with the full arrays: every rank is given the same
[L, n] coordinates, [n] mask and [Ls, n] scalars and takes its contiguous
n / ndev slice (the reference's ``P(None, axis)``); every rank returns the
same point.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.msm import complete_ops, msm, reduce, split_points


def to_projective(GC, P):
    """Jacobian (X, Y, Z) -> complete projective (XZ, Y, Z^3), the same
    affine point; the identity (Z = 0, which the MSM leaves as (0 : 0 : 0))
    becomes the class (0 : 1 : 0) that the complete formulas need."""
    F = GC.F
    X, Y, Z = P
    proj = (F.mul(X, Z), Y, F.mul(F.sqr(Z), Z))
    return GC.mask_inf(proj, ~F.is_zero(Z))


class ShardedMSM:
    """An MSM plan sharded over one mesh axis.  Each rank's slice goes
    through ``ops.msm.msm`` (its rule and its cached windowed plans); the
    reference's ``c``, ``lanes``, ``signed`` and ``method`` knobs are not
    taken, as ``msm`` takes none of them."""

    def __init__(self, G: CurveOps, mesh, axis: str, n: int,
                 scalar_limbs: int):
        self.G = G
        self.GC = complete_ops(G)
        self.group = mesh.get_group(axis)
        ndev = self.group.size()
        assert n % ndev == 0, f"n={n} not divisible by mesh axis {ndev}"
        self.n = n
        self.ndev = ndev
        self.scalar_limbs = scalar_limbs
        k = n // ndev
        d = mesh.get_local_rank(axis)
        self.shard = slice(d * k, (d + 1) * k)

    def __call__(self, xs, ys, inf_mask, scalars):
        """Same contract as ops.msm.msm: affine Montgomery coordinates
        [L, n], inf [n], regular-form scalars [Ls, n] -> one Jacobian
        point (coordinates [L, 1])."""
        assert xs.shape[-1] == self.n, (xs.shape, self.n)
        assert scalars.shape[0] == self.scalar_limbs, scalars.shape
        s = self.shard
        partial = msm(self.G, xs[:, s], ys[:, s], inf_mask[s], scalars[:, s])
        mine = torch.cat(to_projective(self.GC, partial)).contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.ndev)]
        dist.all_gather(parts, mine, group=self.group)
        gathered = torch.stack(parts, -1)           # [3L, 1, ndev]
        total = reduce(gathered, self.GC)           # [3L, 1]
        return self.GC.to_jacobian(split_points(total, self.G.F.L))


def sharded_msm(G: CurveOps, mesh, axis: str, xs, ys, inf_mask, scalars):
    plan = ShardedMSM(G, mesh, axis, xs.shape[-1], scalars.shape[0])
    return plan(xs, ys, inf_mask, scalars)
