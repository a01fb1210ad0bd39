"""gnark_tpu_torch on a CUDA card (marker ``cuda``; every test skips
without a card).

The file imports no jax, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which imports jax.)

  * the weighted sum at the 2^16 plan's 24 windows of 1,024 buckets, at
    2 buckets, and with nine windows in ten all the identity;
  * the lane offsets at the 2^16 plan's lane totals (24 windows of 512
    lanes) and at their first 1, 2 and 8 lanes;
  * the bucket step at the 4,096-point plan with edge digits (no digit
    0, all digits 0, the largest digit at the last index, a boundary at a
    lane's last step, empty buckets), G1 and G2 of both curves, BLS24-315
    G2's launched twice;
  * each of the five windowed-MSM kernels (the fold in the Jacobian
    form), the ladder kernel, the
    per-chunk reduction kernel and the fold of the chunk sums against its
    plain version on the same CUDA tensors, G1 and G2, bit for bit, one
    launch each: at the small proof's 4096 points (the four windowed
    kernels also at the rollup's plan, 32,768 points: c = 10, 512
    buckets, C = 64), at 37 points (a
    ragged last block), with 64-bit scalars (a window a chunk) and with
    20-bit scalars (the fold of the chunk sums starts at chunk 1); the G1
    leaf and BLS24-315's fp4 leaf also at a PLONK commitment's 2^16 + 3
    points (C = 129);
  * the kernel-path MSM, through ``msm`` (the ladder at this size) and
    through the windowed plan, against the host oracle (point
    i = 2^(i mod 64) G);
  * setup and prove on the card give the same key and proof as on the CPU
    for the same rng, and the proof verifies;
  * every op of the integer-multiply microbenchmark kernel against its
    plain version on the same CUDA tensors, one launch each;
  * PLONK setup and prove on the card give the host mode's key and proof
    for the same rng; the default device is the card;
  * BLS24-315's kinds (``g1_bls24315`` over its fp, ``g2_bls24315`` over
    fp4) through the same kernel checks (not the rollup's plan), and a
    BLS24-315 Groth16 proof on the card equal to the host mode's; a
    BLS12-381 one too, its quotient on the card and its MSMs on the
    native core; BLS24-315 G2's coefficient-sliced ladder, fold,
    weighted sum and reduction launched twice on the same inputs, each
    launch against the plain version.
  * the quotient's kernels (csrc/ntt_kernels.cu) over the six scalar
    fields: every transform shape at n = 1, 2, 4,096, twice the largest
    tile and 2^16, one launch a pass (``_cuda.ntt_plan``), compute_h's
    two regular-form transforms too, and the pointwise step (a b - c) d,
    against the plain versions; compute_h on the card against the CPU's,
    with its launches, in both forms.

Tolerance: none.  Limbs compare exactly; points compare as Python ints.
The microbenchmark's ``fma_f32`` alone compares within
``microbench.FMA_RTOL``: the kernel's fused multiply-add rounds once a
step, the plain version's ``a * y + y`` twice.
"""

import random
import re

import numpy as np
import pytest
import torch

from gnark_tpu_torch.curves import ALL_CURVES, BLS12_381, BLS24_315, BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import microbench as MB
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops import ntt as NT
from gnark_tpu_torch.ops.ec import points_to_host
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.ntt import Domain
from torch_kinds import KINDS, group, r_mod

R_MOD = BN254.fr.modulus
N = 4096


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _group(kind):
    return group(kind)[:3]


def _oracle_inputs(kind, dev, seed, n=N):
    """n points 2^(i mod 64) G (every 17th flagged infinite), random
    scalars, and the expected MSM."""
    G, H, gen = _group(kind)
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    xs = G.F.pack([q[0] for q in base], dev).repeat(1, n // 64)
    ys = G.F.pack([q[1] for q in base], dev).repeat(1, n // 64)
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    inf[::17] = True
    rng = np.random.default_rng(seed)
    r = r_mod(kind)
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(n)]
    sc = torch.from_numpy(
        ints_to_limbs(scalars, BN254.fr.L).astype(np.int64)).to(dev)
    total = sum(s << (i % 64) for i, s in enumerate(scalars)
                if i % 17) % r
    return G, (xs, ys, inf, sc), H.scalar_mul(gen, total)


def _windowed_kernels_match_plain(dev, kind, n, seed):
    """The four windowed kernels, one launch each, against their plain
    versions along the plan of an n-point MSM; -> the plan."""
    G, (xs, ys, inf, sc), _ = _oracle_inputs(kind, dev, seed, n)
    plan = M.MSM(G, n, BN254.fr.L)
    GC = plan.GC
    ptrows, dg, sg = plan._prep_window(xs, ys, inf, sc)
    sx, sy, d_sorted = plan._sort_gather(ptrows, dg, sg)
    before = dict(_cuda.launches)
    rows = M.leaf_prefix(sx, sy, GC)
    tot = plan.lane_totals(rows)
    offs = M.lane_offsets(tot, GC)
    bk = plan._buckets(rows, offs, d_sorted)
    S = M.weighted_sum(bk, GC)
    P = M.horner_fold(S, plan.c, GC)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _cuda.launches.items()
            if k.endswith(kind)} == {f"{k}_{kind}": 1 if k in
                                     _cuda.WINDOW_KERNELS else 0
                                     for k in _cuda.KERNELS}
    assert torch.equal(rows, M.leaf_prefix_plain(sx, sy, GC))
    assert torch.equal(offs, M.lane_offsets_plain(tot, GC))
    assert torch.equal(bk, M.buckets_plain(rows, offs, d_sorted, plan.C,
                                           plan.R, plan.nb, GC))
    assert torch.equal(S, M.weighted_sum_plain(bk, GC))
    assert torch.equal(P, M.horner_fold_jacobian_plain(S, plan.c, GC))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_plain_on_cuda(dev, kind):
    _windowed_kernels_match_plain(dev, kind, N, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_kernels_match_plain_on_cuda_at_rollup_plan(dev, kind):
    """The plan of every MSM of the rollup's Groth16 prove (n_pad =
    32,768): 26 windows of c = 10, 512 buckets, R = 512 lanes of C = 64."""
    plan = _windowed_kernels_match_plain(dev, kind, 1 << 15, 15)
    assert (plan.c, plan.nwin, plan.nb, plan.R, plan.C) == (10, 26, 512,
                                                           512, 64)


@pytest.mark.cuda
def test_leaf_prefix_matches_plain_on_cuda_at_plonk_shape(dev):
    """The G1 leaf at a PLONK commitment's 2^16 + 3 points: 512 lanes of
    C = 129 points (not a power of two), the padding points infinite, one
    launch, bit for bit."""
    _leaf_at_plonk_shape(dev, "g1")


@pytest.mark.cuda
def test_fp4_leaf_matches_plain_on_cuda_at_c129(dev):
    """BLS24-315's fp4 leaf (each chain's coefficients over a lane group)
    at 2^16 + 3 points: 512 lanes of C = 129 points, a C that is not a
    power of two, the padding points infinite, one launch, bit for bit."""
    _leaf_at_plonk_shape(dev, "g2_bls24315")


def _leaf_at_plonk_shape(dev, kind):
    G, H, gen = _group(kind)
    n = (1 << 16) + 3
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    reps = -(-n // 64)
    xs = G.F.pack([q[0] for q in base], dev).repeat(1, reps)[:, :n]
    ys = G.F.pack([q[1] for q in base], dev).repeat(1, reps)[:, :n]
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    inf[::17] = True
    rng = np.random.default_rng(12)
    scalars = [int.from_bytes(rng.bytes(32), "little") % r_mod(kind)
               for _ in range(n)]
    sc = torch.from_numpy(
        ints_to_limbs(scalars, BN254.fr.L).astype(np.int64)).to(dev)
    plan = M.MSM(G, n, BN254.fr.L)
    assert (plan.R, plan.C) == (512, 129)
    sx, sy, _ = plan._sort_gather(*plan._prep_window(
        xs.contiguous(), ys.contiguous(), inf, sc))
    flagged = (((sy[:, :, 0] >> 16) & 1) != 0).sum((1, 2))
    assert bool((flagged >= plan.n_pad - n).all())     # the padding points
    before = _cuda.launches[f"leaf_prefix_{kind}"]
    rows = M.leaf_prefix(sx, sy, plan.GC)
    torch.cuda.synchronize()
    assert _cuda.launches[f"leaf_prefix_{kind}"] == before + 1
    assert torch.equal(rows, M.leaf_prefix_plain(sx, sy, plan.GC))


def _buckets(kind, dev, nw, nb, live):
    """[3L, nw, nb] buckets: 2^(i mod 64) G plus 2^((i + 1) mod 64) G by
    the complete addition (so Z != 1), windows outside ``live`` all the
    identity (0 : 1 : 0)."""
    G, H, gen = _group(kind)
    GC = M.complete_ops(G)
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    n = nw * nb
    xs = G.F.pack([q[0] for q in base], dev).repeat(1, -(-n // 64))[:, :n]
    ys = G.F.pack([q[1] for q in base], dev).repeat(1, -(-n // 64))[:, :n]
    P = (xs, ys, G.F.ones(n, dev))
    B = GC.add(P, tuple(a.roll(-1, -1) for a in P))
    keep = torch.zeros(nw, dtype=torch.bool, device=dev)
    keep[list(live)] = True
    keep = keep.repeat_interleave(nb)
    B = tuple(torch.where(keep, b, i) for b, i in zip(B, GC.inf(n, dev)))
    return GC, torch.cat(B).reshape(-1, nw, nb).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nw=24 nb=1024", "nw=24 nb=2",
                                  "nw=20 nb=1024, 9 windows in 10 identity"])
@pytest.mark.parametrize("kind", KINDS)
def test_weighted_sum_matches_plain_on_cuda(dev, kind, case):
    """The weighted sum at the 2^16 plan's shape (24 windows of 1,024
    buckets), at nb = 2 (no tree, no doubling), and with nine windows in
    ten all the identity: one launch each, bit for bit."""
    nw, nb = (int(v) for v in re.findall(r"=(\d+)", case)[:2])
    live = range(9, nw, 10) if "identity" in case else range(nw)
    GC, bk = _buckets(kind, dev, nw, nb, live)
    before = _cuda.launches[f"weighted_sum_{kind}"]
    S = M.weighted_sum(bk, GC)
    torch.cuda.synchronize()
    assert _cuda.launches[f"weighted_sum_{kind}"] == before + 1
    assert torch.equal(S, M.weighted_sum_plain(bk, GC))


def _bucket_inputs(kind, dev):
    """The bucket step's inputs along the 4,096-point plan (the leaf and
    lane offsets kernels on oracle inputs), the sorted digits of windows
    0-3 replaced: no digit 0 and the largest digit nb last; all digits 0;
    C zeros (E_0 = C - 1, a lane's last step), then two digits, then nb
    (empty buckets); ones and nb last.  -> (plan, rows, offs, digits)."""
    G, (xs, ys, inf, sc), _ = _oracle_inputs(kind, dev, 19)
    plan = M.MSM(G, N, BN254.fr.L)
    sx, sy, d = plan._sort_gather(*plan._prep_window(xs, ys, inf, sc))
    rows = M.leaf_prefix(sx, sy, plan.GC)
    offs = M.lane_offsets(plan.lane_totals(rows), plan.GC)
    n, nb, C = plan.n_pad, plan.nb, plan.C
    rng = np.random.default_rng(23)
    d = d.clone()
    d[0] = torch.from_numpy(np.sort(rng.integers(1, nb + 1, n))).to(dev)
    d[0, -1] = nb
    d[1] = 0
    d[2] = 3
    d[2, :C] = 0
    d[2, n // 2:] = 5
    d[2, -7:] = nb
    d[3] = 1
    d[3, -1] = nb
    return plan, rows, offs, d.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_buckets_match_plain_on_cuda_edges(dev, kind):
    """The bucket step (buckets_kernel; fp4: buckets_sliced_kernel) at the
    4,096-point plan, with edge digits in four windows beside the plan's
    own: one launch (two over fp4, each equal to the other), bit for bit
    against the plain version; the empty buckets are the identity class
    (0 : Y : 0)."""
    plan, rows, offs, d = _bucket_inputs(kind, dev)
    args = (rows, offs, d, plan.C, plan.R, plan.nb, plan.GC)
    if kind == "g2_bls24315":
        bk, again, n = _twice(M.buckets, *args)
        assert n == 2 and torch.equal(bk, again)
    else:
        before = _cuda.launches[f"buckets_{kind}"]
        bk = M.buckets(*args)
        torch.cuda.synchronize()
        assert _cuda.launches[f"buckets_{kind}"] == before + 1
    assert torch.equal(bk, M.buckets_plain(*args))
    bvals = torch.arange(plan.nb + 1, device=dev).expand(
        d.shape[0], plan.nb + 1).contiguous()
    ends = torch.searchsorted(d, bvals, right=True) - 1
    empty = ends[:, 1:] == ends[:, :-1]
    assert int(ends[0, 0]) == -1 and int(ends[2, 0]) == plan.C - 1
    assert bool(empty[1].all()) and int(empty[2].sum()) >= plan.nb - 3
    X, Y, Z = M.split_points(bk, plan.GC.F.L)
    assert bool((X[:, empty] == 0).all() and (Z[:, empty] == 0).all())


_TOTALS = {}


def _plan_totals(kind, dev):
    """The 2^16 plan's lane totals [3L, 24, 512], from the leaf kernel on
    points 2^(i mod 64) G (every 17th infinite) and random scalars."""
    if kind not in _TOTALS:
        G, H, gen = _group(kind)
        n = 1 << 16
        base, P = [], gen
        for _ in range(64):
            base.append(P)
            P = H.double(P)
        xs = G.F.pack([q[0] for q in base], dev).repeat(1, n // 64)
        ys = G.F.pack([q[1] for q in base], dev).repeat(1, n // 64)
        inf = torch.zeros(n, dtype=torch.bool, device=dev)
        inf[::17] = True
        rng = np.random.default_rng(14)
        scalars = [int.from_bytes(rng.bytes(32), "little") % r_mod(kind)
                   for _ in range(n)]
        sc = torch.from_numpy(
            ints_to_limbs(scalars, BN254.fr.L).astype(np.int64)).to(dev)
        plan = M.MSM(G, n, BN254.fr.L)
        sx, sy, _ = plan._sort_gather(*plan._prep_window(xs, ys, inf, sc))
        tot = plan.lane_totals(M.leaf_prefix(sx, sy, plan.GC))
        assert tuple(tot.shape[1:]) == (24, 512)
        _TOTALS[kind] = (plan.GC, tot)
    return _TOTALS[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [512, 1, 2, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_lane_offsets_match_plain_on_cuda(dev, kind, R):
    """The lane offsets on the 2^16 plan's lane totals (24 windows of 512
    lanes) and on their first R lanes: one launch each, bit for bit (R =
    1: every lane the identity); a lane count that is not a power of two
    raises."""
    GC, tot = _plan_totals(kind, dev)
    tot = tot[..., :R].contiguous()
    before = _cuda.launches[f"lane_offsets_{kind}"]
    offs = M.lane_offsets(tot, GC)
    torch.cuda.synchronize()
    assert _cuda.launches[f"lane_offsets_{kind}"] == before + 1
    assert torch.equal(offs, M.lane_offsets_plain(tot, GC))
    if R == 1:
        assert torch.equal(offs, torch.cat(GC.inf((24, 1), dev)))
    if R == 8:
        with pytest.raises(ValueError):
            M.lane_offsets(tot[..., :6].contiguous(), GC)


def _ladder_on_cuda(G, args):
    """The ladder, the reduction and the fold, kernels against plain
    versions, with the launches they made."""
    GC = M.complete_ops(G)
    kind = _cuda.kind_of(GC)
    before = dict(_cuda.launches)
    out = M.ladder(*args, GC)
    tot = M.reduce(out, GC)
    B = M.chunk_bits(args[3].shape[0])
    S = M.horner_fold(tot, B, GC)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _cuda.launches.items()
            if k.endswith(kind) and v != before[k]} == {
                f"ladder_{kind}": 1, f"reduce_{kind}": 1,
                f"horner_fold_{kind}": 1}
    assert torch.equal(out, M.ladder_plain(*args, GC))
    assert torch.equal(tot, M.reduce_plain(out, GC))
    assert torch.equal(S, M.horner_fold_jacobian_plain(tot, B, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_ladder_matches_plain_on_cuda(dev, kind):
    G, args, _ = _oracle_inputs(kind, dev, 7)
    _ladder_on_cuda(G, args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["37 points", "64-bit scalars",
                                  "20-bit scalars"])
@pytest.mark.parametrize("kind", KINDS)
def test_ladder_small_shapes_match_plain_on_cuda(dev, kind, case):
    """A partial block; chunks of 4 bits (one window); scalars whose top
    chunks are all zero, so the fold starts at chunk 1."""
    G, (xs, ys, inf, sc), _ = _oracle_inputs(kind, dev, 11)
    if case == "37 points":
        args = tuple(a[..., :37].contiguous() for a in (xs, ys, inf, sc))
    elif case == "64-bit scalars":
        args = (xs, ys, inf, sc[:4].contiguous())
    else:
        small = torch.zeros_like(sc)
        small[:2] = sc[:2]
        small[1] &= 0xF
        args = (xs, ys, inf, small)
    _ladder_on_cuda(G, args)


def _twice(fn, *args):
    """Two launches of a kernel wrapper: their outputs and launch count."""
    name = fn.__name__
    before = _cuda.launches[f"{name}_g2_bls24315"]
    first, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    return first, again, _cuda.launches[f"{name}_g2_bls24315"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1 in 64 infinite", "top chunks zero"])
def test_fp4_ladder_sliced_matches_plain_on_cuda(dev, case):
    """BLS24-315 G2's ladder, ladder_sliced_kernel (a chain's fp4
    coefficients over a group of LADDER_GROUP lanes), at 4,096 points,
    launched twice: each launch equals the plain ladder bit for bit.
    The second case leaves 14 of the 16 chunks of every scalar zero."""
    G, (xs, ys, inf, sc), _ = _oracle_inputs("g2_bls24315", dev, 13)
    inf = torch.zeros_like(inf)
    inf[::64] = True
    if case == "top chunks zero":
        sc = sc.clone()
        sc[2:] = 0
    GC = M.complete_ops(G)
    first, again, n = _twice(M.ladder, xs, ys, inf, sc, GC)
    assert n == 2 and _cuda.shape("g2_bls24315")["leaf_sliced"]
    assert torch.equal(first, again)
    assert torch.equal(first, M.ladder_plain(xs, ys, inf, sc, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("live", [16, 3, 0])
def test_fp4_fold_sliced_matches_plain_on_cuda(dev, live):
    """BLS24-315 G2's Horner fold, horner_fold_sliced_kernel (one group
    of FOLD_GROUP lanes), at the ladder's chunk fold (16 sums of 4,096
    points' chunks, c = 16), the top 16 - ``live`` sums the identity,
    launched twice: each launch equals the plain fold in the Jacobian form
    bit for bit."""
    G, args, _ = _oracle_inputs("g2_bls24315", dev, 17)
    GC = M.complete_ops(G)
    T = M.reduce_plain(M.ladder_plain(*args, GC), GC)
    S = torch.cat([T[:, :live], torch.cat(GC.inf(16 - live, dev))],
                  1).contiguous()
    first, again, n = _twice(M.horner_fold, S, 16, GC)
    assert n == 2
    assert torch.equal(first, again)
    assert torch.equal(first, M.horner_fold_jacobian_plain(S, 16, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nw=24 nb=1024", "nw=24 nb=2",
                                  "nw=20 nb=1024, 9 windows in 10 identity"])
def test_fp4_weighted_sum_sliced_matches_plain_on_cuda(dev, case):
    """BLS24-315 G2's weighted sum, weighted_sum_sliced_kernel (each
    wavefront operation on a group of WSUM_GROUP lanes by coefficient), at
    the 2^16 plan's shape, at nb = 2 and with nine windows in ten all the
    identity, launched twice: each launch equals the plain version bit
    for bit."""
    nw, nb = (int(v) for v in re.findall(r"=(\d+)", case)[:2])
    live = range(9, nw, 10) if "identity" in case else range(nw)
    GC, bk = _buckets("g2_bls24315", dev, nw, nb, live)
    first, again, n = _twice(M.weighted_sum, bk, GC)
    assert n == 2 and _cuda.shape("g2_bls24315")["leaf_sliced"]
    assert torch.equal(first, again)
    assert torch.equal(first, M.weighted_sum_plain(bk, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [512, 2])
def test_fp4_lane_offsets_sliced_matches_plain_on_cuda(dev, R):
    """BLS24-315 G2's lane offsets, lane_offsets_sliced_kernel (each
    Brent-Kung addition on a group of LANES_GROUP lanes by coefficient),
    on the 2^16 plan's lane totals (24 windows of 512) and on their first
    two lanes, launched twice: each launch equals the plain version bit
    for bit."""
    GC, tot = _plan_totals("g2_bls24315", dev)
    tot = tot[..., :R].contiguous()
    first, again, n = _twice(M.lane_offsets, tot, GC)
    assert n == 2 and _cuda.shape("g2_bls24315")["leaf_sliced"]
    assert torch.equal(first, again)
    assert torch.equal(first, M.lane_offsets_plain(tot, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 600, 37])
def test_fp4_reduce_sliced_matches_plain_on_cuda(dev, n):
    """BLS24-315 G2's reduction, reduce_sliced_kernel (a chunk's 256
    accumulators on groups of REDUCE_GROUP lanes over a cluster), on the
    plain ladder's output at 4,096 points (1 in 17 infinite) and on its
    first 600 (not a multiple of 256) and 37 (fewer points than
    accumulators), launched twice: each launch equals the plain
    reduction bit for bit."""
    G, args, _ = _oracle_inputs("g2_bls24315", dev, 19)
    GC = M.complete_ops(G)
    pts = M.ladder_plain(*args, GC)[..., :n].contiguous()
    first, again, launches = _twice(M.reduce, pts, GC)
    assert launches == 2
    assert torch.equal(first, again)
    assert torch.equal(first, M.reduce_plain(pts, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_msm_on_cuda_matches_host_oracle(dev, kind):
    G, args, want = _oracle_inputs(kind, dev, 6)
    assert N < M.LADDER_MAX
    assert points_to_host(G, M.msm(G, *args)) == [want]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_windowed_msm_on_cuda_matches_host_oracle(dev, kind):
    G, args, want = _oracle_inputs(kind, dev, 8)
    assert points_to_host(G, M.MSM(G, N, BN254.fr.L)(*args)) == [want]


class Cubic(Circuit):
    x = Secret()
    y = Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))


@pytest.mark.cuda
def test_setup_and_prove_on_cuda_equal_cpu(dev):
    cs = compile_circuit(Cubic(), BN254)
    keys = {d: tg.setup(cs, BN254, rng=random.Random(3), device=d)
            for d in ("cpu", dev)}
    (cpk, cvk), (gpk, gvk) = keys["cpu"], keys[dev]
    for name in ("A", "B1", "B2", "K", "Z"):
        for c, g in zip(getattr(cpk, name), getattr(gpk, name)):
            assert torch.equal(c, g.cpu()), name
    M.plain_on_cuda.update({k: 0 for k in M.plain_on_cuda})
    want = tg.prove(cs, cpk, [35, 3], rng=random.Random(4))
    got = tg.prove(cs, gpk, [35, 3], rng=random.Random(4))
    assert not any(M.plain_on_cuda.values())
    assert (got.ar, got.bs, got.krs) == (want.ar, want.bs, want.krs)
    assert tg.verify(got, gvk, [35])
    assert not tg.verify(got, gvk, [36])


@pytest.mark.cuda
@pytest.mark.parametrize("op", MB.OPS)
def test_microbench_kernel_matches_plain_on_cuda(dev, op):
    x, y = MB.inputs(op, 4096 + 37, dev, seed=9)
    before = _cuda.launches[f"microbench_{op}"]
    got = MB.chain(op, x, y)
    torch.cuda.synchronize()
    assert _cuda.launches[f"microbench_{op}"] == before + 1
    want = MB.chain_plain(op, x, y)
    if op == "fma_f32":
        assert torch.allclose(got, want, rtol=MB.FMA_RTOL, atol=0)
    else:
        assert torch.equal(got, want)
    cx, cy = x.cpu(), y.cpu()
    with pytest.raises(ValueError):
        _cuda.microbench(op, cx, cy)
    if op in MB.MONTMUL_FIELDS:                 # the latency's one chain
        got = MB.chain(op, x, y, steps=5, chains=1)
        torch.cuda.synchronize()
        assert torch.equal(got, MB.chain_plain(op, x, y, 5, chains=1))


@pytest.mark.cuda
def test_plonk_on_cuda_equals_host_mode(dev):
    cs = compile_circuit(Cubic(), BN254, scheme="plonk")
    hpk, hvk = tp.setup(cs, BN254, rng=random.Random(3), host=True)
    gpk, gvk = tp.setup(cs, BN254, rng=random.Random(3))    # the card
    assert gpk.device.type == "cuda" and gpk.srs.device.type == "cuda"
    assert gvk == hvk
    M.plain_on_cuda.update({k: 0 for k in M.plain_on_cuda})
    before = dict(_cuda.launches)
    want = tp.prove(cs, hpk, [35, 3], rng=random.Random(4))
    got = tp.prove(cs, gpk, [35, 3], rng=random.Random(4))
    assert not any(M.plain_on_cuda.values())
    # nine small MSMs: the ladder, its reduction and the fold
    for k in ("ladder_g1", "reduce_g1", "horner_fold_g1"):
        assert _cuda.launches[k] == before[k] + 9, k
    assert got == want
    assert tp.verify(got, gvk, [35])
    assert not tp.verify(got, gvk, [36])


@pytest.mark.cuda
@pytest.mark.parametrize("curve", [BLS24_315, BLS12_381],
                         ids=lambda c: c.name)
def test_other_curves_prove_on_cuda_equal_host_mode(dev, curve):
    """BLS24-315 (its MSMs on its kernels: the ladder at this size) and
    BLS12-381 (its quotient on the card, its MSMs on the native core):
    setup and prove on the card give the host mode's proof for the same
    rng, and it verifies."""
    cs = compile_circuit(Cubic(), curve)
    pk, vk = tg.setup(cs, curve, rng=random.Random(3), device=dev)
    hpk, _ = tg.setup(cs, curve, rng=random.Random(3), host=True)
    before = dict(_cuda.launches)
    proof = tg.prove(cs, pk, [35, 3], rng=random.Random(4))
    want = tg.prove(cs, hpk, [35, 3], rng=random.Random(4))
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
    assert tg.verify(proof, vk, [35]) and not tg.verify(proof, vk, [34])
    ran = {k: v - before[k] for k, v in _cuda.launches.items()
           if v != before[k]}
    kind = f"fr_{curve.name}"
    # every route: the quotient's seven transforms and pointwise step
    passes = len(_cuda.ntt_plan(kind, pk.domain_n))
    ntt = {f"ntt_{kind}": 7 * passes, f"fr_pointwise_{kind}": 1}
    assert {k: v for k, v in ran.items() if k in ntt} == ntt, ran
    msm_kernels = set(ran) - set(ntt)
    if curve is BLS24_315:
        assert msm_kernels == {f"{k}_{g}_bls24315" for k in (
            "ladder", "reduce", "horner_fold") for g in ("g1", "g2")}, ran
    else:
        assert not msm_kernels, ran


# ---- the quotient's kernels (csrc/ntt_kernels.cu) ---------------------------

NTT_SHAPES = [(inverse, order, coset) for inverse in (False, True)
              for order in ("DIF", "DIT") for coset in (False, True)]


def _fr_values(spec, n, seed):
    """p - 1, 0 and 1 first, then seeded values below p."""
    rnd = random.Random(seed)
    q = spec.modulus
    return ([q - 1, 0, 1] + [rnd.randrange(q) for _ in range(n)])[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4096, "2T", 1 << 16])
@pytest.mark.parametrize("kind", list(_cuda.FR_KINDS))
def test_ntt_kernel_matches_plain_on_cuda(dev, kind, n):
    """Every transform shape through the pass kernel, one launch a pass
    (``_cuda.ntt_plan``: one at n <= T, the largest tile, two from 2T to
    2^16), against the plain version on the same CUDA tensors; the public
    fft / ifft take the kernel route."""
    tmax = max(p.tile_log for p in _cuda.ntt_plan(kind, 1 << 20))
    if n == "2T":
        n = 2 << tmax
    spec = ALL_CURVES[kind[3:]].fr
    d = Domain(spec, n, dev)
    x = d.F.pack(_fr_values(spec, n, n), dev)
    launches = len(_cuda.ntt_plan(kind, n))
    assert launches == (1 if n <= 1 << tmax else 2)
    for inverse, order, coset in NTT_SHAPES:
        ops = d.operands(inverse, order, coset)
        before = _cuda.launches[f"ntt_{kind}"]
        got = d.transform_kernel(x, *ops, order)
        torch.cuda.synchronize()
        assert _cuda.launches[f"ntt_{kind}"] == before + launches
        plain = dict(NT.plain_on_cuda)
        fn = d.ifft if inverse else d.fft
        assert torch.equal(fn(x, order, coset=coset), got)
        assert NT.plain_on_cuda == plain, "fft/ifft ran the plain version"
        assert torch.equal(got, d.transform_plain(x, *ops, order)), \
            (inverse, order, coset)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_cuda.FR_KINDS))
def test_ntt_kernel_regular_forms_match_plain_on_cuda(dev, kind):
    """compute_h's two regular-form transforms (the iFFT with R as its
    broadcast pre-scale on the first pass's load, the coset iFFT with
    R^-1 folded into its post table on the last pass's store) at n =
    4,096 against the plain version: the limbs of to_mont before and
    from_mont after."""
    spec = ALL_CURVES[kind[3:]].fr
    n = 4096
    d = Domain(spec, n, dev)
    F = d.F
    x = F.pack(_fr_values(spec, n, 3), dev)
    for coset, regular in ((False, (True, False)), (True, (False, True))):
        ops = d.operands(True, "DIF", coset, *regular)
        got = d.transform_kernel(x, *ops, "DIF")
        assert torch.equal(got, d.transform_plain(x, *ops, "DIF"))
        want = d.transform_plain(F.to_mont(x) if regular[0] else x,
                                 *d.operands(True, "DIF", coset), "DIF")
        assert torch.equal(got, F.from_mont(want) if regular[1] else want), \
            coset


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_cuda.FR_KINDS))
def test_fr_pointwise_matches_plain_on_cuda(dev, kind):
    """(a b - c) d, d one broadcast value and a full plane, 4096 + 37
    elements, against the plain version; CPU tensors refused."""
    spec = ALL_CURVES[kind[3:]].fr
    F, n = field_ops(spec), 4096 + 37
    a, b, c, d = (F.pack(_fr_values(spec, n, s), dev) for s in range(4))
    for dd in (d, d[:, :1].contiguous()):
        before = _cuda.launches[f"fr_pointwise_{kind}"]
        got = NT.fr_pointwise(spec, a, b, c, dd)
        torch.cuda.synchronize()
        assert _cuda.launches[f"fr_pointwise_{kind}"] == before + 1
        assert torch.equal(got, NT.fr_pointwise_plain(F, a, b, c, dd))
    with pytest.raises(ValueError):
        _cuda.fr_pointwise(a.cpu(), b.cpu(), c.cpu(), d.cpu(), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bn254", "bw6_761"])
def test_compute_h_on_cuda_equals_cpu(dev, name):
    """The quotient at n = 1,024 on the card (seven transforms of one
    pass each, one pointwise launch) and on the CPU: the same limbs; in
    prove's regular form too, the limbs of from_mont(compute_h(to_mont))
    with no conversion of its own on the card."""
    spec = ALL_CURVES[name].fr
    F = field_ops(spec)
    n = 1024
    planes = [F.pack(_fr_values(spec, n, s), "cpu") for s in (5, 6, 7)]
    want = tg.compute_h(Domain(spec, n, "cpu"), *planes)
    before = dict(_cuda.launches)
    dom = Domain(spec, n, dev)
    got = tg.compute_h(dom, *(t.to(dev) for t in planes))
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in _cuda.launches.items()
           if v != before[k]}
    assert ran == {f"ntt_fr_{name}": 7, f"fr_pointwise_fr_{name}": 1}, ran
    assert torch.equal(got.cpu(), want)
    regular = [F.from_mont(t) for t in planes]
    got = tg.compute_h(dom, *(t.to(dev) for t in regular), regular=True)
    assert torch.equal(got.cpu(), F.from_mont(want))
