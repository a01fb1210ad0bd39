"""gnark_tpu_torch on a CUDA card (marker ``cuda``; every test skips
without a card).

The file imports no jax, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which imports jax.)

  * the weighted sum at the 2^16 plan's 24 windows of 1,024 buckets, at
    2 buckets, and with nine windows in ten all the identity;
  * each of the four windowed-MSM kernels, the ladder kernel, the
    per-chunk reduction kernel and the fold of the chunk sums against its
    plain version on the same CUDA tensors, G1 and G2, bit for bit, one
    launch each: at the small proof's 4096 points, at 37 points (a
    ragged last block), with 64-bit scalars (a window a chunk) and with
    20-bit scalars (the fold of the chunk sums starts at chunk 1); the G1
    leaf also at a PLONK commitment's 2^16 + 3 points (C = 129);
  * the kernel-path MSM, through ``msm`` (the ladder at this size) and
    through the windowed plan, against the host oracle (point
    i = 2^(i mod 64) G);
  * setup and prove on the card give the same key and proof as on the CPU
    for the same rng, and the proof verifies;
  * every op of the integer-multiply microbenchmark kernel against its
    plain version on the same CUDA tensors, one launch each;
  * PLONK setup and prove on the card give the host mode's key and proof
    for the same rng; the default device is the card.

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

from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import microbench as MB
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops

R_MOD = BN254.fr.modulus
N = 4096


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _group(kind):
    if kind == "g1":
        return (CurveOps(field_ops(BN254.fp), b=BN254.b), BN254.host_g1,
                BN254.g1_gen)
    return (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
            BN254.host_g2, BN254.g2_gen)


def _oracle_inputs(kind, dev, seed):
    """n points 2^(i mod 64) G (every 17th flagged infinite), random
    scalars, and the expected MSM."""
    G, H, gen = _group(kind)
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    xs = G.F.pack([q[0] for q in base], dev).repeat(1, N // 64)
    ys = G.F.pack([q[1] for q in base], dev).repeat(1, N // 64)
    inf = torch.zeros(N, dtype=torch.bool, device=dev)
    inf[::17] = True
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(N)]
    sc = torch.from_numpy(
        ints_to_limbs(scalars, BN254.fr.L).astype(np.int64)).to(dev)
    total = sum(s << (i % 64) for i, s in enumerate(scalars)
                if i % 17) % R_MOD
    return G, (xs, ys, inf, sc), H.scalar_mul(gen, total)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_kernels_match_plain_on_cuda(dev, kind):
    G, (xs, ys, inf, sc), _ = _oracle_inputs(kind, dev, 5)
    plan = M.MSM(G, N, BN254.fr.L)
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
    assert torch.equal(S, M.weighted_sum_plain(bk, GC))
    assert torch.equal(P, M.horner_fold_plain(S, plan.c, GC))


@pytest.mark.cuda
def test_leaf_prefix_matches_plain_on_cuda_at_plonk_shape(dev):
    """The G1 leaf at a PLONK commitment's 2^16 + 3 points: 512 lanes of
    C = 129 points (not a power of two), the padding points infinite, one
    launch, bit for bit."""
    G, H, gen = _group("g1")
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
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(n)]
    sc = torch.from_numpy(
        ints_to_limbs(scalars, BN254.fr.L).astype(np.int64)).to(dev)
    plan = M.MSM(G, n, BN254.fr.L)
    assert (plan.R, plan.C) == (512, 129)
    sx, sy, _ = plan._sort_gather(*plan._prep_window(
        xs.contiguous(), ys.contiguous(), inf, sc))
    before = _cuda.launches["leaf_prefix_g1"]
    rows = M.leaf_prefix(sx, sy, plan.GC)
    torch.cuda.synchronize()
    assert _cuda.launches["leaf_prefix_g1"] == before + 1
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
@pytest.mark.parametrize("kind", ["g1", "g2"])
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
    assert torch.equal(S, M.horner_fold_plain(tot, B, GC))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ladder_matches_plain_on_cuda(dev, kind):
    G, args, _ = _oracle_inputs(kind, dev, 7)
    _ladder_on_cuda(G, args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["37 points", "64-bit scalars",
                                  "20-bit scalars"])
@pytest.mark.parametrize("kind", ["g1", "g2"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_msm_on_cuda_matches_host_oracle(dev, kind):
    G, args, want = _oracle_inputs(kind, dev, 6)
    assert N < M.LADDER_MAX
    assert points_to_host(G, M.msm(G, *args)) == [want]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["g1", "g2"])
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
    if op == "montmul_bn254":                   # the latency's one chain
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
