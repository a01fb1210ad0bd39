"""The port's lane offsets (``lane_offsets_plain``, a Brent-Kung scan)
against the JAX package's ``MSM._lane_offsets_pallas`` (a Hillis-Steele
scan, in interpret mode) and against the host curves.

The two scans add in another order, so their outputs are other
representatives of the same points: they compare as projective points
over Python ints (every 2 x 2 minor of the two coordinate vectors is zero
mod p), and lane 0 is the identity class (0 : Y : 0), Y != 0, on both
sides.  The totals are made with numpy from a seed: multiples of the
generator with a random Z, some lanes the identity (0 : Z : 0), one lane
repeating another and one its negation.

  * the 62-bit field and curve of test_torch_msm_interpret.py (y^2 =
    x^3 + 1, L = 4; about 15 s of interpret mode on a CPU), nw = 2, R = 8;
  * BN254 G1 (L = 16) under ``slow``: about 150 s on a CPU;
  * ``lane_offsets_plain`` at BN254 G1 and G2 against the host curves'
    exclusive prefix sums, in affine form.

Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import gnark_tpu.ops.msm as jax_msm
from gnark_tpu import fields
from gnark_tpu.curves import BN254
from gnark_tpu.curves.host import HostCurve, HostFp
from gnark_tpu.ops.ec import CurveOps as JaxCurveOps
from gnark_tpu.ops.limbs import field_ops as jax_field_ops
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.limbs import field_ops
from gnark_tpu_torch.ops.towers import fp2_ops

torch.set_num_threads(1)
NW, R = 2, 8


def _p62():
    spec = fields.FieldSpec(name="p62_msm_smoke", modulus=(1 << 62) - 57,
                            multiplicative_generator=3)
    return spec, 1, HostCurve(HostFp(spec.modulus), 1), \
        (3, 1159191455696576622)


def _bn254_g1():
    return BN254.fp, BN254.b, BN254.host_g1, BN254.g1_gen


FIELDS = {"p62": _p62, "bn254_g1": _bn254_g1}


def _totals(spec, host, gen, seed):
    """Projective totals (X, Y, Z) as ints, [NW * R] each: a point (xZ :
    yZ : Z), the identity (0 : Z : 0), Z random and nonzero."""
    q = spec.modulus
    rng = np.random.default_rng(seed + 1)
    pts = []
    for k in rng.integers(1, 1 << 30, size=NW * R):
        pts.append(host.scalar_mul(gen, int(k)))
    for w in range(NW):
        b = w * R
        pts[b + 2] = pts[b + 6] = None
        pts[b + 4] = pts[b + 3]
        pts[b + 7] = (pts[b + 5][0], -pts[b + 5][1] % q)
    zs = [int(z) for z in rng.integers(1, 1 << 60, size=NW * R)]
    X = [0 if p is None else p[0] * z % q for p, z in zip(pts, zs)]
    Y = [z if p is None else p[1] * z % q for p, z in zip(pts, zs)]
    Z = [0 if p is None else z for p, z in zip(pts, zs)]
    return X, Y, Z


def _same_point(a, b, q):
    """Two projective points (X, Y, Z) as ints are one point: neither is
    the zero vector and every 2 x 2 minor vanishes mod q."""
    if not any(v % q for v in a) or not any(v % q for v in b):
        return False
    return all((a[i] * b[j] - a[j] * b[i]) % q == 0
               for i, j in ((0, 1), (0, 2), (1, 2)))


def _jax_vs_port(case):
    spec, b, host, gen = FIELDS[case]()
    q = spec.modulus
    X, Y, Z = _totals(spec, host, gen, 11)

    JF = jax_field_ops(spec)
    old = jax_msm._INTERPRET
    jax_msm._INTERPRET = True
    try:
        jplan = jax_msm.MSM(JaxCurveOps(JF, b=b), NW * R, 1, c=4, lanes=R,
                            method="window_pallas", signed=True)
        L = JF.L
        tj = tuple(jnp.asarray(JF.pack(v)).reshape(L, NW, R)
                   for v in (X, Y, Z))
        out = jplan._lane_offsets_pallas(tj, NW)
    finally:
        jax_msm._INTERPRET = old
    jax_pts = list(zip(*(JF.unpack(np.asarray(a).reshape(L, -1))
                         for a in out)))

    F = field_ops(spec)
    GC = M.complete_ops(CurveOps(F, b=b))
    tot = torch.cat([F.pack(v, "cpu").reshape(L, NW, R) for v in (X, Y, Z)])
    got = M.lane_offsets_plain(tot, GC)
    port_pts = list(zip(*(F.unpack(a.reshape(L, -1))
                          for a in M.split_points(got, L))))

    assert len(jax_pts) == len(port_pts) == NW * R
    for w in range(NW):
        for p in (jax_pts[w * R], port_pts[w * R]):      # lane 0
            assert p[0] == 0 and p[2] == 0 and p[1] % q != 0
    assert any(p[2] for p in port_pts), "every lane the identity"
    bad = [i for i, (a, c) in enumerate(zip(jax_pts, port_pts))
           if not _same_point(a, c, q)]
    assert not bad, f"lanes (window * R + lane) that differ: {bad}"


def test_lane_offsets_plain_matches_jax_pallas_interpret_p62():
    _jax_vs_port("p62")


@pytest.mark.slow
def test_lane_offsets_plain_matches_jax_pallas_interpret_bn254_g1():
    _jax_vs_port("bn254_g1")


def _group(kind):
    if kind == "g1":
        return (CurveOps(field_ops(BN254.fp), b=BN254.b), BN254.host_g1,
                BN254.g1_gen)
    return (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
            BN254.host_g2, BN254.g2_gen)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_lane_offsets_plain_matches_host_prefix_sums(kind):
    """Affine totals (x : y : 1), lanes 2 and 6 of each window the
    identity (0 : 1 : 0), lane 4 repeating lane 3 and lane 7 the negation
    of lane 5: lane r of the output is the host curve's sum of lanes
    0 .. r - 1 (the identity at lane 0)."""
    G, host, gen = _group(kind)
    rng = np.random.default_rng(17)
    pts = [host.scalar_mul(gen, int(k))
           for k in rng.integers(1, 1 << 62, size=NW * R)]
    for w in range(NW):
        b = w * R
        pts[b + 2] = pts[b + 6] = None
        pts[b + 4] = pts[b + 3]
        pts[b + 7] = host.neg(pts[b + 5])
    F = G.F
    zero = F.zeros(1, "cpu")[:, 0]
    one = F.ones(1, "cpu")[:, 0]
    cols = []
    for p in pts:
        if p is None:
            cols.append(torch.cat([zero, one, zero]))
        else:
            cols.append(torch.cat([F.pack([p[0]], "cpu")[:, 0],
                                   F.pack([p[1]], "cpu")[:, 0], one]))
    tot = torch.stack(cols, -1).reshape(-1, NW, R)
    GC = M.complete_ops(G)
    got = M.lane_offsets_plain(tot, GC)
    L = F.L
    aff = points_to_host(G, GC.to_jacobian(
        M.split_points(got.reshape(3 * L, -1), L)))
    want = []
    for w in range(NW):
        acc = None
        for r in range(R):
            want.append(acc)
            acc = host.add(acc, pts[w * R + r])
    assert aff == want
