"""The port's leaf prefix, bucket step, weighted bucket sum and Horner fold
(their plain versions, which the CUDA kernels equal bit for bit) against
the JAX package's Pallas kernels ``MSM._leaf_prefix_pallas``,
``_weighted_sum_pallas`` and ``_horner_fold_pallas``, run in interpret mode
as the JAX package's own tests run them on a CPU, and against the bucket
step of its ``MSM._window_chunk`` (jitted through XLA there), whose
weighted sum the test's plan instance replaces by the identity so that
it hands back its buckets.

The same inputs go through both, made with numpy from a seed: for the leaf,
sorted point rows with infinity flags (bit 16 of y limb 0) and negative
digits (bit 17); for the bucket step, points, 16-bit scalars and
infinity flags through each package's own recoding, sort and gather,
leaf and lane offsets; for the weighted sum and the fold, projective points
(xZ : yZ : Z) with a random Z, some of them the identity (0 : Z : 0),
one repeating another and one its negation.  The two sides may add in
another order (the JAX weighted sum pads the buckets to 128 lanes and
finishes with two suffix scans; its fold starts at the top window, the
port's at the highest that is not the identity), so the outputs compare
as projective points over Python ints: every 2 x 2 minor of the two
coordinate vectors is zero mod p, and the identity class is (0 : Y : 0),
Y != 0, on both sides.

  * the 62-bit field and curve of tests/test_torch_lane_offsets.py (y^2 =
    x^3 + 1, L = 4), two windows, c = 4 (8 buckets), R = 8 lanes of C = 4;
  * BN254 G1 (L = 16) under ``slow``.

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
from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.limbs import field_ops

torch.set_num_threads(1)
NW, C, R, CW = 2, 4, 8, 4          # windows, leaf steps, lanes, window bits


def _p62():
    spec = fields.FieldSpec(name="p62_msm_smoke", modulus=(1 << 62) - 57,
                            multiplicative_generator=3)
    return spec, 1, HostCurve(HostFp(spec.modulus), 1), \
        (3, 1159191455696576622)


def _bn254_g1():
    return BN254.fp, BN254.b, BN254.host_g1, BN254.g1_gen


FIELDS = {"p62": _p62, "bn254_g1": _bn254_g1}


def _projective(spec, host, gen, n, seed):
    """n projective points as int lists (X, Y, Z): multiples of gen, a few
    the identity (0 : Z : 0), point 4 repeating 3, point 7 the negation of
    5 (mod 8), every Z random and nonzero."""
    q = spec.modulus
    rng = np.random.default_rng(seed)
    pts = [host.scalar_mul(gen, int(k))
           for k in rng.integers(1, 1 << 30, size=n)]
    for b in range(0, n - 7, 8):
        pts[b + 2] = pts[b + 6] = None
        pts[b + 4] = pts[b + 3]
        pts[b + 7] = (pts[b + 5][0], -pts[b + 5][1] % q)
    zs = [int(z) for z in rng.integers(1, 1 << 60, size=n)]
    X = [0 if p is None else p[0] * z % q for p, z in zip(pts, zs)]
    Y = [z if p is None else p[1] * z % q for p, z in zip(pts, zs)]
    Z = [0 if p is None else z for p, z in zip(pts, zs)]
    return X, Y, Z


def _same_point(a, b, q):
    if not any(v % q for v in a) or not any(v % q for v in b):
        return False
    return all((a[i] * b[j] - a[j] * b[i]) % q == 0
               for i, j in ((0, 1), (0, 2), (1, 2)))


class _Sides:
    """The JAX plan (interpret mode) and the port's ops over one curve."""

    def __init__(self, case):
        spec, b, host, gen = FIELDS[case]()
        self.spec, self.host, self.gen, self.q = spec, host, gen, spec.modulus
        self.JF = jax_field_ops(spec)
        self.jplan = self.run_jax(
            jax_msm.MSM, JaxCurveOps(self.JF, b=b), C * R, 1, c=CW, lanes=R,
            method="window_pallas", signed=True)
        self.F = field_ops(spec)
        self.GC = M.complete_ops(CurveOps(self.F, b=b))
        self.L = self.F.L

    @staticmethod
    def run_jax(fn, *args, **kwargs):
        old = jax_msm._INTERPRET
        jax_msm._INTERPRET = True
        try:
            return fn(*args, **kwargs)
        finally:
            jax_msm._INTERPRET = old

    def jax_points(self, planes):
        """(X, Y, Z) JAX arrays [L, ...] -> list of int triples."""
        return list(zip(*(self.JF.unpack(np.asarray(a).reshape(self.L, -1))
                          for a in planes)))

    def port_points(self, t):
        """[3L, ...] port tensor -> list of int triples."""
        return list(zip(*(self.F.unpack(a.reshape(self.L, -1))
                          for a in M.split_points(t, self.L))))

    def assert_same(self, jax_pts, port_pts):
        assert len(jax_pts) == len(port_pts)
        assert any(p[2] % self.q for p in port_pts), "all the identity"
        bad = [i for i, (a, c) in enumerate(zip(jax_pts, port_pts))
               if not _same_point(a, c, self.q)]
        assert not bad, f"outputs that differ: {bad}"


def _leaf(case):
    S = _Sides(case)
    q, L = S.q, S.L
    rng = np.random.default_rng(23)
    pts = [S.host.scalar_mul(S.gen, int(k))
           for k in rng.integers(1, 1 << 30, size=NW * C * R)]
    pts[5] = pts[4]                       # P + P inside a lane's chain
    flags = rng.integers(0, 4, size=NW * C * R)   # bit 0 inf, bit 1 sign
    flags[:: 7] = 1
    xs = S.F.pack([p[0] for p in pts], "cpu").reshape(L, NW, C, R)
    ys = S.F.pack([p[1] for p in pts], "cpu").reshape(L, NW, C, R)
    ys[0] += torch.from_numpy(flags.astype(np.int64)).reshape(
        NW, C, R) << 16
    sx = xs.permute(1, 2, 0, 3).contiguous()          # [nw, C, L, R]
    sy = ys.permute(1, 2, 0, 3).contiguous()
    rows = M.leaf_prefix_plain(sx, sy, S.GC)          # [nw, C*R, 3L]
    jrows = S.run_jax(S.jplan._leaf_prefix_pallas,
                      jnp.asarray(sx.numpy().astype(np.uint32)),
                      jnp.asarray(sy.numpy().astype(np.uint32)), NW)
    jr = np.asarray(jrows).astype(np.int64).reshape(-1, 3 * L).T
    pr = rows.reshape(-1, 3 * L).T
    S.assert_same(S.port_points(torch.from_numpy(jr)), S.port_points(pr))
    # and the host chain: row cs*R + r is lane r's sum after step cs
    want = []
    for w in range(NW):
        acc = [None] * R
        for cs in range(C):
            for r in range(R):
                i = ((w * C + cs) * R) + r
                f = int(flags.reshape(NW, C, R)[w, cs, r])
                if not f & 1:
                    p = pts[i]
                    acc[r] = S.host.add(acc[r], S.host.neg(p) if f & 2 else p)
                want.append(acc[r])
    got = [None if not z % q else (x * pow(z, -1, q) % q,
                                   y * pow(z, -1, q) % q)
           for x, y, z in S.port_points(pr)]
    assert got == want


def _weighted_sum(case):
    S = _Sides(case)
    nb = S.jplan.nb
    assert nb == 1 << (CW - 1)
    X, Y, Z = _projective(S.spec, S.host, S.gen, NW * nb, 29)
    bk = torch.cat([S.F.pack(v, "cpu").reshape(S.L, NW, nb)
                    for v in (X, Y, Z)])
    got = M.weighted_sum_plain(bk, S.GC)                  # [3L, nw]
    jb = tuple(jnp.asarray(S.JF.pack(v)).reshape(S.L, NW, nb)
               for v in (X, Y, Z))
    out = S.run_jax(S.jplan._weighted_sum_pallas, jb, NW)
    S.assert_same(S.jax_points(out), S.port_points(got))


def _horner(case):
    S = _Sides(case)
    X, Y, Z = (v[:4] for v in _projective(S.spec, S.host, S.gen, 8, 31))
    for v in (X, Y, Z):                 # windows 2 and 3 the identity
        v[3] = v[2]
    S_port = torch.cat([S.F.pack(v, "cpu").reshape(S.L, 4) for v in (X, Y, Z)])
    got = M.horner_fold_plain(S_port, CW, S.GC)
    js = tuple(jnp.asarray(S.JF.pack(v)).reshape(S.L, 4, 1) for v in (X, Y, Z))
    jplan = S.jplan
    out = S.run_jax(jplan._horner_fold_pallas, js)
    S.assert_same(S.jax_points(out), S.port_points(got))


def _buckets(case):
    S = _Sides(case)
    jplan = S.jplan
    n = C * R
    rng = np.random.default_rng(37)
    pts = [S.host.scalar_mul(S.gen, int(k))
           for k in rng.integers(1, 1 << 30, size=n)]
    pts[6] = pts[5]
    inf = rng.random(n) < 0.15
    scalars = rng.integers(0, 1 << 16, size=(1, n)).astype(np.uint32)
    scalars[0, [3, 11]] = 0
    xs = np.asarray(S.JF.pack([p[0] for p in pts]))
    ys = np.asarray(S.JF.pack([p[1] for p in pts]))
    ptrows, dg, sg = jplan._prep_window(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(inf),
        jnp.asarray(scalars))
    # the reference's buckets: its weighted sum (this instance's only)
    # hands them back
    jplan._weighted_sum_pallas = lambda buckets, nw: buckets
    jb = S.run_jax(jplan._window_chunk, ptrows, dg, sg)
    # the port's steps on the same rows and digits
    nb = jplan.nb
    dg, sg = (torch.from_numpy(np.asarray(a).astype(np.int64))
              for a in (dg, sg))
    assert bool((dg == 0).any()) and bool((sg != 0).any())
    tplan = M.MSM.__new__(M.MSM)
    tplan.R, tplan.C, tplan.n_pad = R, C, n
    sx, sy, d = tplan._sort_gather(
        torch.from_numpy(np.asarray(ptrows).astype(np.int64)), dg, sg)
    rows = M.leaf_prefix_plain(sx, sy, S.GC)
    offs = M.lane_offsets_plain(tplan.lane_totals(rows), S.GC)
    got = M.buckets_plain(rows, offs, d, C, R, nb, S.GC)
    assert got.shape == (3 * S.L, dg.shape[0], nb)
    jpts = S.jax_points(jb)
    assert not all(p[2] % S.q for p in jpts), "no empty bucket"
    S.assert_same(jpts, S.port_points(got))


KERNELS = {"leaf_prefix": _leaf, "buckets": _buckets,
           "weighted_sum": _weighted_sum, "horner_fold": _horner}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_matches_jax_pallas_interpret_p62(kernel):
    KERNELS[kernel]("p62")


@pytest.mark.slow
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_matches_jax_pallas_interpret_bn254_g1(kernel):
    KERNELS[kernel]("bn254_g1")
