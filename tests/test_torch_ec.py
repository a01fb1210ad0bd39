"""gnark_tpu_torch.ops.ec_complete / ec / fixed_base against the host
curves (gnark_tpu.curves.host_g1 / host_g2).

Tolerance: none.  Projective and Jacobian results are compared as group
elements: converted to affine with Python ints and compared exactly.
"""

import random

import numpy as np
import pytest
import torch

from gnark_tpu.curves import BN254
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.ec_complete import CompleteOps
from gnark_tpu_torch.ops.fixed_base import FixedBaseTable
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops

torch.set_num_threads(1)


def _group(kind):
    if kind == "g1":
        F = field_ops(BN254.fp)
        return F, BN254.b, BN254.host_g1, BN254.g1_gen, 0
    F = fp2_ops(BN254.fp, BN254.fp2_beta)
    return F, BN254.b2, BN254.host_g2, BN254.g2_gen, (0, 0)


def _proj_to_host(H, F, P):
    """Projective (X : Y : Z) batch -> host affine points (None = id)."""
    X, Y, Z = (F.unpack(a.reshape(a.shape[0], -1)) for a in P)
    out = []
    for x, y, z in zip(X, Y, Z):
        if H.F.is_zero(z):
            out.append(None)
            continue
        zi = H.F.inv(z)
        out.append((H.F.mul(x, zi), H.F.mul(y, zi)))
    return out


def _pairs(H, gen):
    """Point pairs covering P + Q, P + P, P + (-P) and the identity."""
    P = [H.scalar_mul(gen, k) for k in (3, 5, 7, 11, 13)]
    left = [P[0], P[1], P[2], None, P[3], None]
    right = [P[4], P[1], H.neg(P[2]), P[3], None, None]
    return left, right


def _to_proj(F, pts, zero, scale_seed=None):
    """Host affine list -> projective batch; identity as (0 : 1 : 0);
    finite points optionally rescaled by a random Z."""
    rnd = random.Random(scale_seed)
    X, Y, Z = F.pack([zero if p is None else p[0] for p in pts], "cpu"), \
        F.pack([zero if p is None else p[1] for p in pts], "cpu"), None
    inf = torch.tensor([p is None for p in pts])
    one = F.ones_like(X)
    Z = torch.where(inf.unsqueeze(0), torch.zeros_like(X), one)
    Y = torch.where(inf.unsqueeze(0), one, Y)
    if scale_seed is not None:
        p = BN254.fp.modulus
        if zero == 0:
            lam = F.pack([rnd.randrange(1, p) for _ in pts], "cpu")
        else:
            lam = F.pack([(rnd.randrange(1, p), rnd.randrange(p))
                          for _ in pts], "cpu")
        X, Y, Z = F.mul(X, lam), F.mul(Y, lam), F.mul(Z, lam)
    return (X, Y, Z), inf


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_complete_add_matches_host(kind):
    F, b, H, gen, zero = _group(kind)
    GC = CompleteOps(F, b)
    left, right = _pairs(H, gen)
    P, _ = _to_proj(F, left, zero, scale_seed=1)
    Q, _ = _to_proj(F, right, zero, scale_seed=2)
    got = _proj_to_host(H, F, GC.add(P, Q))
    assert got == [H.add(a, c) for a, c in zip(left, right)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_complete_add_mixed_matches_host(kind):
    F, b, H, gen, zero = _group(kind)
    GC = CompleteOps(F, b)
    left, right = _pairs(H, gen)
    P, _ = _to_proj(F, left, zero, scale_seed=3)
    xs = F.pack([zero if q is None else q[0] for q in right], "cpu")
    ys = F.pack([zero if q is None else q[1] for q in right], "cpu")
    q_inf = torch.tensor([q is None for q in right])
    got = _proj_to_host(H, F, GC.add_mixed(P, (xs, ys), q_inf))
    assert got == [H.add(a, c) for a, c in zip(left, right)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_complete_double_and_identity_class(kind):
    F, b, H, gen, zero = _group(kind)
    GC = CompleteOps(F, b)
    pts = [H.scalar_mul(gen, k) for k in (1, 2, 9)] + [None]
    P, _ = _to_proj(F, pts, zero, scale_seed=4)
    assert _proj_to_host(H, F, GC.double(P)) == [H.double(p) for p in pts]
    # mask_inf forces (0 : 1 : 0), which adds as the identity
    valid = torch.tensor([True, False, True, True])
    M = GC.mask_inf(P, valid)
    assert bool(F.is_zero(M[0][:, 1])) and bool(F.is_zero(M[2][:, 1]))
    got = _proj_to_host(H, F, GC.add(M, P))
    want = [H.add(p, p) if v else p for p, v in zip(pts, valid.tolist())]
    assert got == want


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_mul_b3_routes(kind):
    """G1's b3 = 9 takes the small route; G2's b3 = 3b' is not small and
    takes the Montgomery constant route."""
    F, b, H, gen, zero = _group(kind)
    GC = CompleteOps(F, b)
    p = BN254.fp.modulus
    rnd = random.Random(9)
    if kind == "g1":
        assert GC._b3_small == 9
        xs = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(8)]
        want = [9 * x % p for x in xs]
    else:
        assert GC._b3_small is None
        b3 = H.F.mul((3, 0), b)
        xs = [(0, 0), (1, 0), (p - 1, 1)] + [
            (rnd.randrange(p), rnd.randrange(p)) for _ in range(8)]
        want = [H.F.mul(x, b3) for x in xs]
    assert F.unpack(GC._mul_b3(F.pack(xs, "cpu"))) == want


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_to_jacobian_keeps_the_point(kind):
    F, b, H, gen, zero = _group(kind)
    GC, G = CompleteOps(F, b), CurveOps(F, b)
    pts = [H.scalar_mul(gen, k) for k in (4, 6)] + [None]
    P, _ = _to_proj(F, pts, zero, scale_seed=5)
    assert points_to_host(G, GC.to_jacobian(P)) == pts


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_jacobian_ops_match_host(kind):
    F, b, H, gen, zero = _group(kind)
    G = CurveOps(F, b)
    left, right = _pairs(H, gen)
    P, _ = _to_proj(F, left, zero, scale_seed=6)   # Z = lam is Jacobian-
    P = (F.mul(P[0], P[2]), F.mul(P[1], F.sqr(P[2])), P[2])  # rescaled
    Q, _ = _to_proj(F, right, zero)
    assert points_to_host(G, G.add(P, Q)) == [
        H.add(a, c) for a, c in zip(left, right)]
    assert points_to_host(G, G.double(P)) == [H.double(a) for a in left]
    xs = F.pack([zero if q is None else q[0] for q in right], "cpu")
    ys = F.pack([zero if q is None else q[1] for q in right], "cpu")
    q_inf = torch.tensor([q is None for q in right])
    assert points_to_host(G, G.add_mixed(P, (xs, ys), q_inf)) == [
        H.add(a, c) for a, c in zip(left, right)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_fixed_base_matches_host_scalar_mul(kind):
    F, b, H, gen, zero = _group(kind)
    G = CurveOps(F, b)
    r = BN254.fr.modulus
    rng = np.random.default_rng(21)
    scalars = [0, 1, r - 1, 2] + [
        int.from_bytes(rng.bytes(32), "little") % r for _ in range(4)]
    table = FixedBaseTable(G, H, gen, BN254.fr.L * 16, "cpu")
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(np.int64))
    got = points_to_host(G, table(sc))
    assert got == [H.scalar_mul(gen, s) for s in scalars]


def test_fixed_base_window_width_and_a_wide_table():
    """Setup's fixed-base tables take the default 8-bit windows at every
    size (the table's host additions cost thousands of the kernel's
    column windows, so a wider one never pays at a key's sizes); a table
    of 12-bit windows gives the same points."""
    F, b, H, gen, zero = _group("g1")
    G = CurveOps(F, b)
    r = BN254.fr.modulus
    scalars = [0, 1, r - 1, (1 << 240) + 12345, 4095, 4096]
    setup_table = FixedBaseTable(G, H, gen, BN254.fr.L * 16, "cpu")
    assert (setup_table.c, setup_table.nwin) == (8, 32)
    table = FixedBaseTable(G, H, gen, BN254.fr.L * 16, "cpu", c=12)
    assert table.nwin == 22
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(np.int64))
    want = [H.scalar_mul(gen, s) for s in scalars]
    assert points_to_host(G, table(sc)) == want
    assert points_to_host(G, setup_table(sc)) == want
