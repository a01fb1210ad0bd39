"""gnark_tpu_torch over the other five curves against gnark_tpu.

  * the field ops at L = 20 (BLS24-315's fp, BW6-633's fr) and L = 24
    (BLS12-377's fp = BW6-761's fr, BLS12-381's fp) against Python ints
    and gnark_tpu's numpy field, limb for limb;
  * Fp2 with beta = -5 (BLS12-377) and FpKOps (BLS24-315's fp4, k = 4,
    c = 13) against gnark_tpu's Fp2Ops / FpKOps (products) and host
    fields (inverses: gnark_tpu's FpKOps.inv exponentiates by q + q^2 +
    q^3, minutes on the CPU);
  * the complete point formulas over BLS24-315's G1 and G2 (fp4) against
    the host curves; the MSM kernels' kind of each group (BLS24-315's two
    have kernels, the L >= 24 curves none);
  * BLS24-315 MSMs through the plain path (the ladder, and the windowed
    plan at a small plan) against the host oracle, and G1's against
    gnark_tpu's native Pippenger;
  * the native core's MSM and fixed-base over fp2 (BLS12's G2) against
    the host curves;
  * Groth16 in host mode over all five curves: the port's key equals
    gnark_tpu's, and the port's proof on proving_key_from_jax(pk) equals
    gnark_tpu's, verifies, and rejects a wrong public input; the device
    path (device="cpu") over BLS12-381 and BW6-761, gnark_tpu's native
    route, gives the same key points and proof; gnark_tpu's own device
    setup over BLS12-381 fails on its fp2 G2 (the defect the port's
    native core repairs);
  * PLONK in host mode over BLS12-381 and BLS24-315: the same verifying
    key and proof as gnark_tpu's, and the device path (device="cpu") on
    plonk_key_from_jax(pk) the same proof.

(BLS24-315's device-path Groth16 proof on the CPU runs plain fp4 ladders:
tests/test_torch_curves_bls24.py, a worker of its own.)

Inputs come from seeds (numpy and random.Random).  Tolerance: none; field
elements and points compare exactly, as Python ints.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.backend import plonk as jp
from gnark_tpu.backend.native_field import native_msm as jax_native_msm
from gnark_tpu.curves import ALL_CURVES as JAX_CURVES
from gnark_tpu.curves.host import HostFpK as JaxHostFpK
from gnark_tpu.fields.np_field import np_field
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu.ops.towers import fp2_ops as jax_fp2_ops
from gnark_tpu.ops.towers import fpk_ops as jax_fpk_ops
import gnark_tpu_torch.frontend.schema as torch_schema
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.backend.native_field import (
    native_fixed_base_affine, native_msm)
from gnark_tpu_torch.curves import (
    ALL_CURVES, BLS12_377, BLS12_381, BLS24_315, BW6_633, BW6_761)
from gnark_tpu_torch.curves.host import HostFp2, HostFpK
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import points_to_host
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops, fpk_ops

torch.set_num_threads(1)

OTHER = ["bls12_381", "bls12_377", "bls24_315", "bw6_761", "bw6_633"]


# ---- fields ---------------------------------------------------------------

WIDE_SPECS = {"bls24_315_fp (L=20)": BLS24_315.fp,
              "bls12_377_fp (L=24)": BLS12_377.fp,
              "bls12_381_fp (L=24)": BLS12_381.fp}


def _operands(p, seed, n=24):
    rnd = random.Random(seed)
    edges = [0, 1, p - 1, p - 2, 2, (1 << (p.bit_length() - 1)) % p]
    return (edges + [rnd.randrange(p) for _ in range(n)],
            list(reversed(edges)) + [rnd.randrange(p) for _ in range(n)])


def test_slack_bit_limb_counts():
    """fields/spec.py's L, with its slack bit, at the widths of these
    curves: what the kernels' N = L / 2 words rest on."""
    assert [BLS24_315.fp.L, BW6_633.fr.L] == [20, 20]
    assert [BLS12_377.fp.L, BW6_761.fr.L, BLS12_381.fp.L] == [24, 24, 24]
    assert [BW6_633.fp.L, BW6_761.fp.L] == [40, 48]
    for spec in WIDE_SPECS.values():
        assert 2 * spec.modulus < 1 << (16 * spec.L)


@pytest.mark.parametrize("name", sorted(WIDE_SPECS))
def test_field_ops_at_l20_and_l24_match_ints_and_np_field(name):
    spec = WIDE_SPECS[name]
    F, p = field_ops(spec), spec.modulus
    xs, ys = _operands(p, len(name))
    a, b = F.pack(xs, "cpu"), F.pack(ys, "cpu")
    for got, want in (
            (F.add(a, b), [(x + y) % p for x, y in zip(xs, ys)]),
            (F.sub(a, b), [(x - y) % p for x, y in zip(xs, ys)]),
            (F.mul(a, b), [x * y % p for x, y in zip(xs, ys)]),
            (F.mul_small(a, 13), [13 * x % p for x in xs]),
            (F.batch_inv(a), [pow(x, -1, p) if x else 0 for x in xs])):
        assert F.unpack(got) == want
    # raw Montgomery limbs, gnark_tpu's numpy field against the port's
    jspec = JAX_CURVES[spec.name.rsplit("_", 1)[0]].fp
    assert jspec.modulus == p and jspec.L == spec.L
    N = np_field(jspec)
    na, nb = N.pack(xs, mont=True), N.pack(ys, mont=True)
    assert np.array_equal(na.astype(np.int64), a.numpy())
    for nfn, tfn in ((N.mmul, F.mul), (N.add, F.add), (N.sub, F.sub)):
        assert np.array_equal(nfn(na, nb).astype(np.int64),
                              tfn(a, b).numpy())


def test_fp2_beta_minus_5_matches_jax_and_host():
    q = BLS12_377.fp.modulus
    F, J = fp2_ops(BLS12_377.fp, -5), jax_fp2_ops(JAX_CURVES["bls12_377"].fp, -5)
    H = HostFp2(q, -5)
    rnd = random.Random(5)
    xs = [(rnd.randrange(q), rnd.randrange(q)) for _ in range(6)] + [(0, 1)]
    ys = [(rnd.randrange(q), rnd.randrange(q)) for _ in range(6)] + [(q - 1, 0)]
    a, b = F.pack(xs, "cpu"), F.pack(ys, "cpu")
    prod = F.unpack(F.mul(a, b))
    assert prod == J.unpack(J.mul(J.pack(xs), J.pack(ys)))
    assert prod == [H.mul(x, y) for x, y in zip(xs, ys)]
    assert F.unpack(F.inv(a)) == [H.inv(x) for x in xs]
    assert F.unpack(F.sub(a, b)) == [H.sub(x, y) for x, y in zip(xs, ys)]


def test_fpk_ops_match_jax_and_host():
    p = BLS24_315.fp.modulus
    F = fpk_ops(BLS24_315.fp, 4, 13)
    J = jax_fpk_ops(JAX_CURVES["bls24_315"].fp, 4, 13)
    H, JH = HostFpK(p, 4, 13), JaxHostFpK(p, 4, 13)
    rnd = random.Random(6)
    xs = [tuple(rnd.randrange(p) for _ in range(4)) for _ in range(5)] + [
        (0, 0, 0, 0), (1, 0, 0, 0), (0, 0, 0, p - 1), (0, 5, 0, 0)]
    ys = [tuple(rnd.randrange(p) for _ in range(4)) for _ in range(5)] + [
        (p - 1, p - 1, p - 1, p - 1), (0, 0, 1, 0), (3, 0, 0, 0),
        (0, 0, 0, 1)]
    a, b = F.pack(xs, "cpu"), F.pack(ys, "cpu")
    prod = F.unpack(F.mul(a, b))
    ja, jb = J.pack(xs), J.pack(ys)
    assert prod == J.unpack(J.mul(ja, jb))
    assert F.unpack(F.add(a, b)) == J.unpack(J.add(ja, jb))
    assert F.unpack(F.sub(a, b)) == J.unpack(J.sub(ja, jb))
    assert F.unpack(F.neg(a)) == J.unpack(J.neg(ja))
    assert prod == [H.mul(x, y) for x, y in zip(xs, ys)]
    inv = F.unpack(F.inv(a))
    assert inv == [(0,) * 4 if x == (0,) * 4 else JH.inv(x) for x in xs]
    assert all(H.mul(x, v) == H.one for x, v in zip(xs, inv) if any(x))


# ---- groups ---------------------------------------------------------------

def _bls24_group(kind):
    K = tg._Groups(BLS24_315)
    if kind == "g1":
        return K.g1, BLS24_315.host_g1, BLS24_315.g1_gen
    return K.g2, BLS24_315.host_g2, BLS24_315.g2_gen


def _points(H, gen, n):
    out, P = [], gen
    for _ in range(n):
        out.append(P)
        P = H.add(P, gen)
    return out


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_bls24_complete_ops_match_host(kind):
    """add (P + Q, P + P, P + (-P), identity + P), add_mixed (with an
    infinity flag) and double, as affine points."""
    G, H, gen = _bls24_group(kind)
    GC = M.complete_ops(G)
    F = G.F
    pts = _points(H, gen, 5)
    P = pts + [pts[0], pts[1]]
    Q = [pts[4], pts[3], pts[2], pts[1], pts[0], pts[0], H.neg(pts[1])]
    xs = F.pack([p[0] for p in P], "cpu")
    ys = F.pack([p[1] for p in P], "cpu")
    qx = F.pack([q[0] for q in Q], "cpu")
    qy = F.pack([q[1] for q in Q], "cpu")
    one = F.ones(7, "cpu")
    A = (xs, ys, one)
    Bq = (qx, qy, one)
    ident = GC.inf(7, "cpu")

    def host(R):
        return points_to_host(G, GC.to_jacobian(R))

    assert host(GC.add(A, Bq)) == [H.add(p, q) for p, q in zip(P, Q)]
    assert host(GC.add(ident, Bq)) == Q
    assert host(GC.double(A)) == [H.double(p) for p in P]
    flags = torch.tensor([False, True, False, False, False, False, False])
    want = [p if f else H.add(p, q) for p, q, f in zip(P, Q, flags.tolist())]
    assert host(GC.add_mixed(A, (qx, qy), flags)) == want


def test_kernel_kinds_by_curve():
    """BLS24-315's groups have kernels; the L >= 24 curves' none (their
    MSMs take the native core: native_route)."""
    kinds = {}
    for name, curve in ALL_CURVES.items():
        K = tg._Groups(curve)
        for g, G in (("g1", K.g1), ("g2", K.g2)):
            try:
                kinds[f"{name} {g}"] = _cuda.kind_of(M.complete_ops(G))
            except NotImplementedError:
                kinds[f"{name} {g}"] = None
        assert tg.native_route(curve) == (curve.fp.L >= 24)
    assert kinds == {
        "bn254 g1": "g1", "bn254 g2": "g2",
        "bls24_315 g1": "g1_bls24315", "bls24_315 g2": "g2_bls24315",
        **{f"{n} {g}": None for n in ("bls12_381", "bls12_377", "bw6_761",
                                      "bw6_633") for g in ("g1", "g2")}}
    assert sorted(n for n, c in ALL_CURVES.items() if tg.native_route(c)) \
        == ["bls12_377", "bls12_381", "bw6_633", "bw6_761"]


def _msm_inputs(kind, n, seed):
    G, H, gen = _bls24_group(kind)
    r = BLS24_315.fr.modulus
    pts = _points(H, gen, n)
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
    scalars[1] = 0
    inf = np.zeros(n, bool)
    inf[2] = True
    args = (G.F.pack([p[0] for p in pts], "cpu"),
            G.F.pack([p[1] for p in pts], "cpu"), torch.from_numpy(inf),
            torch.from_numpy(ints_to_limbs(scalars, 16).astype(np.int64)))
    want = None
    for p, s, i in zip(pts, scalars, inf):
        if not i:
            want = H.add(want, H.scalar_mul(p, s))
    return G, pts, scalars, inf, args, want


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_bls24_msms_plain_match_host_oracle(kind):
    """The ladder MSM (what ``msm`` takes below 8192 points) and the
    windowed plan at c = 6, 4 lanes, over 24 points with a zero scalar and
    an infinity point; G1's also against gnark_tpu's native Pippenger."""
    G, pts, scalars, inf, args, want = _msm_inputs(kind, 24, 91)
    assert points_to_host(G, M.msm(G, *args)) == [want]
    plan = M.MSM(G, 24, 16, c=6, lanes=4)
    assert points_to_host(G, plan(*args)) == [want]
    if kind == "g1":
        L = BLS24_315.fp.L
        xs = ints_to_limbs([p[0] for p in pts], L)
        ys = ints_to_limbs([p[1] for p in pts], L)
        got = jax_native_msm(JAX_CURVES["bls24_315"], xs, ys, inf,
                             ints_to_limbs(scalars, 16))
        assert got == want


@pytest.mark.parametrize("curve", [BLS12_381, BLS12_377],
                         ids=lambda c: c.name)
def test_native_core_over_fp2_matches_host(curve):
    """The native core's fixed-base and Pippenger over fp2 (beta -1 and
    -5): BLS12's G2 on the native route."""
    q, H, beta = curve.fr.modulus, curve.host_g2, curve.fp2_beta
    rnd = random.Random(17)
    sc = [rnd.randrange(q) for _ in range(12)] + [0]
    pts = native_fixed_base_affine(curve, sc, curve.g2_gen, beta=beta)
    assert pts == [None if s == 0 else H.scalar_mul(curve.g2_gen, s)
                   for s in sc]
    ws = [rnd.randrange(q) for _ in sc]
    L = curve.fp.L

    def planes(i):
        return np.concatenate([ints_to_limbs(
            [0 if p is None else p[i][j] for p in pts], L) for j in range(2)])

    got = native_msm(curve, planes(0), planes(1),
                     np.array([p is None for p in pts]),
                     ints_to_limbs(ws, curve.fr.L), beta=beta)
    want = None
    for p, w in zip(pts, ws):
        if p is not None:
            want = H.add(want, H.scalar_mul(p, w))
    assert got == want


# ---- Groth16 ------------------------------------------------------------------

def cubic_circuit(schema):
    class Cubic(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))
    return Cubic()


_KEYS = {}


def _host_keys(name):
    if name not in _KEYS:
        jcs = jax_compile(cubic_circuit(jax_schema), JAX_CURVES[name])
        cs = compile_circuit(cubic_circuit(torch_schema), ALL_CURVES[name])
        jpk, jvk = jg.setup(jcs, JAX_CURVES[name], rng=random.Random(1),
                            host=True)
        tpk, tvk = tg.setup(cs, ALL_CURVES[name], rng=random.Random(1),
                            host=True)
        jproof = jg.prove(jcs, jpk, [35, 3], rng=random.Random(2))
        _KEYS[name] = (cs, jpk, jvk, tpk, tvk, jproof)
    return _KEYS[name]


def _proof(p):
    return (p.ar, p.bs, p.krs)


@pytest.mark.parametrize("name", OTHER)
def test_groth16_host_mode_equals_jax(name):
    cs, jpk, jvk, tpk, tvk, jproof = _host_keys(name)
    for f in ("A", "B1", "B2", "K", "Z"):
        assert list(getattr(tpk, f)) == list(getattr(jpk, f)), f
    assert (tvk.K, tvk.alpha_g1, tvk.delta_g2, tvk.e_alpha_beta) == (
        jvk.K, jvk.alpha_g1, jvk.delta_g2, jvk.e_alpha_beta)
    key = tg.proving_key_from_jax(jpk)
    assert key.host
    proof = tg.prove(cs, key, [35, 3], rng=random.Random(2))
    assert _proof(proof) == _proof(jproof)
    assert _proof(tg.prove(cs, tpk, [35, 3], rng=random.Random(2))) == \
        _proof(jproof)
    assert tg.verify(proof, tvk, [35])
    assert jg.verify(jg.Proof(*_proof(proof)), jvk, [35])
    assert not tg.verify(proof, tvk, [34])


@pytest.mark.parametrize("name", ["bls12_381", "bw6_761", "bw6_633"])
def test_groth16_device_path_on_cpu_equals_jax(name):
    """gnark_tpu's native route (fp.L >= 24): the key points on the
    native core, the quotient on the device, the five MSMs on the native
    core; the same key and proof as gnark_tpu's host mode."""
    cs, jpk, jvk, tpk, tvk, jproof = _host_keys(name)
    curve = ALL_CURVES[name]
    pk, vk = tg.setup(cs, curve, rng=random.Random(1), device="cpu")
    assert not pk.host and pk.device == torch.device("cpu")
    K = tg._Groups(curve)
    for f in ("A", "B1", "B2", "K", "Z"):
        G = K.g2 if f == "B2" else K.g1
        # the native core's planes stay numpy: no device reads them
        x, y, inf = getattr(pk, f)
        assert all(isinstance(a, np.ndarray) for a in (x, y, inf)), f
        x, y = (torch.from_numpy(a.astype(np.int64)) for a in (x, y))
        got = [None if i else (a, b) for a, b, i in zip(
            G.F.unpack(x), G.F.unpack(y), inf.tolist())]
        assert got == list(getattr(jpk, f)), f
    seen = []
    orig = tg.compute_h

    def watched(domain, a, b, c):
        seen.append(domain.device)
        return orig(domain, a, b, c)

    tg.compute_h = watched
    try:
        proof = tg.prove(cs, pk, [35, 3], rng=random.Random(2))
        dev_proof = tg.prove(cs, tg.proving_key_from_jax(jpk, "cpu"),
                             [35, 3], rng=random.Random(2))
    finally:
        tg.compute_h = orig
    assert seen == [torch.device("cpu")] * 2       # the quotient's NTTs
    assert _proof(proof) == _proof(jproof) == _proof(dev_proof)
    assert tg.verify(proof, vk, [35]) and not tg.verify(proof, vk, [34])


def test_jax_device_setup_fails_on_bls12_g2_and_port_repairs_it():
    """gnark_tpu's device setup over BLS12-381 sends G2's fp2 generator to
    a native fixed-base that takes fp ints and raises (groth16.py:437,
    native_field.py:318); the port's native core takes fp2 and gives the
    host mode's key (test above)."""
    jcs = jax_compile(cubic_circuit(jax_schema), JAX_CURVES["bls12_381"])
    with pytest.raises(TypeError):
        jg.setup(jcs, JAX_CURVES["bls12_381"], rng=random.Random(1))


def test_host_key_round_trip_through_the_device():
    """pk_to_device packs a host key's points; the proof is the same."""
    cs, jpk, jvk, tpk, tvk, jproof = _host_keys("bw6_633")
    dpk = tg.pk_to_device(tpk, "cpu")
    assert not dpk.host and dpk.A[0].shape == (BW6_633.fp.L, tpk.n_pad)
    assert _proof(tg.prove(cs, dpk, [35, 3], rng=random.Random(2))) == \
        _proof(jproof)
    with pytest.raises(ValueError):
        tg.proving_key_from_jax(dataclasses.replace(jpk, host=False))


# ---- PLONK ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bls12_381", "bls24_315"])
def test_plonk_host_mode_equals_jax(name):
    jcs = jax_compile(cubic_circuit(jax_schema), JAX_CURVES[name],
                      scheme="plonk")
    cs = compile_circuit(cubic_circuit(torch_schema), ALL_CURVES[name],
                         scheme="plonk")
    jpk, jvk = jp.setup(jcs, JAX_CURVES[name], rng=random.Random(4),
                        host=True)
    tpk, tvk = tp.setup(cs, ALL_CURVES[name], rng=random.Random(4),
                        host=True)
    assert dataclasses.astuple(tvk)[1:] == dataclasses.astuple(jvk)[1:]
    jproof = jp.prove(jcs, jpk, [35, 3], rng=random.Random(5))
    proof = tp.prove(cs, tpk, [35, 3], rng=random.Random(5))
    assert dataclasses.astuple(proof) == dataclasses.astuple(jproof)
    assert tp.verify(proof, tvk, [35]) and not tp.verify(proof, tvk, [34])
    if name == "bls12_381":          # native commitments, device NTTs
        dev = tp.prove(cs, tp.plonk_key_from_jax(jpk, "cpu"), [35, 3],
                       rng=random.Random(5))
        assert dataclasses.astuple(dev) == dataclasses.astuple(jproof)
