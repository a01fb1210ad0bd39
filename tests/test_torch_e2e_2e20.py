"""The 2^20 Groth16 prove's pieces on the CPU, against gnark_tpu.

  * the windowed MSM plan in window chunks (``max_bytes`` forcing two and
    three): BN254 G1 and G2 at 1,024 points give the one-chunk plan's
    limbs bit for bit, and the point equals gnark_tpu's (its native
    Pippenger for G1, its host curve for G2);
  * the entry point ``gnark_tpu_torch.scripts.dev_e2e_2e20.run`` on its
    device route, the CPU as the device: over BN254 at log2_n = 5 its
    proof equals gnark_tpu's for the same circuit and rngs (42 for setup,
    7 for each prove), byte for byte, and at log2_n = 8 over BLS12-381
    (the native route) its proof verifies, while gnark_tpu's device setup
    there raises (ROADMAP Queue 3 item 2); each verifies and rejects
    y + 1.

The 2^20 run itself needs the card (chip_smoke.py phase 14).  Tolerance:
none; limbs compare exactly, points and proofs as Python ints.
"""

import random

import numpy as np
import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.backend.native_field import native_msm
from gnark_tpu.curves import BLS12_381 as JBLS12_381
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import points_to_host
from gnark_tpu_torch.ops.limbs import ints_to_limbs
from gnark_tpu_torch.scripts import dev_e2e_2e20 as E
from torch_kinds import group

torch.set_num_threads(1)
N = 1024


def _inputs(kind, seed, limbs):
    """N points, point i = 2^(i mod 64) G, one in 97 flagged infinite, and
    scalars of ``limbs`` 16-bit limbs (below r) with a few zeros."""
    G, H, gen, _ = group(kind)
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    xs = G.F.pack([p[0] for p in base], "cpu").repeat(1, N // 64)
    ys = G.F.pack([p[1] for p in base], "cpu").repeat(1, N // 64)
    inf = torch.zeros(N, dtype=torch.bool)
    inf[::97] = True
    rng = np.random.default_rng(seed)
    q = JBN254.fr.modulus
    scalars = [int.from_bytes(rng.bytes(2 * limbs), "little") % q
               for _ in range(N)]
    scalars[5] = scalars[300] = 0
    sc = torch.from_numpy(ints_to_limbs(scalars, limbs).astype(np.int64))
    return G, base, xs, ys, inf, scalars, sc


# (kind, scalar limbs, windows of the plan at c = 7, windows a chunk at two
# and at three chunks).  G2's plain steps cost three times G1's on the CPU,
# so its scalars are 128 bits: 19 windows, not 37.
CHUNK_CASES = [("g1", 16, 37, 19, 13), ("g2", 8, 19, 10, 7)]


@pytest.mark.parametrize("kind,limbs,nwin,two,three", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_window_chunks_equal_one_chunk_plan_and_gnark_tpu(kind, limbs, nwin,
                                                          two, three):
    G, base, xs, ys, inf, scalars, sc = _inputs(kind, 61, limbs)
    one = M.MSM(G, N, limbs)
    per = M.window_bytes(one.n_pad, G.F.L)
    assert one.chunks("cpu") == [(0, nwin)] and one.c == 7
    want = one(xs, ys, inf, sc)
    for max_bytes, nchunks in ((two * per, 2), (three * per, 3)):
        plan = M.MSM(G, N, limbs, max_bytes=max_bytes)
        assert len(plan.chunks("cpu")) == nchunks, plan.chunks("cpu")
        got = plan(xs, ys, inf, sc)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), nchunks
    q = JBN254.fr.modulus
    live = [(i, s) for i, s in enumerate(scalars) if not inf[i]]
    if kind == "g1":
        p = JBN254.fp
        pts = [base[i % 64] for i in range(N)]
        oracle = native_msm(
            JBN254, p.to_limbs([P[0] for P in pts], montgomery=False),
            p.to_limbs([P[1] for P in pts], montgomery=False),
            inf.numpy(), ints_to_limbs(scalars, limbs))
    else:
        total = sum(s << (i % 64) for i, s in live) % q
        oracle = JBN254.host_g2.scalar_mul(JBN254.g2_gen, total)
    assert oracle is not None and points_to_host(G, want) == [oracle]


def _jax_chain(nlog):
    class SquareChain(jax_schema.Circuit):
        x = jax_schema.Secret()
        y = jax_schema.Public()

        def define(self, api):
            v = self.x
            for _ in range((1 << nlog) - 2):
                v = api.mul(v, v)
            api.assert_is_equal(v, self.y)
    return SquareChain()


def test_entry_point_bn254_proof_equals_gnark_tpu():
    """The port's run at log2_n = 5 (31 constraints, 33 wires, n_pad 64;
    at 8 its 15 plain ladder MSMs take five minutes on one CPU thread) on
    its device route with the CPU as the device (setup on the fixed-base
    tables in complete additions, the MSMs on the ladder plan's plain
    versions), against gnark_tpu's host-key setup and prove with the
    same rngs: an MSM's result is one group element, so the proofs agree
    whichever route made them."""
    logs = []
    out = E.run(5, "bn254", "cpu", log=logs.append)
    assert out["cs"].nb_constraints == 31 and out["cs"].nb_wires == 33
    assert out["pk"].n_pad == 64 and out["pk"].domain_n == 32
    assert not out["pk"].host and out["pk"].device == torch.device("cpu")
    assert list(out["proves"]) == ["cold", "warm", "warm2"]
    assert "to_affine" in out["setup_parts"]
    assert out["setup_peak"] is None and out["prove_peak"] is None
    assert any("rejected" in m for m in logs), logs
    jcs = jax_compile(_jax_chain(5), JBN254)
    jpk, jvk = jg.setup(jcs, JBN254, rng=random.Random(42), host=True)
    y = out["y"]
    want = jg.prove(jcs, jpk, [y, E.X0], rng=random.Random(7))
    proof = out["proof"]
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
    assert jg.verify(want, jvk, [y])
    assert tg.verify(proof, out["vk"], [y])
    assert not tg.verify(proof, out["vk"], [(y + 1) % JBN254.fr.modulus])


def test_entry_point_bls12_381_native_route_verifies():
    """Over BLS12-381 the run takes the native route on the device path
    (key points and MSMs on the native core, the quotient on the device):
    the proof verifies and y + 1 is rejected.  gnark_tpu's device setup
    over BLS12-381 raises on its fp2 G2 (the reference defect the port
    repairs)."""
    out = E.run(8, "bls12_381", "cpu", log=lambda m: None)
    assert not out["pk"].host and tg.native_route(out["pk"].curve)
    assert out["pk"].device == torch.device("cpu")
    for label, (seconds, phases) in out["proves"].items():
        assert "msm_g2_B2" in phases and "to_host" not in phases, label
    y = out["y"]
    assert tg.verify(out["proof"], out["vk"], [y])
    assert not tg.verify(out["proof"], out["vk"], [y + 1])
    jcs = jax_compile(_jax_chain(8), JBLS12_381)
    with pytest.raises(TypeError):
        jg.setup(jcs, JBLS12_381, rng=random.Random(42))


def test_setup_in_column_slices_gives_the_same_key(monkeypatch):
    """The device route's fixed-base batches in slices of SETUP_COLUMNS
    (four slices of 16 of the 64 key points at log2_n = 5) give the points
    of one slice, and equal gnark_tpu's host setup; setup's timings name
    its parts."""
    from gnark_tpu_torch.curves import BN254
    cs = E.compile_circuit(E.square_chain(5), BN254)
    keys = []
    for cols in (tg.SETUP_COLUMNS, 16):
        monkeypatch.setattr(tg, "SETUP_COLUMNS", cols)
        timings = {}
        pk, vk = tg.setup(cs, BN254, rng=random.Random(42), device="cpu",
                          timings=timings)
        keys.append(pk)
    assert pk.n_pad == 64 and list(timings) == [
        "qap", "tables", "fixed_base_g1_A", "to_affine", "fixed_base_g1_B1",
        "fixed_base_g1_K", "fixed_base_g1_Z", "fixed_base_g2_B2", "vk"]
    K = tg._Groups(BN254)
    jpk, _ = jg.setup(jax_compile(_jax_chain(5), JBN254), JBN254,
                      rng=random.Random(42), host=True)
    for name in ("A", "B1", "B2", "K", "Z"):
        one, sliced = (getattr(k, name) for k in keys)
        assert all(torch.equal(a, b) for a, b in zip(one, sliced)), name
        G = K.g2 if name == "B2" else K.g1
        x, y, inf = sliced
        assert [None if i else (a, b) for a, b, i in zip(
            G.F.unpack(x), G.F.unpack(y), inf.tolist())] == \
            list(getattr(jpk, name)), name
