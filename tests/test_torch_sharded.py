"""gnark_tpu_torch.parallel.sharded_msm and ``groth16.prove(mesh=...)``
over gloo ranks on the CPU (world 2 and 4), against the unsharded port and
gnark_tpu (tests/test_sharded.py's cases):

  * the sharded MSM of tests/test_sharded.py's 64-point fixture, G1 and
    fp2 G2, equals the host oracle and the port's unsharded ``msm``; with
    the last rank's scalars all zero (an identity partial) it still does;
  * the mesh prove of the BN254 squaring chain at depth 62 (domain 64: the
    four-step quotient and five sharded MSMs), from a host setup packed by
    ``pk_to_device(pk, "cpu")``, equals the port's unsharded prove with the
    same ``random.Random``, and gnark_tpu's host-mode prove from its own
    host setup with the same setup rng (the same key); it verifies, and
    y + 1 is rejected.

Every rank returns the same points and proof.  Each world's ranks run
once for the module, beside the parent's unsharded references.
Tolerance: none; points compare exactly as Python ints.
"""

import random

import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu_torch.frontend.schema as torch_schema
import torch_sharded_cases as C
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import groth16
from gnark_tpu_torch.backend.groth16 import _Groups
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.ops.msm import complete_ops, msm
from gnark_tpu_torch.parallel.sharded_msm import to_projective

torch.set_num_threads(1)
WORLDS = (2, 4)
Q = BN254.fr.modulus


@pytest.fixture(scope="module")
def runs():
    started = {w: C.start_ranks(C.sharded_case, w, timeout=420)
               for w in WORLDS}
    fixture = C.msm_fixture()
    want = {}
    for group, (points, scalars) in fixture.items():
        G, host, args = C.msm_inputs(group, points, scalars)
        want[group] = (host.msm(points, scalars),
                       C.affine(G, host, msm(G, *args)))
    cs, pk, vk = C.chain_key()
    proof = groth16.prove(cs, pk, C.chain_witness(Q), rng=random.Random(4))
    got = {}
    for w, ranks in started.items():
        try:
            got[w] = ranks.join()
        except Exception as e:          # each world's tests report it
            got[w] = e
    return dict(got=got, want=want, fixture=fixture, vk=vk,
                proof=(proof.ar, proof.bs, proof.krs))


def _ranks(runs, world):
    got = runs["got"][world]
    if isinstance(got, Exception):
        raise got
    assert [r["local_rank"] for r in got] == list(range(world))
    assert all(r["n_dev"] == world for r in got)
    for r in got[1:]:
        assert r["msm"] == got[0]["msm"] and r["proof"] == got[0]["proof"]
    return got[0]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_msm_equals_oracle_and_unsharded(runs, world, group):
    oracle, unsharded = runs["want"][group]
    assert _ranks(runs, world)["msm"][group] == oracle == unsharded


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_msm_with_an_identity_partial(runs, world):
    points, scalars = runs["fixture"]["g1"]
    kept = len(scalars) - len(scalars) // world
    want = BN254.host_g1.msm(points[:kept], scalars[:kept])
    assert _ranks(runs, world)["msm"]["g1_zero_shard"] == want


def test_identity_partial_becomes_the_identity_class():
    """A Jacobian identity (Z = 0; the MSM leaves it (0 : 0 : 0)) becomes
    (0 : 1 : 0) in projective form; a point keeps its affine value."""
    K = _Groups(BN254)
    GC = complete_ops(K.g1)
    F = K.g1.F
    x, y = BN254.g1_gen
    z = 5
    jac = (F.pack([0, x * z * z % BN254.fp.modulus], "cpu"),
           F.pack([0, y * z ** 3 % BN254.fp.modulus], "cpu"),
           F.pack([0, z], "cpu"))
    X, Y, Z = (F.unpack(a) for a in to_projective(GC, jac))
    assert (X[0], Y[0], Z[0]) == (0, 1, 0)
    p = BN254.fp.modulus
    zi = pow(Z[1], -1, p)
    assert (X[1] * zi % p, Y[1] * zi % p) == (x, y)


@pytest.fixture(scope="module")
def jax_host_proof():
    jcs = jax_compile(C.chain_circuit(jax_schema), JBN254)
    jpk, _ = jg.setup(jcs, JBN254, rng=random.Random(3), host=True)
    p = jg.prove(jcs, jpk, C.chain_witness(Q), rng=random.Random(4))
    return (p.ar, p.bs, p.krs)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_prove_equals_unsharded_and_gnark_tpu_host(runs, world,
                                                        jax_host_proof):
    got = _ranks(runs, world)
    assert got["proof"] == runs["proof"] == jax_host_proof
    timings = got["timings"]
    assert {"solve", "compute_h", "msm_g1_A", "msm_g2_B2", "msm_g1_Z",
            "assembly"} <= set(timings)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_proof_verifies_and_rejects_a_wrong_input(runs, world):
    ar, bs, krs = _ranks(runs, world)["proof"]
    proof = groth16.Proof(ar=ar, bs=bs, krs=krs)
    y = C.chain_witness(Q)[0]
    assert groth16.verify(proof, runs["vk"], [y])
    assert not groth16.verify(proof, runs["vk"], [(y + 1) % Q])


def test_same_circuit_in_both_frontends():
    """The chain compiles to the same system in both packages, so the two
    host setups with one rng give the same key."""
    jcs = jax_compile(C.chain_circuit(jax_schema), JBN254)
    cs = compile_circuit(C.chain_circuit(torch_schema), BN254)
    assert (cs.nb_constraints, cs.nb_wires, cs.nb_public) == \
        (jcs.nb_constraints, jcs.nb_wires, jcs.nb_public) == (63, 65, 2)
