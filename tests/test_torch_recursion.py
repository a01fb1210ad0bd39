"""The port's BLS12-377 recursion gadgets (``std/algebra/fields_bls12377``,
``std/algebra/sw_bls12377``, ``std/groth16_bls12377``) against gnark_tpu's.

  * each gadget run by both packages' big-int engines over BW6-761's
    scalar field on the same seeded values gives the same result: the E12
    product, inverse and Frobenius, G1 scalar multiplication by a constant
    base and by GLV, the pairing; the GLV decomposition hint agrees;
  * the in-circuit Groth16 verifier, compiled by both packages around
    gnark_tpu's inner cubic proof, is the same system, byte for byte
    (``cs_io``'s bytes, held by their SHA-256; 92,555 constraints, as
    docs/PERF.md records);
  * the port's solver and engine accept the inner proof with its public
    input 35 and refuse 36;
  * both packages' ``register_hints`` give the same uuid set;
  * under ``-m slow``, the outer BW6-761 Groth16 key and proof at domain
    2^17 (setup rng 11, prove rng 12) equal gnark_tpu's.

The verifier systems are built once for the module.  Tolerance: none;
field elements, points and bytes compare exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import gnark_tpu.std.algebra.fields_bls12377 as jax_f
import gnark_tpu.std.algebra.sw_bls12377 as jax_sw
import gnark_tpu_torch.std.algebra.fields_bls12377 as torch_f
import gnark_tpu_torch.std.algebra.sw_bls12377 as torch_sw
from gnark_tpu_torch.curves import BLS12_377
from gnark_tpu_torch.std.groth16_bls12377 import _gt_to_tower
from torch_recursion_cases import (
    JAX, PORT, assert_outer_proofs_equal, assignment, verifier_systems,
    witness)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP, FR = BLS12_377.fp.modulus, BLS12_377.fr.modulus
SEED = 31


def _engines():
    return (PORT.engine.BigIntEngine(PORT.curves.BW6_761),
            JAX.engine.BigIntEngine(JAX.curves.BW6_761))


def _both(fn):
    """fn(engine, module of fields, module of sw) by each package."""
    api, japi = _engines()
    return fn(api, torch_f, torch_sw), fn(japi, jax_f, jax_sw)


@pytest.fixture(scope="module")
def systems():
    return verifier_systems("bls12_377")


def test_e12_product_inverse_frobenius_agree():
    rng = np.random.default_rng(SEED)
    a, b = (_gt_to_tower(tuple((int(x) % FP, int(y) % FP)
                               for x, y in rng.integers(1, 1 << 62, (6, 2))))
            for _ in range(2))

    def run(api, F, _):
        K = F.E12(api)
        return (K.mul(a, b), K.inverse(a), K.frobenius(a), K.frobenius(a, 2),
                K.conjugate(b))
    got, want = _both(run)
    assert got == want


def test_g1_scalar_mul_and_glv_agree():
    rng = np.random.default_rng(SEED + 1)
    host = BLS12_377.host_g1
    base = host.scalar_mul(BLS12_377.g1_gen, 9)
    k = int(rng.integers(1, 1 << 62))
    s = int.from_bytes(rng.bytes(32), "big") % FR

    def run(api, _, sw):
        g1 = sw.G1Gadget(api)
        return (g1.scalar_mul_const_base(base, k, nb_bits=64),
                g1.scalar_mul_var(base, s))
    got, want = _both(run)
    assert got == want == (host.scalar_mul(base, k), host.scalar_mul(base, s))
    for v in rng.integers(1, 1 << 62, 8):
        v = int(v) * int(rng.integers(1, 1 << 62)) % FR
        assert torch_sw.decompose_scalar_bls12377(FR, [v], 3) == \
            jax_sw.decompose_scalar_bls12377(FR, [v], 3)
    assert (torch_sw.GLV_LAMBDA, torch_sw.GLV_BETA) == \
        (jax_sw.GLV_LAMBDA, jax_sw.GLV_BETA)


def test_pairing_gadget_agrees():
    host1, host2 = BLS12_377.host_g1, BLS12_377.host_g2
    P = host1.scalar_mul(BLS12_377.g1_gen, 777)
    Q = host2.scalar_mul(BLS12_377.g2_gen, 333)

    def run(api, _, sw):
        return sw.PairingGadget(api).pair(P, (Q[0], Q[1]))
    got, want = _both(run)
    assert got == want


def test_verifier_systems_are_the_same_bytes(systems):
    cls, cs, digests, vk, proof = systems
    assert cs.nb_constraints == 92555
    assert digests["port"] == digests["jax"]


def test_port_solver_accepts_35_and_refuses_36(systems):
    cls, cs, digests, vk, proof = systems
    w = witness(PORT, cls, proof, 35)
    assert PORT.solver.solve(cs, w) is not None
    assert not PORT.solver.is_solved(cs, [36] + w[1:])


def test_port_engine_accepts_35_and_refuses_36(systems):
    cls, _, _, _, proof = systems
    PORT.engine.is_solved(cls(), assignment(cls, proof, 35),
                          PORT.curves.BW6_761)
    with pytest.raises(Exception):
        PORT.engine.is_solved(cls(), assignment(cls, proof, 36),
                              PORT.curves.BW6_761)


@pytest.mark.slow
def test_outer_proof_equals_jax(systems):
    """The reference's ``test_outer_proof_end_to_end`` in both packages
    (setup rng 11, prove rng 12, domain 2^17): the port's outer
    key and proof equal gnark_tpu's."""
    assert_outer_proofs_equal(systems)


# Both registries are whole-process state (``hints.all_registered()``): a
# test file that compiled a hint earlier on the same worker leaves it in
# one package's registry alone.  So both sets are taken in one fresh
# interpreter, where only the two libraries have registered theirs.
REGISTRIES = """
import json
import gnark_tpu.std as jax_std
import gnark_tpu.std.algebra.sw_bls12377 as jax_sw
import gnark_tpu_torch.std as torch_std
import gnark_tpu_torch.std.algebra.sw_bls12377 as torch_sw
from gnark_tpu.backend import hints as jax_hints
from gnark_tpu_torch.backend import hints as torch_hints

got, want = torch_std.register_hints(), jax_std.register_hints()
print(json.dumps({
    "got": sorted(got), "want": sorted(want),
    "names": [[torch_hints.name_of(u), jax_hints.name_of(u)] for u in want],
    "glv": [torch_hints.uuid_of(torch_sw.decompose_scalar_bls12377),
            jax_hints.uuid_of(jax_sw.decompose_scalar_bls12377)]}))
"""


def test_register_hints_uuid_sets_equal():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REGISTRIES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out["got"]) == set(out["want"])
    for torch_name, jax_name in out["names"]:
        assert torch_name == jax_name
    assert out["glv"][0] == out["glv"][1]
