"""The port's BLS24-315 recursion gadgets (``std/algebra/fields_bls24315``,
``std/algebra/sw_bls24315``, ``std/groth16_bls24315``) against gnark_tpu's.

  * each gadget run by both packages' big-int engines over BW6-633's
    scalar field on the same seeded values gives the same result: the E24
    product, square, inverse, conjugate and Frobenius (p, p^2, p^4), the
    flat-basis maps, G1 scalar multiplication by a constant base and by
    GLV, the pairing; the GLV decomposition hint and constants agree;
  * the in-circuit Groth16 verifier, compiled by both packages around
    gnark_tpu's inner cubic proof, is the same system, byte for byte
    (``cs_io``'s bytes, held by their SHA-256; 177,631 constraints);
  * the port's solver and engine accept the inner proof with its public
    input 35 and refuse 36;
  * under ``-m slow``, the outer BW6-633 Groth16 key and proof at domain
    2^18 (setup rng 11, prove rng 12) equal gnark_tpu's.

The verifier systems are built once for the module.  Tolerance: none;
field elements, points and bytes compare exactly.
"""

import numpy as np
import pytest

import gnark_tpu.std.algebra.fields_bls24315 as jax_f
import gnark_tpu.std.algebra.sw_bls24315 as jax_sw
import gnark_tpu_torch.std.algebra.fields_bls24315 as torch_f
import gnark_tpu_torch.std.algebra.sw_bls24315 as torch_sw
from gnark_tpu.backend import hints as jax_hints
from gnark_tpu_torch.backend import hints as torch_hints
from gnark_tpu_torch.curves import BLS24_315
from gnark_tpu_torch.std.groth16_bls24315 import _gt_to_tower
from torch_recursion_cases import (
    JAX, PORT, assert_outer_proofs_equal, assignment, verifier_systems,
    witness)

FP, FR = BLS24_315.fp.modulus, BLS24_315.fr.modulus
SEED = 37


def _both(fn):
    """fn(engine, module of fields, module of sw) by each package."""
    api = PORT.engine.BigIntEngine(PORT.curves.BW6_633)
    japi = JAX.engine.BigIntEngine(JAX.curves.BW6_633)
    return fn(api, torch_f, torch_sw), fn(japi, jax_f, jax_sw)


@pytest.fixture(scope="module")
def systems():
    return verifier_systems("bls24_315")


def test_e24_arithmetic_and_frobenius_agree():
    rng = np.random.default_rng(SEED)
    flat_a, flat_b = ([int(v) * int(w) % FP for v, w in
                       rng.integers(1, 1 << 62, (24, 2))] for _ in range(2))
    a, b = _gt_to_tower(flat_a), _gt_to_tower(flat_b)
    assert torch_f.tower_to_flat(a) == flat_a
    assert a == jax_f.flat_to_tower(flat_a)

    def run(api, F, _):
        K = F.E24(api)
        return (K.mul(a, b), K.sqr(a), K.inverse(a), K.conjugate(b),
                K.frobenius(a, 1), K.frobenius(a, 2), K.frobenius(a, 4))
    got, want = _both(run)
    assert got == want
    for e in (1, 2, 4, 12):
        assert torch_f.frobenius_consts(e) == jax_f.frobenius_consts(e)


def test_g1_scalar_mul_and_glv_agree():
    rng = np.random.default_rng(SEED + 1)
    host = BLS24_315.host_g1
    base = host.scalar_mul(BLS24_315.g1_gen, 9)
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
        assert torch_sw.decompose_scalar_bls24315(FR, [v], 3) == \
            jax_sw.decompose_scalar_bls24315(FR, [v], 3)
    assert (torch_sw.GLV_LAMBDA, torch_sw.GLV_BETA, torch_sw.NAF) == \
        (jax_sw.GLV_LAMBDA, jax_sw.GLV_BETA, jax_sw.NAF)
    assert torch_hints.uuid_of(torch_sw.decompose_scalar_bls24315) == \
        jax_hints.uuid_of(jax_sw.decompose_scalar_bls24315)


def test_pairing_gadget_agrees():
    host1, host2 = BLS24_315.host_g1, BLS24_315.host_g2
    P = host1.scalar_mul(BLS24_315.g1_gen, 777)
    Q = host2.scalar_mul(BLS24_315.g2_gen, 333)

    def run(api, _, sw):
        return sw.PairingGadget(api).pair(P, (Q[0], Q[1]))
    got, want = _both(run)
    assert got == want


def test_verifier_systems_are_the_same_bytes(systems):
    cls, cs, digests, vk, proof = systems
    assert cs.nb_constraints == 177631
    assert digests["port"] == digests["jax"]


def test_port_solver_accepts_35_and_refuses_36(systems):
    cls, cs, digests, vk, proof = systems
    w = witness(PORT, cls, proof, 35)
    assert PORT.solver.solve(cs, w) is not None
    assert not PORT.solver.is_solved(cs, [36] + w[1:])


def test_port_engine_accepts_35_and_refuses_36(systems):
    cls, _, _, _, proof = systems
    PORT.engine.is_solved(cls(), assignment(cls, proof, 35),
                          PORT.curves.BW6_633)
    with pytest.raises(Exception):
        PORT.engine.is_solved(cls(), assignment(cls, proof, 36),
                              PORT.curves.BW6_633)


@pytest.mark.slow
def test_outer_proof_equals_jax(systems):
    """The reference's ``test_outer_proof_end_to_end`` in both packages
    (setup rng 11, prove rng 12, domain 2^18): the port's outer key and
    proof equal gnark_tpu's.  gnark_tpu proves in its host mode: in its
    device mode the quotient's XLA CPU compile (transforms of 2^18 points
    of 20 limbs) aborted the process ("LLVM ERROR: Unable to allocate
    section memory") with most of the host's memory free."""
    assert_outer_proofs_equal(systems, reference_host=True)
