"""gnark_tpu_torch.backend.serialize, witness bytes and export_solidity
against gnark_tpu's.

  * point bytes, both ways, on all six curves: G1 and G2 (over fp2, over
    fp for BW6, over fp4 for BLS24-315), both signs of y and infinity;
    each package decodes the other's bytes to the same point, and both
    refuse a tampered G2 encoding;
  * the bytes of one Groth16 proof and its verifying key (bellman layout)
    on all six curves, and of one PLONK proof and its verifying key, are
    equal, and decode to a proof and key that verify;
  * the port accepts and rejects gnark's bellman BLS12-381 vectors as
    gnark_tpu does (tests/test_serialize.py);
  * the witness bytes of one assignment are equal;
  * the Solidity verifier of one BN254 key is the same text.

Scalars come from a numpy seed.  Tolerance: none; bytes, points and text
compare exactly.
"""

import base64
import dataclasses
import random

import numpy as np
import pytest

import gnark_tpu.curves as jax_curves
import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu_torch.frontend.schema as torch_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.backend import key_io as jax_key_io
from gnark_tpu.backend import plonk as jp
from gnark_tpu.backend import serialize as jax_ser
from gnark_tpu.backend import solidity as jax_solidity
from gnark_tpu.backend.witness import Witness as JWitness
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.backend import key_io
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.backend import serialize
from gnark_tpu_torch.backend.solidity import export_solidity
from gnark_tpu_torch.backend.witness import Witness
from gnark_tpu_torch.curves import ALL_CURVES, BLS12_381, BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from test_serialize import IN_BAD, IN_OK, PROOF1, PROOF4, VK1, VK4, _inputs
from test_torch_plonk import cubic_circuit

SEED = 23
CURVES = sorted(ALL_CURVES)


def _scalars(curve, k):
    rng = np.random.default_rng(SEED)
    return [int(v) % curve.fr.modulus
            for v in rng.integers(2, 1 << 62, k, dtype=np.int64)]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("name", CURVES)
def test_point_bytes_equal_both_ways(name, group):
    curve, jcurve = ALL_CURVES[name], jax_curves.ALL_CURVES[name]
    c, jc = serialize.PointCodec(curve), jax_ser.PointCodec(jcurve)
    host = getattr(curve, f"host_{group}")
    gen = getattr(curve, f"{group}_gen")
    enc, jenc = getattr(c, f"{group}_to_bytes"), getattr(jc, f"{group}_to_bytes")
    dec, jdec = (getattr(c, f"{group}_from_bytes"),
                 getattr(jc, f"{group}_from_bytes"))
    points = [None]
    for k in _scalars(curve, 2):
        P = host.scalar_mul(gen, k)
        points += [P, host.neg(P)]                 # both signs of y
    larger = set()
    for P in points:
        data = enc(P)
        assert data == jenc(P)
        assert len(data) == getattr(c, f"{group}_compressed_size")()
        assert dec(data) == jdec(data) == P
        larger.add(data[0] & 0x20 if c.zcash else data[0] >> 6)
    assert len(larger) >= 2                        # both flags were written
    if group == "g2":
        bad = bytearray(enc(points[1]))
        bad[-1] ^= 1
        for decode in (dec, jdec):
            with pytest.raises(ValueError):
                decode(bytes(bad))


def _cubic_keys(name):
    """The cubic circuit's host-mode Groth16 key and one proof over
    ``name``, made by gnark_tpu and by the port with the same rng."""
    jcurve, curve = jax_curves.ALL_CURVES[name], ALL_CURVES[name]
    jcs = jax_compile(cubic_circuit(jax_schema), jcurve)
    cs = compile_circuit(cubic_circuit(torch_schema), curve)
    jpk, jvk = jg.setup(jcs, jcurve, rng=random.Random(3), host=True)
    pk, vk = tg.setup(cs, curve, rng=random.Random(3), host=True)
    jproof = jg.prove(jcs, jpk, [35, 3], rng=random.Random(4))
    proof = tg.prove(cs, pk, [35, 3], rng=random.Random(4))
    return curve, jcurve, proof, vk, jproof, jvk


@pytest.mark.parametrize("name", CURVES)
def test_groth16_proof_and_vk_bytes_equal(name):
    curve, jcurve, proof, vk, jproof, jvk = _cubic_keys(name)
    data = serialize.proof_to_bytes(proof, curve)
    assert data == jax_ser.proof_to_bytes(jproof, jcurve)
    vdata = serialize.vk_to_bytes(vk)
    assert vdata == jax_ser.vk_to_bytes(jvk)
    proof2 = serialize.proof_from_bytes(data, curve)
    vk2 = serialize.vk_from_bytes(vdata, curve)
    assert isinstance(proof2, tg.Proof) and isinstance(vk2, tg.VerifyingKey)
    assert dataclasses.astuple(proof2) == dataclasses.astuple(proof)
    for f in ("alpha_g1", "beta_g1", "beta_g2", "gamma_g2", "delta_g1",
              "delta_g2", "K", "nb_public", "e_alpha_beta"):
        assert getattr(vk2, f) == getattr(vk, f), f
    assert tg.verify(proof2, vk2, [35])
    assert not tg.verify(proof2, vk2, [36])


def test_plonk_proof_and_vk_bytes_equal():
    jcs = jax_compile(cubic_circuit(jax_schema), jax_curves.BN254,
                      scheme="plonk")
    cs = compile_circuit(cubic_circuit(torch_schema), BN254, scheme="plonk")
    jpk, jvk = jp.setup(jcs, jax_curves.BN254, rng=random.Random(3),
                        host=True)
    pk, vk = tp.setup(cs, BN254, rng=random.Random(3), host=True)
    jproof = jp.prove(jcs, jpk, [35, 3], rng=random.Random(1))
    proof = tp.prove(cs, pk, [35, 3], rng=random.Random(1))
    data = serialize.plonk_proof_to_bytes(proof, BN254)
    assert data == jax_ser.plonk_proof_to_bytes(jproof, jax_curves.BN254)
    vdata = key_io.plonk_vk_to_bytes(vk)
    assert vdata == jax_key_io.plonk_vk_to_bytes(jvk)
    proof2 = serialize.plonk_proof_from_bytes(data, BN254)
    vk2 = key_io.plonk_vk_from_bytes(vdata)
    assert isinstance(proof2, tp.PlonkProof) and isinstance(vk2, tp.PlonkVK)
    assert dataclasses.astuple(proof2) == dataclasses.astuple(proof)
    assert tp.verify(proof2, vk2, [35])
    assert not tp.verify(proof2, vk2, [36])


@pytest.mark.parametrize("vk_b64, proof_b64, inputs_b64, accepted", [
    (VK1, PROOF1, IN_OK, True), (VK1, PROOF1, IN_BAD, False),
    (VK4, PROOF4, "", True)], ids=["accepts", "rejects", "no_inputs"])
def test_bellman_vectors(vk_b64, proof_b64, inputs_b64, accepted):
    vk = serialize.vk_from_bytes(base64.b64decode(vk_b64), BLS12_381)
    proof = serialize.proof_from_bytes(base64.b64decode(proof_b64),
                                       BLS12_381)
    assert tg.verify(proof, vk, _inputs(inputs_b64)) is accepted


def test_witness_bytes_equal():
    a, ja = cubic_circuit(torch_schema), cubic_circuit(jax_schema)
    a.x, a.y = ja.x, ja.y = 3, 35
    w = Witness.from_assignment(a, BN254)
    data = w.to_bytes()
    assert data == JWitness.from_assignment(ja, jax_curves.BN254).to_bytes()
    w2 = Witness.from_bytes(data, BN254.fr.modulus, w.nb_public)
    assert w2.values == w.values == [35, 3]


def test_export_solidity_text_equal():
    curve, jcurve, proof, vk, jproof, jvk = _cubic_keys("bn254")
    text = export_solidity(vk)
    assert text == jax_solidity.export_solidity(jvk)
    assert "contract Verifier" in text and f"{vk.alpha_g1[0]}" in text
