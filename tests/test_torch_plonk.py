"""gnark_tpu_torch.backend.plonk against gnark_tpu.backend.plonk.

JAX's own device-mode PLONK is too slow for the CPU (its test is marked
slow), so the port in *device mode on the CPU* (torch NTTs, the pointwise
pass on limb planes, every commitment through ``ops.msm.msm``) is held
against the JAX package in ``host=True`` mode.  Each package compiles the
circuit with its own frontend.  With the same rng both give the same
verifying key and the same proof, field by field.

Here: the cubic circuit (domain 8), whole: setup and prove.  A plain
ladder MSM takes seconds on the CPU whatever its size, so the other
circuits are in test_torch_plonk_keys.py, which proves from converted keys.

Tolerance: none; points and scalars compare exactly as Python ints.
"""

import dataclasses
import random

import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu_torch.frontend.schema as torch_schema
from gnark_tpu.backend import plonk as jp
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend.compile import compile_circuit

torch.set_num_threads(1)

Q = BN254.fr.modulus


def cubic_circuit(schema):
    class Cubic(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))
    return Cubic()


def same_fields(got, want, skip=("curve",)):
    for f in dataclasses.fields(got):
        if f.name not in skip:
            assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.fixture(scope="module")
def cubic():
    jcs = jax_compile(cubic_circuit(jax_schema), JBN254, scheme="plonk")
    cs = compile_circuit(cubic_circuit(torch_schema), BN254, scheme="plonk")
    jpk, jvk = jp.setup(jcs, JBN254, rng=random.Random(1), host=True)
    tpk, tvk = tp.setup(cs, BN254, rng=random.Random(1), device="cpu")
    want = jp.prove(jcs, jpk, [35, 3], rng=random.Random(2))
    timings = {}
    got = tp.prove(cs, tpk, [35, 3], rng=random.Random(2), timings=timings)
    return dict(jcs=jcs, cs=cs, jpk=jpk, jvk=jvk, tpk=tpk, tvk=tvk,
                want=want, got=got, timings=timings)


def test_setup_verifying_key_equals_jax(cubic):
    same_fields(cubic["tvk"], cubic["jvk"])
    assert cubic["tvk"].n == 8 and cubic["tvk"].curve is BN254


def test_setup_proving_key_equals_jax(cubic):
    tpk, jpk = cubic["tpk"], cubic["jpk"]
    for f in ("n", "ell", "k1", "k2", "ql_c", "qr_c", "qm_c", "qo_c", "qc_c",
              "s1_c", "s2_c", "s3_c", "sigma_vals", "omega_pows"):
        assert getattr(tpk, f) == getattr(jpk, f), f
    assert tpk.srs.g1 == jpk.srs.g1 and tpk.srs.g2_tau == jpk.srs.g2_tau
    assert not tpk.host_mode and tpk.device == torch.device("cpu")
    # the coset tables: the JAX host key's natural-order ints, bit-reversed
    P = tp._Poly(BN254.fr, tpk.n, "cpu")
    assert P.big == 32 and tpk.x_E.shape == (BN254.fr.L, 32)
    for got, want in zip(
            tpk.sel_E + tpk.sig_E + (tpk.x_E, tpk.zh_inv_E, tpk.l1_E),
            jpk.sel_E + jpk.sig_E + (jpk.x_E, jpk.zh_inv_E, jpk.l1_E)):
        assert P.F.unpack(got) == [want[i] for i in P.brev4]


def test_prove_equals_jax_host_prove(cubic):
    same_fields(cubic["got"], cubic["want"])
    assert set(cubic["timings"]) == {
        "solve", "interp_lro", "commit_lro", "transcript", "z", "commit_z",
        "coset_evals", "pointwise", "interp_quotient", "commit_h",
        "linearize", "open"}


def test_proof_verifies_under_both_packages(cubic):
    got = cubic["got"]
    assert tp.verify(got, cubic["tvk"], [35])
    assert jp.verify(jp.PlonkProof(**dataclasses.asdict(got)),
                     cubic["jvk"], [35])


def test_wrong_public_input_is_rejected(cubic):
    assert not tp.verify(cubic["got"], cubic["tvk"], [36])
    with pytest.raises(ValueError):
        tp.verify(cubic["got"], cubic["tvk"], [35, 1])


@pytest.mark.parametrize("field", ["c_l", "c_z", "c_h2", "w_zeta",
                                   "w_zeta_omega", "evals", "z_omega_zeta"])
def test_tampered_proof_is_rejected(cubic, field):
    got = cubic["got"]
    v = getattr(got, field)
    if field == "evals":
        bad = [v[0], (v[1] + 1) % Q] + v[2:]
    elif isinstance(v, int):
        bad = (v + 1) % Q
    else:
        bad = BN254.host_g1.double(v)
    assert not tp.verify(dataclasses.replace(got, **{field: bad}),
                         cubic["tvk"], [35])
    off_curve = dataclasses.replace(got, c_l=(got.c_l[0], got.c_l[1] + 1))
    assert not tp.verify(off_curve, cubic["tvk"], [35])


def test_unsatisfied_witness_is_refused(cubic):
    from gnark_tpu_torch.backend.solver import UnsatisfiedConstraintError
    with pytest.raises(UnsatisfiedConstraintError):
        tp.prove(cubic["cs"], cubic["tpk"], [36, 3], rng=random.Random(2))


def test_setup_defaults_to_the_card(cubic):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.setup(cubic["cs"], BN254, rng=random.Random(1))
    with pytest.raises(ValueError, match="host-only SRS"):
        tp.setup(cubic["cs"], BN254, srs=tp.kzg.new_srs(
            BN254, 11, tau=5, host=True))


TABLES = ("sel_E", "sig_E", "x_E", "zh_inv_E", "l1_E")


def _tables(pk):
    return pk.sel_E + pk.sig_E + (pk.x_E, pk.zh_inv_E, pk.l1_E)


def test_plonk_key_from_jax_host_key_equals_own_setup(cubic):
    tpk = cubic["tpk"]
    got = tp.plonk_key_from_jax(cubic["jpk"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tables(got), _tables(tpk)))
    assert got.curve is BN254 and got.vk.curve is BN254
    assert got.srs.device == torch.device("cpu") and not got.host_mode
    same_fields(got.vk, tpk.vk)
    for f in dataclasses.fields(tpk):
        if f.name not in TABLES + ("curve", "srs", "vk"):
            assert getattr(got, f.name) == getattr(tpk, f.name), f.name


def test_plonk_key_from_jax_reads_device_arrays(cubic):
    """A JAX key whose coset tables are device arrays, handed over as numpy
    (uint32 Montgomery limb planes, bit-reversed), becomes the same key."""
    import numpy as np
    tpk = cubic["tpk"]

    def as_jax(v):
        if isinstance(v, tuple):
            return tuple(as_jax(a) for a in v)
        return v.numpy().astype(np.uint32)

    jax_like = dataclasses.replace(
        cubic["jpk"], host_mode=False,
        **{n: as_jax(getattr(tpk, n)) for n in TABLES})
    got = tp.plonk_key_from_jax(jax_like, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tables(got), _tables(tpk)))
