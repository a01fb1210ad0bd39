"""gnark_tpu_torch.backend.key_io against gnark_tpu's: one file format.

  * a Groth16 device key of the port (the cubic over BN254, on the CPU)
    written by the port reads in gnark_tpu with the same arrays and header
    points; gnark_tpu's file of that key reads back in the port as the
    original tensors, and the two files hold the same arrays (names,
    dtypes, values);
  * a key loaded from a file (``safe`` off and on) proves the proof of the
    key in memory with the same rng, byte for byte;
  * PLONK the same: gnark_tpu's key, carried over, written by one package
    and read by the other, proves the same proof;
  * a native-route key (BLS12-381: numpy planes from the native core)
    keeps numpy planes after a load, in either package's file, and proves
    the same proof;
  * host-mode keys raise on write in both packages;
  * a prove leaves its phases in ``utils.profiling.last_profile``.

Tolerance: none; arrays, points and proof bytes compare exactly.
"""

import random

import numpy as np
import pytest
import torch

import gnark_tpu.curves as jax_curves
import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu_torch.frontend.schema as torch_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.backend import key_io as jax_key_io
from gnark_tpu.backend import plonk as jp
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.backend import key_io
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.backend import serialize
from gnark_tpu_torch.curves import BLS12_381, BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.utils import profiling
from test_torch_plonk import cubic_circuit

torch.set_num_threads(1)

NAMES = ("A", "B1", "B2", "K", "Z")
HEADER = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2",
          "domain_n", "n_pad")


@pytest.fixture(scope="module")
def cubic():
    cs = compile_circuit(cubic_circuit(torch_schema), BN254)
    pk, vk = tg.setup(cs, BN254, rng=random.Random(3), device="cpu")
    return cs, pk, vk


def _same_files(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        assert np.array_equal(za[k], zb[k]), k


def test_groth16_file_reads_in_the_other_package(cubic, tmp_path):
    cs, pk, vk = cubic
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    key_io.groth16_pk_write(pk, path)
    jpk = jax_key_io.groth16_pk_read(path, safe=True)
    for f in HEADER:
        assert getattr(jpk, f) == getattr(pk, f), f
    for name in NAMES:
        for ours, theirs in zip(getattr(pk, name), getattr(jpk, name)):
            assert np.array_equal(np.asarray(theirs), ours.numpy()), name
    jax_key_io.groth16_pk_write(jpk, jpath)
    _same_files(path, jpath)
    pk2 = key_io.groth16_pk_read(jpath, device="cpu")
    assert pk2.device == torch.device("cpu") and not pk2.host
    for f in HEADER:
        assert getattr(pk2, f) == getattr(pk, f), f
    for name in NAMES:
        for a, b in zip(getattr(pk2, name), getattr(pk, name)):
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("safe", [False, True])
def test_groth16_loaded_key_proves_the_same_proof(cubic, safe, tmp_path):
    cs, pk, vk = cubic
    path = str(tmp_path / "pk.npz")
    key_io.groth16_pk_write(pk, path)
    pk2 = key_io.groth16_pk_read(path, safe=safe, device="cpu")
    want = tg.prove(cs, pk, [35, 3], rng=random.Random(7))
    got = tg.prove(cs, pk2, [35, 3], rng=random.Random(7))
    assert serialize.proof_to_bytes(got, BN254) == \
        serialize.proof_to_bytes(want, BN254)
    assert tg.verify(got, vk, [35]) and not tg.verify(got, vk, [36])


def test_plonk_files_cross_and_prove_the_same_proof(tmp_path):
    jcs = jax_compile(cubic_circuit(jax_schema), jax_curves.BN254,
                      scheme="plonk")
    cs = compile_circuit(cubic_circuit(torch_schema), BN254, scheme="plonk")
    jhost, jvk = jp.setup(jcs, jax_curves.BN254, rng=random.Random(3),
                          host=True)
    pk = tp.plonk_key_from_jax(jhost, "cpu")
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    key_io.plonk_pk_write(pk, path)
    jpk = jax_key_io.plonk_pk_read(path)
    for f in ("n", "ell", "k1", "k2", "ql_c", "s3_c", "sigma_vals",
              "omega_pows"):
        assert getattr(jpk, f) == getattr(pk, f), f
    assert jpk.srs.g1 == pk.srs.g1
    for ours, theirs in zip(pk.sel_E + pk.sig_E + (pk.x_E, pk.l1_E),
                            jpk.sel_E + jpk.sig_E + (jpk.x_E, jpk.l1_E)):
        assert np.array_equal(np.asarray(theirs), ours.numpy())
    jax_key_io.plonk_pk_write(jpk, jpath)
    _same_files(path, jpath)
    pk2 = key_io.plonk_pk_read(jpath, device="cpu")
    assert pk2.device == torch.device("cpu")
    assert pk2.srs.device == torch.device("cpu")
    for a, b in zip(pk2.sel_E + pk2.sig_E + (pk2.x_E, pk2.zh_inv_E, pk2.l1_E),
                    pk.sel_E + pk.sig_E + (pk.x_E, pk.zh_inv_E, pk.l1_E)):
        assert torch.equal(a, b)
    want = tp.prove(cs, pk, [35, 3], rng=random.Random(2))
    got = tp.prove(cs, pk2, [35, 3], rng=random.Random(2))
    assert serialize.plonk_proof_to_bytes(got, BN254) == \
        serialize.plonk_proof_to_bytes(want, BN254)
    assert tp.verify(got, pk2.vk, [35]) and not tp.verify(got, pk2.vk, [36])


def test_native_route_key_keeps_numpy_planes(tmp_path):
    cs = compile_circuit(cubic_circuit(torch_schema), BLS12_381)
    pk, vk = tg.setup(cs, BLS12_381, rng=random.Random(3), device="cpu")
    assert tg.native_route(BLS12_381)
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    key_io.groth16_pk_write(pk, path)
    jpk = jax_key_io.groth16_pk_read(path)
    jax_key_io.groth16_pk_write(jpk, jpath)
    _same_files(path, jpath)
    want = tg.prove(cs, pk, [35, 3], rng=random.Random(7))
    for p in (path, jpath):
        pk2 = key_io.groth16_pk_read(p, device="cpu")
        for name in NAMES:
            for a, b in zip(getattr(pk2, name), getattr(pk, name)):
                assert isinstance(a, np.ndarray) and np.array_equal(a, b)
        got = tg.prove(cs, pk2, [35, 3], rng=random.Random(7))
        assert serialize.proof_to_bytes(got, BLS12_381) == \
            serialize.proof_to_bytes(want, BLS12_381)
    assert tg.verify(got, vk, [35]) and not tg.verify(got, vk, [36])


def test_host_keys_raise_in_both(tmp_path):
    path = str(tmp_path / "k.npz")
    cs = compile_circuit(cubic_circuit(torch_schema), BN254)
    scs = compile_circuit(cubic_circuit(torch_schema), BN254, scheme="plonk")
    jcs = jax_compile(cubic_circuit(jax_schema), jax_curves.BN254)
    jscs = jax_compile(cubic_circuit(jax_schema), jax_curves.BN254,
                       scheme="plonk")
    pk, _ = tg.setup(cs, BN254, rng=random.Random(3), host=True)
    ppk, _ = tp.setup(scs, BN254, rng=random.Random(3), host=True)
    jpk, _ = jg.setup(jcs, jax_curves.BN254, rng=random.Random(3), host=True)
    jppk, _ = jp.setup(jscs, jax_curves.BN254, rng=random.Random(3),
                       host=True)
    for write, key in ((key_io.groth16_pk_write, pk),
                       (key_io.plonk_pk_write, ppk),
                       (jax_key_io.groth16_pk_write, jpk),
                       (jax_key_io.plonk_pk_write, jppk)):
        with pytest.raises(ValueError):
            write(key, path)


def test_prove_leaves_its_phases_in_last_profile(cubic):
    cs, pk, vk = cubic
    profiling.reset()
    timings = {}
    tg.prove(cs, pk, [35, 3], rng=random.Random(7), timings=timings)
    got = {k: v for k, v in profiling.last_profile.items()
           if k.startswith("groth16.")}
    assert got == {f"groth16.{k}": v for k, v in timings.items()}
    assert {"groth16.solve", "groth16.compute_h", "groth16.msm_g1_A",
            "groth16.msm_g2_B2", "groth16.assembly"} <= set(got)
    with profiling.phase("caller"):
        tg.prove(cs, tg.setup(cs, BN254, rng=random.Random(3),
                              host=True)[0], [35, 3], rng=random.Random(7))
    # the last prove's phases alone (a host prove has one "msm")
    assert {k for k in profiling.last_profile if k.startswith("groth16.")} \
        == {"groth16.solve", "groth16.compute_h", "groth16.msm",
            "groth16.assembly"}
    assert profiling.last_profile["caller"] > 0
