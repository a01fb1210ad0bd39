"""gnark_tpu_torch.backend.plonk on keys carried over from gnark_tpu, and
its host mode.

  * a circuit with fewer than 8 rows (quotient domain 8n, not 4n): the JAX
    package's host-mode key through ``plonk_key_from_jax``, then the port's
    device-mode prove on the CPU gives the JAX package's proof exactly;
  * a one-hash MiMC circuit (domain 512, quotient domain 2048): the same,
    with the commitments' MSM served by the native core.  The plain ladder
    that ``ops.msm.msm`` takes on the CPU needs about 20 s for each of the
    nine MSMs at this size; it is held against its oracles in
    test_torch_ladder.py and proves end to end in test_torch_plonk.py;
  * the port's ``host=True`` mode gives the JAX package's keys and proofs
    for all three circuits.

Tolerance: none; points and scalars compare exactly as Python ints.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu.std.mimc as jax_mimc
import gnark_tpu_torch.frontend.schema as torch_schema
import gnark_tpu_torch.std.mimc as torch_mimc
from gnark_tpu.backend import plonk as jp
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import kzg as tk
from gnark_tpu_torch.backend import plonk as tp
from gnark_tpu_torch.backend.native_field import native_msm
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.ops.ec import points_to_device
from test_torch_plonk import cubic_circuit, same_fields

torch.set_num_threads(1)


def square_circuit(schema):
    class Square(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            api.assert_is_equal(self.y, api.mul(self.x, self.x))
    return Square()


def mimc_circuit(schema, mimc):
    class MiMCOne(schema.Circuit):
        pre = schema.Secret()
        digest = schema.Public()

        def define(self, api):
            h = mimc.MiMC(api)
            h.write(self.pre)
            api.assert_is_equal(h.sum(), self.digest)
    return MiMCOne()


def _case(name):
    """-> (gnark_tpu circuit, port circuit, witness [public | secret])."""
    if name == "square":
        return square_circuit(jax_schema), square_circuit(torch_schema), [9, 3]
    if name == "cubic":
        return cubic_circuit(jax_schema), cubic_circuit(torch_schema), [35, 3]
    pre = int(np.random.default_rng(3).integers(1, 1 << 62))
    return (mimc_circuit(jax_schema, jax_mimc),
            mimc_circuit(torch_schema, torch_mimc),
            [jax_mimc.mimc_hash(JBN254, pre), pre])


def _jax_side(name):
    jc, tc, w = _case(name)
    jcs = jax_compile(jc, JBN254, scheme="plonk")
    cs = compile_circuit(tc, BN254, scheme="plonk")
    jpk, jvk = jp.setup(jcs, JBN254, rng=random.Random(1), host=True)
    want = jp.prove(jcs, jpk, w, rng=random.Random(2))
    return cs, w, jpk, jvk, want


def test_big_domain_size():
    assert [tp._big_domain_size(n) for n in (2, 4, 8, 16, 1 << 16)] == \
        [16, 32, 32, 64, 1 << 18]
    assert all(tp._big_domain_size(n) == jp._big_domain_size(n)
               for n in (1, 2, 4, 8, 1024))


def test_fewer_than_8_rows_prove_from_jax_key_equals_jax():
    cs, w, jpk, jvk, want = _jax_side("square")
    assert jpk.n == 4
    pk = tp.plonk_key_from_jax(jpk, "cpu")
    assert pk.x_E.shape[1] == 32                    # 8n, not 4n
    got = tp.prove(cs, pk, w, rng=random.Random(2))
    same_fields(got, want)
    assert tp.verify(got, pk.vk, w[:1])
    assert not tp.verify(got, pk.vk, [w[0] + 1])


def test_mimc_prove_from_jax_key_equals_jax(monkeypatch):
    cs, w, jpk, jvk, want = _jax_side("mimc")
    assert jpk.n == 512
    pk = tp.plonk_key_from_jax(jpk, "cpu")
    G = tk._Groups(BN254).g1
    served = []

    def msm_on_native_core(G1, xs, ys, inf, scalars):
        """ops.msm.msm's contract, on the native core: Montgomery affine
        planes and regular-form scalars -> one Jacobian point."""
        assert G1 is G
        served.append(xs.shape[1])
        P = native_msm(BN254, G.F.from_mont(xs).numpy(),
                       G.F.from_mont(ys).numpy(), inf.numpy(),
                       scalars.numpy())
        x, y, is_inf = points_to_device(G, [P], 0, "cpu")
        return G.select(is_inf, G.inf(1, "cpu"), G.from_affine((x, y)))

    monkeypatch.setattr(tk, "msm", msm_on_native_core)
    got = tp.prove(cs, pk, w, rng=random.Random(2))
    assert len(served) == 9 and max(served) == 515
    same_fields(got, want)
    assert tp.verify(got, pk.vk, w[:1])
    assert jp.verify(jp.PlonkProof(**dataclasses.asdict(got)), jvk, w[:1])


@pytest.mark.parametrize("name", ["square", "cubic", "mimc"])
def test_host_mode_equals_jax_host_mode(name):
    cs, w, jpk, jvk, want = _jax_side(name)
    pk, vk = tp.setup(cs, BN254, rng=random.Random(1), host=True)
    same_fields(vk, jvk)
    assert pk.host_mode and pk.device is None and pk.srs.device is None
    for f in dataclasses.fields(pk):
        if f.name not in ("curve", "srs", "vk"):
            assert getattr(pk, f.name) == getattr(jpk, f.name), f.name
    got = tp.prove(cs, pk, w, rng=random.Random(2))
    same_fields(got, want)
    assert tp.verify(got, vk, w[:1])
    assert not tp.verify(got, vk, [w[0] + 1])


def test_shared_srs_serves_two_circuits():
    srs = tk.new_srs(BN254, 11, tau=12345, host=True)
    for name in ("square", "cubic"):
        _, tc, w = _case(name)
        cs = compile_circuit(tc, BN254, scheme="plonk")
        pk, vk = tp.setup(cs, BN254, srs=srs, host=True)
        assert tp.verify(tp.prove(cs, pk, w, rng=random.Random(4)), vk, w[:1])
