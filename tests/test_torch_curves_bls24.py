"""gnark_tpu_torch's device-path Groth16 over BLS24-315 on the CPU against
gnark_tpu's host mode.

The port's setup(device="cpu") computes the key points with the plain
fixed-base tables (G2 over fp4, its to_affine through FpKOps.inv), and its
prove runs the quotient and the five MSMs through the plain versions of
the kernels (a cubic circuit: every MSM below 8192 points, the ladder,
its reduction and the fold of the chunk sums, G2 over fp4).  With the
same rng, the key points and the proof equal gnark_tpu's host mode's, and
the proof verifies.  A file of its own: the plain fp4 ladders take about
20 s on one CPU core, so this runs on a worker of its own.

Tolerance: none; points compare exactly as Python ints.
"""

import random

import torch

import gnark_tpu.frontend.schema as jax_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.curves import BLS24_315 as JBLS24
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
import gnark_tpu_torch.frontend.schema as torch_schema
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.curves import BLS24_315
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.ops import _cuda

torch.set_num_threads(1)


def cubic_circuit(schema):
    class Cubic(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))
    return Cubic()


def test_bls24_device_path_on_cpu_equals_jax_host_mode():
    jcs = jax_compile(cubic_circuit(jax_schema), JBLS24)
    cs = compile_circuit(cubic_circuit(torch_schema), BLS24_315)
    jpk, jvk = jg.setup(jcs, JBLS24, rng=random.Random(1), host=True)
    pk, vk = tg.setup(cs, BLS24_315, rng=random.Random(1), device="cpu")
    assert not pk.host and not tg.native_route(BLS24_315)
    K = tg._Groups(BLS24_315)
    for f in ("A", "B1", "B2", "K", "Z"):
        G = K.g2 if f == "B2" else K.g1
        x, y, inf = getattr(pk, f)
        got = [None if i else (a, b) for a, b, i in zip(
            G.F.unpack(x), G.F.unpack(y), inf.tolist())]
        assert got == list(getattr(jpk, f)), f
    before = dict(_cuda.launches)
    proof = tg.prove(cs, pk, [35, 3], rng=random.Random(2))
    assert _cuda.launches == before             # the CPU: plain versions
    want = jg.prove(jcs, jpk, [35, 3], rng=random.Random(2))
    assert (proof.ar, proof.bs, proof.krs) == (want.ar, want.bs, want.krs)
    assert tg.verify(proof, vk, [35]) and not tg.verify(proof, vk, [34])
