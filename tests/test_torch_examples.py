"""gnark_tpu_torch's examples proved on the CPU through the port's
harness, against gnark_tpu's.

  * ``prover_succeeded(..., full=True, device="cpu")`` on the cubic and
    exponentiate circuits (and, in test_torch_examples_mimc.py, the
    one-hash MiMC preimage) under Groth16 and under PLONK/KZG: the engine,
    the solver, setup, prove and verify through the port's scheme
    dispatch, with the keys as CPU tensors (every MSM on its plain
    version);
  * with the harness's rng, each proof equals gnark_tpu's: its harness
    draws setup (host=True) and then prove from one
    ``random.Random(rng_seed)``, and so does the port's;
  * the examples' ``main(device="cpu")`` of cubic (Groth16) and of the
    PLONK walkthrough verify and print their lines.

Tolerance: none; points and scalars compare exactly as Python ints.
"""

import dataclasses
import random

import pytest
import torch

import gnark_tpu.examples.cubic as jax_cubic
import gnark_tpu.examples.exponentiate as jax_exp
import gnark_tpu.examples.mimc as jax_mimc_example
import gnark_tpu.frontend.schema as jax_schema
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.backend import plonk as jp
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu.std.mimc import mimc_hash
from gnark_tpu_torch import test_harness
from gnark_tpu_torch.examples import cubic, exponentiate, plonk_main
from gnark_tpu_torch.examples import mimc as mimc_example

torch.set_num_threads(1)

RNG_SEED = 3
# (the port's circuit class, gnark_tpu's, the assignment's values)
EXAMPLES = {
    "cubic": (cubic.CubicCircuit, jax_cubic.CubicCircuit, {"x": 3, "y": 35}),
    "exponentiate": (exponentiate.ExponentiateCircuit,
                     jax_exp.ExponentiateCircuit,
                     {"x": 3, "e": 203, "y": pow(3, 203, JBN254.fr.modulus)}),
    "mimc": (mimc_example.MiMCCircuit, jax_mimc_example.MiMCCircuit,
             {"pre_image": 12345, "hash": mimc_hash(JBN254, 12345)}),
}


def _assign(cls, values):
    a = cls()
    for k, v in values.items():
        setattr(a, k, v)
    return a


def check_example(name, scheme):
    """The port's harness proves the example on the CPU, and its proof is
    gnark_tpu's for the same rng."""
    tcls, jcls, values = EXAMPLES[name]
    proofs = test_harness.prover_succeeded(
        tcls, _assign(tcls, values), schemes=[scheme], full=True,
        rng_seed=RNG_SEED, device="cpu")
    got = proofs["bn254", scheme]
    jw = _assign(jcls, values)
    witness = jax_schema.collect_values(jw)
    ref = jg if scheme == "groth16" else jp
    rng = random.Random(RNG_SEED)
    jcs = jax_compile(jcls(), JBN254, scheme=scheme)
    pk, vk = ref.setup(jcs, JBN254, rng=rng, host=True)
    want = ref.prove(jcs, pk, witness, rng=rng)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    public = jax_schema.collect_values(jw, "public")
    assert ref.verify(want, vk, public)


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
@pytest.mark.parametrize("name", ["cubic", "exponentiate"])
def test_example_proves_on_the_cpu_as_gnark_tpu(name, scheme):
    check_example(name, scheme)


def test_example_mains_verify_on_the_cpu(capsys):
    cubic.main(device="cpu")
    plonk_main.main(device="cpu")
    assert capsys.readouterr().out.splitlines() == [
        "cubic: proof verified (x=3, y=35)",
        "plonk: proof verified (x=3, y=35), wrong input rejected"]
