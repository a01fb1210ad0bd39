"""gnark_tpu_torch.fuzz against gnark_tpu.fuzz: the corpus circuits of
tests/test_fuzz.py, 24 iterations from seed 1 under both schemes.  Each
package fuzzes its own twin of the circuit (the same signals in the same
order, the same ``define``); the port's solvers must agree with its
big-int engine on every witness, and the (accepted, rejected) counts
must equal gnark_tpu's, which they do only if both packages draw the
same witnesses from the same ``random.Random``.

Tolerance: none; the counts compare exactly.
"""

import random

import pytest

import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu_torch.frontend.schema as torch_schema
from circuits_corpus import (
    AddCircuit, AndCircuit, IsZeroCircuit, MulCircuit, SelectCircuit,
    ToBinaryCircuit, XorCircuit,
)
from gnark_tpu import fuzz as jax_fuzz
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu_torch import fuzz
from gnark_tpu_torch.curves import BN254

SCHEMES = ("groth16", "plonk")


def twin(cls):
    """The same circuit as a class of the port's frontend."""
    ns = {"define": cls.define}
    for name, sig in jax_schema._signals(cls):
        kind = (torch_schema.Public if sig.visibility == "public"
                else torch_schema.Secret)
        ns[name] = kind(shape=sig.shape)
    return type(cls.__name__, (torch_schema.Circuit,), ns)


@pytest.mark.parametrize("cls", [
    AddCircuit, MulCircuit, XorCircuit, AndCircuit, SelectCircuit,
    IsZeroCircuit, ToBinaryCircuit,
], ids=lambda c: c.__name__)
def test_fuzz_counts_equal_gnark_tpu(cls):
    got = fuzz.fuzz(twin(cls), BN254, iterations=24, seed=1, schemes=SCHEMES)
    want = jax_fuzz.fuzz(cls, JBN254, iterations=24, seed=1, schemes=SCHEMES)
    assert got == want
    assert sum(got) == 24


def test_fillers_draw_as_gnark_tpu_draws():
    q = BN254.fr.modulus
    got = fuzz.fillers(q, random.Random(3))
    want = jax_fuzz.fillers(q, random.Random(3))
    assert [[f() for f in got] for _ in range(8)] == \
        [[f() for f in want] for _ in range(8)]
