"""The rollup example (EdDSA + Merkle) in gnark_tpu_torch against
gnark_tpu's, at the reference's own size: 16 accounts, inclusion proofs of
depth 4 plus the leaf, one transfer a proof.

  * tests/test_rollup.py through the port's harness: a transfer is solved
    by the engine and the solver, a tampered amount fails both, an
    overdraft is refused by the operator;
  * the port's operator gives gnark_tpu's roots, signatures and witness
    for the same keys and transfers;
  * the full-size RollupCircuit compiles to the same R1CS (27,988
    constraints, 28,011 wires) and sparse R1CS (38,790 constraints) in
    both packages, and both solvers give the same witness.

(A full proof at this size runs on the card in chip_smoke.py: on the CPU
the plain-torch setup alone takes more than ten minutes.)

Tolerance: none; field elements compare exactly as Python ints.
"""

import copy

import pytest

import gnark_tpu.examples.rollup as jax_rollup
import gnark_tpu.frontend.schema as jax_schema
from gnark_tpu.backend import scs_solver as jax_scs_solver
from gnark_tpu.backend import solver as jax_solver
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu.std import eddsa as jax_eddsa
from gnark_tpu_torch import test_harness
from gnark_tpu_torch.backend import scs_solver, solver
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.examples.rollup import (DEPTH, Operator, RollupCircuit,
                                             seeded_operator)
from gnark_tpu_torch.frontend import schema
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.std import eddsa
from test_torch_host_parity import same

SIZES = {"groth16": (27988, 28011), "plonk": (38790, None)}


@pytest.fixture(scope="module")
def operator():
    keys = [eddsa.KeyPair.generate(BN254, bytes([i]) * 8)
            for i in range(1 << DEPTH)]
    return Operator(BN254, keys)


def test_single_transfer(operator):
    w = operator.transfer(0, 1, 100)
    assert operator.accounts[0].balance == 900
    assert operator.accounts[1].balance == 1100
    test_harness.prover_succeeded(RollupCircuit, w, schemes=["groth16"])


def test_tampered_amount_fails(operator):
    w = operator.transfer(2, 3, 50)
    w.amount = 51  # signature and balances no longer match
    test_harness.prover_failed(RollupCircuit, w, schemes=["groth16"])


def test_overdraft_rejected(operator):
    with pytest.raises(AssertionError):
        operator.transfer(4, 5, 10 ** 6)


@pytest.fixture(scope="module")
def transfers():
    """Both packages' operators over the same keys after the same two
    transfers: the assignments of the second."""
    ops = (seeded_operator(BN254),
           jax_rollup.Operator(JBN254, [
               jax_eddsa.KeyPair.generate(JBN254, bytes([i]) * 8)
               for i in range(1 << DEPTH)]))
    for op in ops:
        op.transfer(0, 1, 100)
    tw, jw = (op.transfer(7, 12, 250) for op in ops)
    assert ops[0].root() == ops[1].root()
    assert [a.leaf(BN254) for a in ops[0].accounts] == ops[1].leaves()
    return tw, jw


def test_operator_gives_the_reference_witness(transfers):
    tw, jw = transfers
    assert schema.collect_values(tw) == jax_schema.collect_values(jw)


def _compile_both(scheme):
    """(gnark_tpu's system, the port's), compiled from one line: each
    frontend names the first caller outside its package in the systems'
    debug info."""
    return [compile(circuit, curve, scheme=scheme) for compile, circuit, curve
            in ((jax_compile, jax_rollup.RollupCircuit(), JBN254),
                (compile_circuit, RollupCircuit(), BN254))]


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
def test_full_size_rollup_compiles_to_the_same_system(scheme):
    jcs, tcs = _compile_both(scheme)
    constraints, wires = SIZES[scheme]
    assert tcs.nb_constraints == constraints
    if wires is not None:
        assert tcs.nb_wires == wires
    same(jcs, tcs)


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
def test_full_size_rollup_solves_to_the_same_witness(transfers, scheme):
    tw, _ = transfers
    values = schema.collect_values(tw)
    jcs, tcs = _compile_both(scheme)
    if scheme == "groth16":
        ref, port, fields = jax_solver, solver, ("values", "a", "b", "c")
    else:
        ref, port, fields = jax_scs_solver, scs_solver, ("values", "l", "r", "o")
    want, got = ref.solve(jcs, values), port.solve(tcs, values)
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    tampered = copy.copy(tw)
    tampered.amount += 1
    with pytest.raises(solver.UnsatisfiedConstraintError):
        port.solve(tcs, schema.collect_values(tampered))
