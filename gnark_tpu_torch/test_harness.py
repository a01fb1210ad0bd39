"""Assertion harness: engine-vs-solver differential checks + optional
full prove/verify — the test.Assert analog (test/assert.go:46).

ProverSucceeded semantics mirrored from assert.go:433-471: compile
(twice, requiring identical constraint counts — compile determinism),
engine check, solve; with full=True also Setup/Prove/Verify on the
requested schemes, with the keys on ``device`` (the card unless the
caller names another).  Solve, setup, prove and verify go through the
scheme dispatch of ``backend``.
"""

from __future__ import annotations

import random

from gnark_tpu_torch import backend, test_engine
from gnark_tpu_torch.backend import scs_solver, solver
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend import schema as schema_mod
from gnark_tpu_torch.frontend.compile import compile_circuit


class AssertionError_(AssertionError):
    pass


def _witness(assignment):
    return (schema_mod.collect_values(assignment, "public"),
            schema_mod.collect_values(assignment, "secret"))


def prover_succeeded(circuit_cls, valid_assignment, curves=(BN254,),
                     schemes=("groth16", "plonk"), full=False, rng_seed=0,
                     device="cuda"):
    """-> {(curve name, scheme): proof} of the full runs (empty unless
    full=True).  Each full run draws its setup and then its prove from one
    ``random.Random(rng_seed)``, as gnark_tpu's harness does."""
    proofs = {}
    for curve in curves:
        # 1. reference-engine differential check (test/engine.go oracle)
        test_engine.is_solved(circuit_cls(), valid_assignment, curve)
        pub, sec = _witness(valid_assignment)
        for scheme in schemes:
            cs = compile_circuit(circuit_cls(), curve, scheme=scheme)
            cs2 = compile_circuit(circuit_cls(), curve, scheme=scheme)
            if cs.nb_constraints != cs2.nb_constraints or \
               cs.nb_wires != cs2.nb_wires:
                raise AssertionError_(
                    f"{scheme}/{curve.name}: non-deterministic compile")
            backend.solve(cs, pub + sec)
            if full:
                rng = random.Random(rng_seed)
                pk, vk = backend.setup(cs, curve, rng=rng, device=device)
                proof = backend.prove(cs, pk, pub + sec, rng=rng)
                if not backend.verify(proof, vk, pub):
                    raise AssertionError_(
                        f"{scheme}/{curve.name}: proof rejected")
                proofs[curve.name, scheme] = proof
    return proofs


def prover_failed(circuit_cls, invalid_assignment, curves=(BN254,),
                  schemes=("groth16", "plonk")):
    """Invalid witnesses must fail the engine AND the solver
    (assert.go:187-248 ProverFailed semantics)."""
    for curve in curves:
        engine_ok = True
        try:
            test_engine.is_solved(circuit_cls(), invalid_assignment, curve)
        except Exception:
            engine_ok = False
        if engine_ok:
            raise AssertionError_(
                f"{curve.name}: engine accepted an invalid witness")
        pub, sec = _witness(invalid_assignment)
        for scheme in schemes:
            cs = compile_circuit(circuit_cls(), curve, scheme=scheme)
            solve = solver.is_solved if scheme == "groth16" \
                else scs_solver.is_solved
            if solve(cs, pub + sec):
                raise AssertionError_(
                    f"{scheme}/{curve.name}: solver accepted invalid witness")
