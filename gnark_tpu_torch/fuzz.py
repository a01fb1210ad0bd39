"""Witness fuzzing: fill circuit inputs with adversarial values and
require solver/engine agreement (counterpart of gnark_tpu/fuzz.py, with
the same draws from ``random.Random(seed)``, so a seed gives the same
witnesses and counts in both packages).

Reference: test/fuzz.go:16-113 — fillers draw from zeros, binary values,
a corpus of interesting field elements (+-5 around 0, around the modulus,
powers of two), and randoms; Assert.Fuzz (test/assert.go:346) requires
the real solver to agree with the big-int engine on accept/reject.
"""

from __future__ import annotations

import random

from gnark_tpu_torch import test_engine
from gnark_tpu_torch.backend import scs_solver, solver
from gnark_tpu_torch.frontend import schema as schema_mod
from gnark_tpu_torch.frontend.compile import compile_circuit


def corpus_values(q: int):
    vals = []
    for d in range(-5, 6):
        vals.append(d % q)
        vals.append((q + d) % q)
    k = 1
    while k < q:
        vals.append(k % q)
        k <<= 64
    return vals


def fillers(q: int, rng: random.Random):
    corpus = corpus_values(q)
    return [
        lambda: 0,
        lambda: rng.randint(0, 1),
        lambda: rng.choice(corpus),
        lambda: rng.randrange(q),
    ]


def fuzz(circuit_cls, curve, iterations: int = 20, seed: int = 0,
         schemes=("groth16",)):
    """Random witnesses: solver result must agree with the engine.
    Returns (nb_accepted, nb_rejected)."""
    rng = random.Random(seed)
    q = curve.fr.modulus
    fills = fillers(q, rng)
    compiled = {s: compile_circuit(circuit_cls(), curve, scheme=s)
                for s in schemes}
    pub_leaves, sec_leaves = schema_mod.schema_of(circuit_cls)
    accepted = rejected = 0
    for it in range(iterations):
        fill = fills[it % len(fills)]
        assignment = circuit_cls()
        values = {}
        for name, sig in schema_mod._signals(circuit_cls):
            values[name] = schema_mod._nested(sig.shape, lambda p: fill())
        for name, v in values.items():
            setattr(assignment, name, v)
        engine_ok = True
        try:
            test_engine.is_solved(circuit_cls(), assignment, curve)
        except Exception:
            engine_ok = False
        pub = schema_mod.collect_values(assignment, "public")
        sec = schema_mod.collect_values(assignment, "secret")
        for s, cs in compiled.items():
            solve_ok = (solver.is_solved if s == "groth16"
                        else scs_solver.is_solved)(cs, pub + sec)
            if solve_ok != engine_ok:
                raise AssertionError(
                    f"fuzz disagreement ({s}, iter {it}): engine="
                    f"{engine_ok} solver={solve_ok} witness={pub + sec}")
        accepted += engine_ok
        rejected += not engine_ok
    return accepted, rejected
