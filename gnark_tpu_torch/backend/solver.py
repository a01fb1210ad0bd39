"""Witness solver: R1CS + input witness -> full wire vector (+ a, b, c).

Semantics mirror the reference solver (internal/backend/bn254/cs/
r1cs.go:280 solveConstraint): each constraint carries at most one
unsolved non-hint wire; hint wires are resolved lazily through their
registered functions; the unknown is recovered from a*b=c by division
(or set to 0 when the divisor side is 0 and the constraint already
holds).  Solving walks the level schedule so a future device solver can
vectorize within levels (P2 in SURVEY §2.8).
"""

from __future__ import annotations

import dataclasses

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.utils.logging import logger


class UnsatisfiedConstraintError(Exception):
    def __init__(self, constraint_id, msg, debug=None):
        self.constraint_id = constraint_id
        self.debug = debug
        where = f" [{debug}]" if debug else ""
        super().__init__(f"constraint #{constraint_id} is not satisfied: {msg}{where}")


class Solution:
    """Solved witness.  Backed either by python-int lists (scalar solver)
    or by uint64 limb planes (vectorized solver) — in the latter case the
    int views materialize lazily so the device prover can consume the
    limb planes directly with zero int round-trips."""

    def __init__(self, values=None, a=None, b=None, c=None,
                 limbs=None, field=None):
        self._ints = {"values": values, "a": a, "b": b, "c": c}
        self.limbs = limbs        # dict name -> uint64 [L, n] regular form
        self._field = field

    def _get(self, name):
        v = self._ints[name]
        if v is None:
            v = self._field.unpack(self.limbs[name])
            self._ints[name] = v
        return v

    @property
    def values(self):
        return self._get("values")

    @property
    def a(self):
        return self._get("a")

    @property
    def b(self):
        return self._get("b")

    @property
    def c(self):
        return self._get("c")


def solve(cs, witness_values, *, check: bool = True,
          vectorized: bool | None = None) -> Solution:
    """witness_values: [public (no one-wire) | secret] ints.

    vectorized: None (auto) picks the leveled numpy solver
    (np_solver.solve_np) when the level schedule is wide enough to
    amortize its per-level vector-op overhead (measured crossover ~512
    constraints/level); True forces it; False forces the scalar walk
    below, which is the semantics reference.
    """
    want_np = vectorized
    if want_np is None and getattr(cs, "levels", None):
        avg_width = cs.nb_constraints / max(1, len(cs.levels))
        want_np = avg_width >= 512
    if want_np:
        from gnark_tpu_torch.backend import np_solver
        out = np_solver.solve_np(cs, witness_values, check=check)
        if out is not None:
            values, a, b, c = out
            F = np_solver._plan_of(cs).field
            sol = Solution(
                limbs={"values": values, "a": a, "b": b, "c": c}, field=F)
            if cs.logs:
                _print_logs(cs, sol.values, cs.field_modulus)
            return sol
    if vectorized is not False and cs.nb_constraints >= 2048:
        # narrow-level regime at scale: the C++ scalar core (~60ns per
        # constraint vs ~3us for the python walk below)
        from gnark_tpu_torch.backend import native_solver, np_solver
        values, a, b, c = native_solver.solve_native(
            cs, witness_values, check=check)
        F = np_solver.np_field(np_solver.spec_for_modulus(cs.field_modulus))
        sol = Solution(
            limbs={"values": values, "a": a, "b": b, "c": c}, field=F)
        if cs.logs:
            _print_logs(cs, sol.values, cs.field_modulus)
        return sol
    q = cs.field_modulus
    nb_in = cs.nb_public + cs.nb_secret
    if len(witness_values) != nb_in - 1:
        raise ValueError(
            f"witness has {len(witness_values)} values, want {nb_in - 1}")

    values = [0] * cs.nb_wires
    solved = [False] * cs.nb_wires
    values[0] = 1
    solved[0] = True
    for i, v in enumerate(witness_values):
        values[1 + i] = v % q
        solved[1 + i] = True

    coeffs = cs.coeffs
    # CSR -> python lists once (cheap) for fast row iteration
    mats = []
    for M in (cs.L, cs.R, cs.O):
        mats.append((M.indptr.tolist(), M.wires.tolist(), M.coeffs.tolist()))

    def solve_hint(w):
        h = cs.hints[cs.wire_to_hint[w]]
        ins = []
        for lc in h.inputs:
            acc = 0
            for iw, cid in lc:
                if not solved[iw]:
                    solve_hint(iw)
                acc += coeffs[cid] * values[iw]
            ins.append(acc % q)
        fn = hint_registry.get(h.uuid)
        outs = fn(q, ins, len(h.out_wires))
        if len(outs) != len(h.out_wires):
            raise ValueError(
                f"hint {hint_registry.name_of(h.uuid)} returned "
                f"{len(outs)} values, want {len(h.out_wires)}")
        for ow, ov in zip(h.out_wires, outs):
            if solved[ow]:
                raise RuntimeError(f"wire {ow} solved twice")
            values[ow] = ov % q
            solved[ow] = True

    m = cs.nb_constraints
    av, bv, cv = [0] * m, [0] * m, [0] * m

    for ci in range(m):
        vals3 = [0, 0, 0]
        unknown_side = -1
        unknown_term = None
        for side in range(3):
            indptr, wires, cids = mats[side]
            acc = 0
            for k in range(indptr[ci], indptr[ci + 1]):
                w = wires[k]
                if not solved[w]:
                    if w in cs.wire_to_hint:
                        solve_hint(w)
                    else:
                        if unknown_term is not None:
                            raise UnsatisfiedConstraintError(
                                ci, "more than one unsolved wire",
                                cs.debug_info.get(ci))
                        unknown_side = side
                        unknown_term = (w, cids[k])
                        continue
                acc += coeffs[cids[k]] * values[w]
            vals3[side] = acc % q

        a, b, c = vals3
        if unknown_term is None:
            if check and (a * b - c) % q != 0:
                raise UnsatisfiedConstraintError(
                    ci, f"{a} * {b} != {c}", cs.debug_info.get(ci))
        else:
            w, cid = unknown_term
            wire_term = 0
            if unknown_side == 0:
                if b % q != 0:
                    wire_term = (c * pow(b, -1, q) - a) % q
                    a = (a + wire_term) % q
                elif check and (a * b - c) % q != 0:
                    raise UnsatisfiedConstraintError(
                        ci, f"{a} * {b} != {c}", cs.debug_info.get(ci))
            elif unknown_side == 1:
                if a % q != 0:
                    wire_term = (c * pow(a, -1, q) - b) % q
                    b = (b + wire_term) % q
                elif check and (a * b - c) % q != 0:
                    raise UnsatisfiedConstraintError(
                        ci, f"{a} * {b} != {c}", cs.debug_info.get(ci))
            else:
                wire_term = (a * b - c) % q
                c = (c + wire_term) % q
            values[w] = wire_term * pow(coeffs[cid], -1, q) % q
            solved[w] = True

        av[ci], bv[ci], cv[ci] = a, b, c

    _print_logs(cs, values, q)
    return Solution(values=values, a=av, b=bv, c=cv)


def is_solved(cs, witness_values) -> bool:
    try:
        solve(cs, witness_values)
        return True
    except (UnsatisfiedConstraintError, ValueError, ZeroDivisionError):
        return False


def _print_logs(cs, values, q):
    for entry in cs.logs:
        text = []
        for part in entry.parts:
            if isinstance(part, str):
                text.append(part)
            else:
                acc = sum(cs.coeffs[cid] * values[w] for w, cid in part) % q
                text.append(str(acc))
        logger.info(" ".join(text))
