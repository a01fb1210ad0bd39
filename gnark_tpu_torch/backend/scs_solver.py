"""Sparse (PLONK gate) witness solver.

Semantics mirror internal/backend/bn254/cs/r1cs_sparse.go: each gate has
at most one unsolved non-hint wire; hints resolve lazily
(computeHints :251); the unknown slot is recovered by the linear solve
of qL*l + qR*r + qM*l*r + qO*o + qC = 0 in that slot (:305-361).
"""

from __future__ import annotations

import dataclasses

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.backend.solver import UnsatisfiedConstraintError
from gnark_tpu_torch.utils.logging import logger


class SCSSolution:
    """Solved PLONK witness; int lists or lazy views over limb planes
    (the native path) — mirrors solver.Solution."""

    def __init__(self, values=None, l=None, r=None, o=None,
                 limbs=None, field=None):
        self._ints = {"values": values, "l": l, "r": r, "o": o}
        self.limbs = limbs
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
    def l(self):
        return self._get("l")

    @property
    def r(self):
        return self._get("r")

    @property
    def o(self):
        return self._get("o")


def solve(cs, witness_values, *, check: bool = True,
          native: bool | None = None) -> SCSSolution:
    """witness_values: [public | secret] ints (no constant-one wire).

    native: None (auto) routes wide level schedules through the numpy
    leveled sweep (np_solver.solve_scs_np, the P2 vectorization) and
    large narrow ones through the C gate-walk core; False forces this
    python walk (the semantics reference)."""
    if native is None and getattr(cs, "levels", None):
        avg = cs.nb_constraints / max(1, len(cs.levels))
        if avg >= 512:
            from gnark_tpu_torch.backend import np_solver
            out = np_solver.solve_scs_np(cs, witness_values, check=check)
            if out is not None:
                values, lv, rv, ov = out
                F = np_solver.np_field(
                    np_solver.spec_for_modulus(cs.field_modulus))
                sol = SCSSolution(
                    limbs={"values": values, "l": lv, "r": rv, "o": ov},
                    field=F)
                if cs.logs:
                    _print_logs(cs, sol.values, cs.field_modulus)
                return sol
    if native is None:
        native = cs.nb_constraints >= 2048
    if native:
        from gnark_tpu_torch.backend import native_solver, np_solver
        values, lv, rv, ov = native_solver.solve_scs_native(
            cs, witness_values, check=check)
        F = np_solver.np_field(
            np_solver.spec_for_modulus(cs.field_modulus))
        sol = SCSSolution(
            limbs={"values": values, "l": lv, "r": rv, "o": ov},
            field=F)
        if cs.logs:
            _print_logs(cs, sol.values, cs.field_modulus)
        return sol
    q = cs.field_modulus
    nb_in = cs.nb_public + cs.nb_secret
    if len(witness_values) != nb_in:
        raise ValueError(
            f"witness has {len(witness_values)} values, want {nb_in}")

    values = [0] * cs.nb_wires
    solved = [False] * cs.nb_wires
    for i, v in enumerate(witness_values):
        values[i] = v % q
        solved[i] = True

    coeffs = cs.coeffs

    def solve_hint(w):
        h = cs.hints[cs.wire_to_hint[w]]
        ins = []
        for lc in h.inputs:
            acc = 0
            for iw, cv in lc:
                if iw < 0:
                    acc += cv
                else:
                    if not solved[iw]:
                        solve_hint(iw)
                    acc += cv * values[iw]
            ins.append(acc % q)
        fn = hint_registry.get(h.uuid)
        outs = fn(q, ins, len(h.out_wires))
        for ow, ov in zip(h.out_wires, outs):
            if solved[ow]:
                raise RuntimeError(f"wire {ow} solved twice")
            values[ow] = ov % q
            solved[ow] = True

    m = cs.nb_constraints
    lv, rv, ov = [0] * m, [0] * m, [0] * m
    wl, wr, wo = cs.wires_l, cs.wires_r, cs.wires_o

    for ci in range(m):
        ql = coeffs[cs.q_l[ci]]
        qr = coeffs[cs.q_r[ci]]
        qm = coeffs[cs.q_m[ci]]
        qo = coeffs[cs.q_o[ci]]
        qc = coeffs[cs.q_c[ci]]
        slots = [int(wl[ci]), int(wr[ci]), int(wo[ci])]

        unknown = -1
        for si, w in enumerate(slots):
            if w >= 0 and not solved[w]:
                if w in cs.wire_to_hint:
                    solve_hint(w)
                elif unknown >= 0:
                    raise UnsatisfiedConstraintError(
                        ci, "more than one unsolved wire",
                        cs.debug_info.get(ci))
                else:
                    unknown = si

        def val(si):
            w = slots[si]
            return values[w] if w >= 0 and solved[w] else 0

        l, r, o = val(0), val(1), val(2)
        if unknown < 0:
            if check and (ql * l + qr * r + qm * l * r + qo * o + qc) % q:
                raise UnsatisfiedConstraintError(
                    ci, f"gate {ci} not satisfied", cs.debug_info.get(ci))
        else:
            if unknown < 2 and slots[0] == slots[1]:
                raise UnsatisfiedConstraintError(
                    ci, "quadratic in unknown wire", cs.debug_info.get(ci))
            if unknown == 2:
                den = (-qo) % q
                num = (ql * l + qr * r + qm * l * r + qc) % q
            elif unknown == 1:
                den = (qr + qm * l) % q
                num = (-(ql * l + qo * o + qc)) % q
            else:
                den = (ql + qm * r) % q
                num = (-(qr * r + qo * o + qc)) % q
            if den == 0:
                if check and num % q:
                    raise UnsatisfiedConstraintError(
                        ci, "unsolvable gate", cs.debug_info.get(ci))
                wv = 0
            else:
                wv = num * pow(den, -1, q) % q
            w = slots[unknown]
            values[w] = wv
            solved[w] = True
            l, r, o = val(0), val(1), val(2)

        lv[ci], rv[ci], ov[ci] = l, r, o

    _print_logs(cs, values, q)
    return SCSSolution(values=values, l=lv, r=rv, o=ov)


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
                acc = 0
                for w, cv in part:
                    acc += cv if w < 0 else cv * values[w]
                text.append(str(acc % q))
        logger.info(" ".join(text))
