"""Vectorized leveled R1CS witness solver (SURVEY §2.8 P2).

Consumes the compile-time level schedule (frontend/r1cs_builder.py
_build_levels; reference frontend/cs/r1cs/builder.go:407) to solve whole
levels at once with numpy Montgomery limb planes — replacing the
per-constraint python-int walk of backend/solver.py for large systems.
Reference semantics: internal/backend/bn254/cs/r1cs.go:127 parallelSolve
(worker pool per level) — the host analog is one vector sweep per
level.

The plan is built once per compiled system (cached on the CS object).
Circuits the plan can't express (an unknown wire appearing on two sides)
fall back to the scalar solver.  Hint functions run on host ints between
level sweeps, exactly at the level where their outputs are first needed.

Solutions carry their wire/a/b/c vectors as uint64 limb planes (regular
form) — the device prover consumes them without any int round-trip.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.fields import ALL_FIELDS
from gnark_tpu_torch.fields.np_field import NpField, np_field
from gnark_tpu_torch.fields.spec import FieldSpec


def spec_for_modulus(q: int) -> FieldSpec:
    for spec in ALL_FIELDS.values():
        if spec.modulus == q:
            return spec
    # multiplicative generator is irrelevant for solver arithmetic
    return FieldSpec(name=f"fr_{q % 100000}", modulus=q,
                     multiplicative_generator=0)


@dataclasses.dataclass
class _Level:
    rows: np.ndarray                 # [nrow] constraint ids
    side_ptr: list                   # 3x [nrow] reduceat starts
    side_wire: list                  # 3x [nnz_s]
    side_cmont: list                 # 3x [L, nnz_s] Montgomery coeffs
    unk_side: np.ndarray             # [nrow] int8: -1 none, 0/1/2
    unk_wire: np.ndarray             # [nrow] (0 where none)
    unk_icoef: np.ndarray            # [L, nrow] mont inverse coeffs
    hint_ids: list                   # hints to run before this level


@dataclasses.dataclass
class NpPlan:
    field: NpField
    levels: list
    nb_in: int


def build_plan(cs):
    """-> NpPlan or None (None = fall back to the scalar solver)."""
    if not getattr(cs, "levels", None):
        return None
    q = cs.field_modulus
    F = np_field(spec_for_modulus(q))
    nb_in = cs.nb_public + cs.nb_secret

    coeffs = cs.coeffs
    cmont_table = F.pack(list(coeffs), mont=True)        # [L, ncoeff]
    mats = [(cs.L.indptr, cs.L.wires, cs.L.coeffs),
            (cs.R.indptr, cs.R.wires, cs.R.coeffs),
            (cs.O.indptr, cs.O.wires, cs.O.coeffs)]

    solved = np.zeros(cs.nb_wires, bool)
    solved[:nb_in] = True
    hint_done = [False] * len(cs.hints)

    def hint_closure(widx, acc):
        """Hints (transitively) needed to materialize wire widx."""
        h = cs.wire_to_hint.get(widx)
        if h is None or hint_done[h]:
            return
        hint_done[h] = True
        for lc in cs.hints[h].inputs:
            for iw, _ in lc:
                if not solved[iw]:
                    hint_closure(iw, acc)
        acc.append(h)
        for ow in cs.hints[h].out_wires:
            solved[ow] = True

    levels = []
    for lvl_rows in cs.levels:
        nrow = len(lvl_rows)
        rows = np.asarray(lvl_rows, np.int64)
        hint_ids = []
        unk_side = np.full(nrow, -1, np.int8)
        unk_wire = np.zeros(nrow, np.int64)
        unk_cid = np.zeros(nrow, np.int64)
        s_wire = [[], [], []]
        s_coef = [[], [], []]
        s_len = [[], [], []]
        newly_solved = []
        for ri, ci in enumerate(lvl_rows):
            unknown = None
            for side in range(3):
                indptr, wires, cids = mats[side]
                w_list, c_list = [], []
                for k in range(int(indptr[ci]), int(indptr[ci + 1])):
                    w = int(wires[k])
                    if not solved[w] and w not in cs.wire_to_hint:
                        if unknown is not None:
                            return None     # 2 unknowns / cross-side unknown
                        unknown = (side, w, int(cids[k]))
                        continue
                    if not solved[w]:
                        hint_closure(w, hint_ids)
                    w_list.append(w)
                    c_list.append(int(cids[k]))
                if not w_list:              # keep reduceat segments nonempty
                    w_list, c_list = [0], [-1]   # sentinel: zero coeff
                s_wire[side].extend(w_list)
                s_coef[side].extend(c_list)
                s_len[side].append(len(w_list))
            if unknown is not None:
                side, w, cid = unknown
                unk_side[ri] = side
                unk_wire[ri] = w
                unk_cid[ri] = cid
                newly_solved.append(w)
        for w in newly_solved:
            solved[w] = True

        zero_col = F.zeros(1)
        side_ptr, side_wire, side_cmont = [], [], []
        for side in range(3):
            lens = np.asarray(s_len[side], np.int64)
            ptr = np.zeros(nrow, np.int64)
            np.cumsum(lens[:-1], out=ptr[1:])
            side_ptr.append(ptr)
            side_wire.append(np.asarray(s_wire[side], np.int64))
            cids = np.asarray(s_coef[side], np.int64)
            cm = np.where(cids[None, :] >= 0,
                          cmont_table[:, np.maximum(cids, 0)],
                          np.broadcast_to(zero_col, (F.L, len(cids))))
            side_cmont.append(np.ascontiguousarray(cm))
        icoef_ints = [pow(coeffs[c], -1, q) if s >= 0 else 0
                      for c, s in zip(unk_cid.tolist(), unk_side.tolist())]
        levels.append(_Level(
            rows=rows, side_ptr=side_ptr, side_wire=side_wire,
            side_cmont=side_cmont, unk_side=unk_side, unk_wire=unk_wire,
            unk_icoef=F.pack(icoef_ints, mont=True), hint_ids=hint_ids))

    if not all(hint_done) and cs.hints:
        # hints never referenced by any constraint still must run (their
        # outputs could feed logs); run leftovers at the end
        leftovers = [i for i, d in enumerate(hint_done) if not d]
        if leftovers:
            for h in leftovers:
                hint_done[h] = True
            levels.append(_Level(
                rows=np.zeros(0, np.int64),
                side_ptr=[np.zeros(0, np.int64)] * 3,
                side_wire=[np.zeros(0, np.int64)] * 3,
                side_cmont=[F.zeros(0)] * 3,
                unk_side=np.zeros(0, np.int8),
                unk_wire=np.zeros(0, np.int64),
                unk_icoef=F.zeros(0), hint_ids=leftovers))
    return NpPlan(field=F, levels=levels, nb_in=nb_in)


def _plan_of(cs):
    if not hasattr(cs, "_np_plan"):
        cs._np_plan = build_plan(cs)
    return cs._np_plan


def _run_hints(cs, F, values, hint_ids, q):
    for hidx in hint_ids:
        h = cs.hints[hidx]
        ins = []
        for lc in h.inputs:
            acc = 0
            for iw, cid in lc:
                acc += cs.coeffs[cid] * F.unpack(values[:, iw:iw + 1])[0]
            ins.append(acc % q)
        fn = hint_registry.get(h.uuid)
        outs = fn(q, ins, len(h.out_wires))
        if len(outs) != len(h.out_wires):
            raise ValueError(
                f"hint {hint_registry.name_of(h.uuid)} returned "
                f"{len(outs)} values, want {len(h.out_wires)}")
        values[:, np.asarray(h.out_wires, np.int64)] = F.pack(
            [int(o) % q for o in outs])


def solve_np(cs, witness_values, *, check: bool = True):
    """Leveled vector solve.  Returns (values, a, b, c) as uint64 limb
    planes (regular form), or None if no plan exists.  Raises
    UnsatisfiedConstraintError exactly like the scalar solver."""
    from gnark_tpu_torch.backend.solver import UnsatisfiedConstraintError

    plan = _plan_of(cs)
    if plan is None:
        return None
    F = plan.field
    q = cs.field_modulus
    nb_in = plan.nb_in
    if len(witness_values) != nb_in - 1:
        raise ValueError(
            f"witness has {len(witness_values)} values, want {nb_in - 1}")

    values = F.zeros(cs.nb_wires)
    values[0, 0] = 1
    if witness_values:
        values[:, 1:nb_in] = F.pack([v % q for v in witness_values])

    m = cs.nb_constraints
    av, bv, cv = F.zeros(m), F.zeros(m), F.zeros(m)

    def fail(rows_mask, rows, sums, msg_fmt):
        ri = int(np.nonzero(rows_mask)[0][0])
        ci = int(rows[ri])
        a0 = F.unpack(sums[0][:, ri:ri + 1])[0]
        b0 = F.unpack(sums[1][:, ri:ri + 1])[0]
        c0 = F.unpack(sums[2][:, ri:ri + 1])[0]
        raise UnsatisfiedConstraintError(
            ci, f"{a0} * {b0} != {c0}", cs.debug_info.get(ci))

    for lvl in plan.levels:
        if lvl.hint_ids:
            _run_hints(cs, F, values, lvl.hint_ids, q)
        nrow = len(lvl.rows)
        if nrow == 0:
            continue
        sums = []
        for side in range(3):
            prods = F.mmul(values[:, lvl.side_wire[side]],
                           lvl.side_cmont[side])
            lazy = np.add.reduceat(prods, lvl.side_ptr[side], axis=1)
            sums.append(F.reduce_sum_lazy(lazy))
        a0, b0, c0 = sums

        unk = lvl.unk_side
        # --- no unknown: pure check ---
        if check:
            none_rows = unk < 0
            if none_rows.any():
                prod = F.mmul(F.to_mont(a0), b0)
                bad = none_rows & ~np.all(prod == c0, axis=0)
                if bad.any():
                    fail(bad, lvl.rows, sums, None)

        wire_term = F.zeros(nrow)
        # --- unknown on O: term = a*b - c0 (no inversion) ---
        o_rows = unk == 2
        if o_rows.any():
            ab = F.mmul(F.to_mont(a0), b0)
            wire_term = np.where(o_rows, F.sub(ab, c0), wire_term)
        # --- unknown on A or B: term = c0 * other^{-1} - self0 ---
        for side, other in ((0, b0), (1, a0)):
            s_rows = unk == side
            if not s_rows.any():
                continue
            other_m = F.to_mont(other)
            inv_m = F.batch_inv_mont(np.where(s_rows, other_m, 0))
            quot = F.mmul(c0, inv_m)        # regular c0/other (0 if other=0)
            term = F.sub(quot, a0 if side == 0 else b0)
            nz = ~F.is_zero(other_m)
            wire_term = np.where(s_rows & nz, term, wire_term)
            if check:
                # other == 0: constraint must already hold with term 0
                zr = s_rows & ~nz
                if zr.any():
                    bad = zr & ~F.is_zero(c0)
                    if bad.any():
                        fail(bad, lvl.rows, sums, None)

        vals = F.mmul(lvl.unk_icoef, wire_term)
        has_unk = unk >= 0
        if has_unk.any():
            values[:, lvl.unk_wire[has_unk]] = vals[:, has_unk]
        a_row = np.where(unk == 0, F.add(a0, wire_term), a0)
        b_row = np.where(unk == 1, F.add(b0, wire_term), b0)
        c_row = np.where(unk == 2, F.add(c0, wire_term), c0)
        av[:, lvl.rows] = a_row
        bv[:, lvl.rows] = b_row
        cv[:, lvl.rows] = c_row

    return values, av, bv, cv


# ---- SCS (PLONK gate) leveled vector solve --------------------------------


@dataclasses.dataclass
class _ScsLevel:
    rows: np.ndarray          # gate ids
    wl: np.ndarray            # slot wires (-1 = none)
    wr: np.ndarray
    wo: np.ndarray
    qlm: np.ndarray           # [L, nrow] Montgomery coeffs
    qrm: np.ndarray
    qmm: np.ndarray
    qom: np.ndarray
    qcr: np.ndarray           # [L, nrow] regular qC
    unk: np.ndarray           # unknown slot: -1 none, 0/1/2
    hint_ids: list


@dataclasses.dataclass
class ScsPlan:
    field: NpField
    levels: list
    nb_in: int


def build_scs_plan(cs):
    """Leveled plan for the PLONK gate system (consumes the compile-time
    SCS level schedule, the buildLevels output)."""
    if not getattr(cs, "levels", None):
        return None
    q = cs.field_modulus
    F = np_field(spec_for_modulus(q))
    nb_in = cs.nb_public + cs.nb_secret
    cmont = F.pack(list(cs.coeffs), mont=True)
    creg = F.pack(list(cs.coeffs))

    solved = np.zeros(cs.nb_wires, bool)
    solved[:nb_in] = True
    hint_done = [False] * len(cs.hints)

    def hint_closure(widx, acc):
        h = cs.wire_to_hint.get(widx)
        if h is None or hint_done[h]:
            return
        hint_done[h] = True
        for lc in cs.hints[h].inputs:
            for iw, _ in lc:
                if iw >= 0 and not solved[iw]:
                    hint_closure(iw, acc)
        acc.append(h)
        for ow in cs.hints[h].out_wires:
            solved[ow] = True

    levels = []
    for lvl_rows in cs.levels:
        rows = np.asarray(lvl_rows, np.int64)
        hint_ids = []
        unk = np.full(len(rows), -1, np.int8)
        newly = []
        for ri, ci in enumerate(lvl_rows):
            slots = (int(cs.wires_l[ci]), int(cs.wires_r[ci]),
                     int(cs.wires_o[ci]))
            unknown = None
            for si, w in enumerate(slots):
                if w >= 0 and not solved[w]:
                    if w in cs.wire_to_hint:
                        hint_closure(w, hint_ids)
                    elif unknown is not None:
                        return None
                    else:
                        unknown = si
            if unknown is not None:
                if unknown < 2 and slots[0] == slots[1]:
                    return None          # quadratic in unknown
                unk[ri] = unknown
                newly.append(slots[unknown])
        for w in newly:
            solved[w] = True

        def col(ids):
            return np.ascontiguousarray(
                cmont[:, np.asarray(ids, np.int64)[rows]])

        levels.append(_ScsLevel(
            rows=rows,
            wl=np.asarray(cs.wires_l, np.int64)[rows],
            wr=np.asarray(cs.wires_r, np.int64)[rows],
            wo=np.asarray(cs.wires_o, np.int64)[rows],
            qlm=col(cs.q_l), qrm=col(cs.q_r), qmm=col(cs.q_m),
            qom=col(cs.q_o),
            qcr=np.ascontiguousarray(
                creg[:, np.asarray(cs.q_c, np.int64)[rows]]),
            unk=unk, hint_ids=hint_ids))
    return ScsPlan(field=F, levels=levels, nb_in=nb_in)


def _scs_plan_of(cs):
    if not hasattr(cs, "_np_scs_plan"):
        cs._np_scs_plan = build_scs_plan(cs)
    return cs._np_scs_plan


def solve_scs_np(cs, witness_values, *, check: bool = True):
    """Leveled vector solve of the PLONK gate system; returns
    (values, l, r, o) limb planes or None (no plan)."""
    from gnark_tpu_torch.backend.solver import UnsatisfiedConstraintError

    plan = _scs_plan_of(cs)
    if plan is None:
        return None
    F = plan.field
    q = cs.field_modulus
    nb_in = plan.nb_in
    if len(witness_values) != nb_in:
        raise ValueError(
            f"witness has {len(witness_values)} values, want {nb_in}")

    values = F.zeros(cs.nb_wires + 1)     # extra slot for wire -1 (zero)
    if witness_values:
        values[:, :nb_in] = F.pack([v % q for v in witness_values])

    m = cs.nb_constraints
    lv, rv, ov = F.zeros(m), F.zeros(m), F.zeros(m)

    def run_hints(hint_ids):
        for hidx in hint_ids:
            h = cs.hints[hidx]
            ins = []
            for lc in h.inputs:
                acc = 0
                for iw, cv in lc:
                    if iw < 0:
                        acc += cv
                    else:
                        acc += cv * F.unpack(values[:, iw:iw + 1])[0]
                ins.append(acc % q)
            from gnark_tpu_torch.backend import hints as hint_registry
            fn = hint_registry.get(h.uuid)
            outs = fn(q, ins, len(h.out_wires))
            values[:, np.asarray(h.out_wires, np.int64)] = F.pack(
                [int(o) % q for o in outs])

    for lvl in plan.levels:
        if lvl.hint_ids:
            run_hints(lvl.hint_ids)
        nrow = len(lvl.rows)
        if nrow == 0:
            continue
        # slot values (wire -1 -> the zero slot at the end)
        l0 = values[:, lvl.wl]
        r0 = values[:, lvl.wr]
        o0 = values[:, lvl.wo]
        ql_l = F.mmul(lvl.qlm, l0)
        qr_r = F.mmul(lvl.qrm, r0)
        qm_l = F.mmul(lvl.qmm, l0)
        qm_lr = F.mmul(F.to_mont(qm_l), r0)
        qo_o = F.mmul(lvl.qom, o0)
        resid = F.add(F.add(F.add(ql_l, qr_r), F.add(qm_lr, qo_o)), lvl.qcr)

        unk = lvl.unk
        if check:
            none_rows = unk < 0
            if none_rows.any():
                bad = none_rows & ~F.is_zero(resid)
                if bad.any():
                    ci = int(lvl.rows[int(np.nonzero(bad)[0][0])])
                    raise UnsatisfiedConstraintError(
                        ci, f"gate {ci} not satisfied", cs.debug_info.get(ci))

        for side in (0, 1, 2):
            s_rows = unk == side
            if not s_rows.any():
                continue
            if side == 2:
                den_m = lvl.qom                      # -qo... den = -qo
                num = F.sub(resid, qo_o)             # ql l + qr r + qm lr + qc
                den = F.neg(F.mmul(den_m, np.broadcast_to(
                    F.pack([1]), den_m.shape)))      # regular -qo
            elif side == 1:
                den = F.add(F.mmul(lvl.qrm, np.broadcast_to(
                    F.pack([1]), lvl.qrm.shape)), qm_l)   # qr + qm*l
                num = F.neg(F.sub(resid, F.add(qr_r, qm_lr)))
            else:
                qm_r = F.mmul(lvl.qmm, r0)
                den = F.add(F.mmul(lvl.qlm, np.broadcast_to(
                    F.pack([1]), lvl.qlm.shape)), qm_r)
                num = F.neg(F.sub(resid, F.add(ql_l, qm_lr)))
            den_m2 = F.to_mont(den)
            inv_m = F.batch_inv_mont(np.where(s_rows, den_m2, 0))
            wv = F.mmul(num, inv_m)
            zden = F.is_zero(den_m2) & s_rows
            if check and zden.any():
                bad = zden & ~F.is_zero(num)
                if bad.any():
                    ci = int(lvl.rows[int(np.nonzero(bad)[0][0])])
                    raise UnsatisfiedConstraintError(
                        ci, "unsolvable gate", cs.debug_info.get(ci))
            wires = (lvl.wl, lvl.wr, lvl.wo)[side]
            sel = s_rows & (wires >= 0)
            values[:, wires[sel]] = wv[:, sel]

        # refresh slot values with solved unknowns, record l/r/o rows
        lv[:, lvl.rows] = values[:, lvl.wl]
        rv[:, lvl.rows] = values[:, lvl.wr]
        ov[:, lvl.rows] = values[:, lvl.wo]

    return values[:, :cs.nb_wires], lv, rv, ov
