"""ctypes bridge to the C++ R1CS solver core (native/solver_core.cpp).

Handles the narrow-level regime where neither python-int walking
(~3us/constraint) nor the numpy leveled sweep (per-level overhead) can
reach the 2^20-in-under-a-second target.  Hint wires call back into
Python, reading and writing the shared values buffer in place.

Wire values cross the boundary in regular form as [nwires, N] uint64
little-endian limbs; a cheap numpy view turns them into the 16-bit limb
planes the device kernels consume (see _to_planes).
"""

from __future__ import annotations

import ctypes

import numpy as np

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.fields.np_field import np_field
from gnark_tpu_torch.backend.np_solver import spec_for_modulus

_HINT_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int64)


def _nlimbs64(q: int) -> int:
    n = -(-q.bit_length() // 64)
    for cand in (1, 2, 3, 4, 5, 6, 8, 10, 12):
        if cand >= n:
            return cand
    raise ValueError(f"modulus too wide: {q.bit_length()} bits")


def _pack64(ints, N, q=None) -> np.ndarray:
    """list[int] -> [n, N] uint64 little-endian limbs."""
    buf = b"".join(int(v).to_bytes(8 * N, "little") for v in ints)
    return np.frombuffer(buf, dtype="<u8").reshape(len(ints), N).copy()


def _unpack64(arr) -> list:
    raw = np.ascontiguousarray(arr.astype("<u8")).tobytes()
    nb = 8 * arr.shape[1]
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
            for i in range(arr.shape[0])]


def _to_planes(arr64, L16) -> np.ndarray:
    """[n, N] uint64 regular limbs -> [L16, n] uint64 16-bit limb planes
    (the np_field / device layout).  Zero-copy view + one cast."""
    import sys
    assert sys.byteorder == "little"
    n, N = arr64.shape
    u16 = arr64.view(np.uint16).reshape(n, 4 * N)
    k = min(L16, 4 * N)
    if k == L16:
        return u16[:, :k].T.astype(np.uint64)
    out = np.zeros((L16, n), np.uint64)
    out[:k] = u16[:, :k].T
    return out


class _SolveState:
    """Python-side context for hint callbacks."""

    def __init__(self, cs, values64, solved, N, q):
        self.cs = cs
        self.values = values64
        self.solved = solved
        self.N = N
        self.q = q
        self.error = None

    def read_wire(self, w: int) -> int:
        return int.from_bytes(
            self.values[w].astype("<u8").tobytes(), "little")

    def write_wire(self, w: int, v: int):
        self.values[w] = np.frombuffer(
            (v % self.q).to_bytes(8 * self.N, "little"), dtype="<u8")
        self.solved[w] = 1

    def run_hint(self, hidx: int) -> int:
        try:
            cs, q = self.cs, self.q
            h = cs.hints[hidx]
            ins = []
            for lc in h.inputs:
                acc = 0
                for iw, cid in lc:
                    if not self.solved[iw]:
                        dep = cs.wire_to_hint.get(iw)
                        if dep is None:
                            return 1
                        rc = self.run_hint(dep)
                        if rc:
                            return rc
                    acc += cs.coeffs[cid] * self.read_wire(iw)
                ins.append(acc % q)
            fn = hint_registry.get(h.uuid)
            outs = fn(q, ins, len(h.out_wires))
            if len(outs) != len(h.out_wires):
                raise ValueError(
                    f"hint {hint_registry.name_of(h.uuid)} returned "
                    f"{len(outs)} values, want {len(h.out_wires)}")
            for ow, ov in zip(h.out_wires, outs):
                self.write_wire(ow, int(ov))
            return 0
        except Exception as e:   # surfaces as -3 from the core
            self.error = e
            return 1


def solve_native(cs, witness_values, *, check: bool = True):
    """-> (values, a, b, c) as uint64 16-bit limb planes [L16, n]
    (regular form, np_field layout).

    On unsatisfied constraints / structural errors raises via the scalar
    solver re-run (exact same exception text as the reference path)."""
    from gnark_tpu_torch.native import solver_lib
    lib = solver_lib()

    q = cs.field_modulus
    N = _nlimbs64(q)
    spec = spec_for_modulus(q)
    F = np_field(spec)
    nb_in = cs.nb_public + cs.nb_secret
    if len(witness_values) != nb_in - 1:
        raise ValueError(
            f"witness has {len(witness_values)} values, want {nb_in - 1}")

    R = pow(2, 64 * N, q)
    mod64 = _pack64([q], N)
    r2_64 = _pack64([R * R % q], N)
    one64 = _pack64([R % q], N)
    coeffs_mont = _pack64([c % q * R % q for c in cs.coeffs], N)
    coeffs_inv = _pack64(
        [(pow(c, -1, q) * R % q) if c % q else 0 for c in cs.coeffs], N)

    values = np.zeros((cs.nb_wires, N), np.uint64)
    solved = np.zeros(cs.nb_wires, np.uint8)
    values[0, 0] = 1
    solved[0] = 1
    if witness_values:
        values[1:nb_in] = _pack64([v % q for v in witness_values], N, q)
        solved[1:nb_in] = 1

    w2h = np.full(cs.nb_wires, -1, np.int64)
    for w, h in cs.wire_to_hint.items():
        w2h[w] = h

    m = cs.nb_constraints
    av = np.zeros((m, N), np.uint64)
    bv = np.zeros((m, N), np.uint64)
    cv = np.zeros((m, N), np.uint64)

    state = _SolveState(cs, values, solved, N, q)

    @_HINT_CB
    def cb(_ctx, hidx):
        return state.run_hint(int(hidx))

    def ptr64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    # int64 copies of the CSR arrays, kept alive through the call
    keep = [np.ascontiguousarray(np.asarray(x), np.int64)
            for M in (cs.L, cs.R, cs.O)
            for x in (M.indptr, M.wires, M.coeffs)]
    mats = [arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            for arr in keep]

    rc = lib.gnark_solve_r1cs(
        ctypes.c_int(N), ptr64(mod64), ptr64(r2_64), ptr64(one64),
        ctypes.c_int64(m), ctypes.c_int64(cs.nb_wires),
        ctypes.c_int64(len(cs.coeffs)),
        *mats,
        ptr64(coeffs_mont), ptr64(coeffs_inv),
        ptr64(values), solved.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w2h.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ptr64(av), ptr64(bv), ptr64(cv),
        cb, None, ctypes.c_int(1 if check else 0))

    if rc == -3 and state.error is not None:
        raise state.error
    if rc != -1:
        # unsatisfied / structural: re-run the scalar solver for the
        # exact reference exception (perf is irrelevant on failure)
        from gnark_tpu_torch.backend import solver as scalar
        scalar.solve(cs, witness_values, check=check, vectorized=False)
        raise RuntimeError(
            f"native solver failed (rc={rc}) but scalar solver succeeded")

    L16 = F.L
    return (_to_planes(values, L16), _to_planes(av, L16),
            _to_planes(bv, L16), _to_planes(cv, L16))


class _ScsSolveState(_SolveState):
    """SCS hint callback: hint-input LC terms are (wire, coeff-VALUE)
    with wire < 0 meaning a constant (scs_builder AffineTerm encoding)."""

    def run_hint(self, hidx: int) -> int:
        try:
            cs, q = self.cs, self.q
            h = cs.hints[hidx]
            ins = []
            for lc in h.inputs:
                acc = 0
                for iw, cv in lc:
                    if iw < 0:
                        acc += cv
                        continue
                    if not self.solved[iw]:
                        dep = cs.wire_to_hint.get(iw)
                        if dep is None:
                            return 1
                        rc = self.run_hint(dep)
                        if rc:
                            return rc
                    acc += cv * self.read_wire(iw)
                ins.append(acc % q)
            fn = hint_registry.get(h.uuid)
            outs = fn(q, ins, len(h.out_wires))
            if len(outs) != len(h.out_wires):
                raise ValueError("hint output arity mismatch")
            for ow, ov in zip(h.out_wires, outs):
                self.write_wire(ow, int(ov))
            return 0
        except Exception as e:
            self.error = e
            return 1


def solve_scs_native(cs, witness_values, *, check: bool = True):
    """-> (values, l, r, o) uint64 16-bit limb planes."""
    from gnark_tpu_torch.native import solver_lib
    lib = solver_lib()

    q = cs.field_modulus
    N = _nlimbs64(q)
    F = np_field(spec_for_modulus(q))
    nb_in = cs.nb_public + cs.nb_secret
    if len(witness_values) != nb_in:
        raise ValueError(
            f"witness has {len(witness_values)} values, want {nb_in}")

    R = pow(2, 64 * N, q)
    mod64 = _pack64([q], N)
    r2_64 = _pack64([R * R % q], N)
    one64 = _pack64([R % q], N)
    coeffs_mont = _pack64([c % q * R % q for c in cs.coeffs], N)
    coeffs_reg = _pack64([c % q for c in cs.coeffs], N)
    coeffs_neg_inv = _pack64(
        [(pow(-c, -1, q) * R % q) if c % q else 0 for c in cs.coeffs], N)

    values = np.zeros((cs.nb_wires, N), np.uint64)
    solved = np.zeros(cs.nb_wires, np.uint8)
    if witness_values:
        values[:nb_in] = _pack64([v % q for v in witness_values], N)
        solved[:nb_in] = 1

    w2h = np.full(cs.nb_wires, -1, np.int64)
    for w, h in cs.wire_to_hint.items():
        w2h[w] = h

    m = cs.nb_constraints
    lv = np.zeros((m, N), np.uint64)
    rv = np.zeros((m, N), np.uint64)
    ov = np.zeros((m, N), np.uint64)

    state = _ScsSolveState(cs, values, solved, N, q)

    @_HINT_CB
    def cb(_ctx, hidx):
        return state.run_hint(int(hidx))

    def ptr64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    keep = [np.ascontiguousarray(np.asarray(x), np.int64)
            for x in (cs.wires_l, cs.wires_r, cs.wires_o,
                      cs.q_l, cs.q_r, cs.q_m, cs.q_o, cs.q_c)]
    iptrs = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) for a in keep]

    rc = lib.gnark_solve_scs(
        ctypes.c_int(N), ptr64(mod64), ptr64(r2_64), ptr64(one64),
        ctypes.c_int64(m), ctypes.c_int64(cs.nb_wires),
        ctypes.c_int64(len(cs.coeffs)),
        *iptrs,
        ptr64(coeffs_mont), ptr64(coeffs_reg), ptr64(coeffs_neg_inv),
        ptr64(values), solved.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w2h.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ptr64(lv), ptr64(rv), ptr64(ov),
        cb, None, ctypes.c_int(1 if check else 0))

    if rc == -3 and state.error is not None:
        raise state.error
    if rc != -1:
        from gnark_tpu_torch.backend import scs_solver
        scs_solver.solve(cs, witness_values, check=check, native=False)
        raise RuntimeError(
            f"native SCS solver failed (rc={rc}) but scalar succeeded")

    L16 = F.L
    return (_to_planes(values, L16), _to_planes(lv, L16),
            _to_planes(rv, L16), _to_planes(ov, L16))
