"""Constraint-system IR: coefficient table, linear combinations, R1CS.

Python-side equivalents of the reference's compiled IR
(frontend/compiled/{term.go:28, linear_expression.go:23, r1cs.go:23,
cs.go:16}) redesigned for array processing: at compile() time the
constraint lists are frozen into CSR-style numpy arrays (indptr / wire /
coeff columns per matrix) that device kernels and the Groth16/PLONK
setups consume directly — no per-constraint object graph survives.

A linear combination (LC) is a tuple of (wire_id, coeff_id) pairs sorted
by wire id.  Wire 0 is the constant-one public wire; a constant c is the
LC ((0, coeff_id(c)),).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# reserved coefficient ids (mirrors the reserved ids idea of
# frontend/compiled/term.go:31-36; exact numbering is ours)
COEFF_ZERO = 0
COEFF_ONE = 1
COEFF_TWO = 2
COEFF_MINUS_ONE = 3


class CoeffTable:
    """Deduplicating table of big-int coefficients (mod p)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.values: list[int] = [0, 1, 2, modulus - 1]
        self._index: dict[int, int] = {v: i for i, v in enumerate(self.values)}

    def cid(self, value: int) -> int:
        v = value % self.modulus
        i = self._index.get(v)
        if i is None:
            i = len(self.values)
            self.values.append(v)
            self._index[v] = i
        return i

    def __getitem__(self, cid: int) -> int:
        return self.values[cid]


# ---- linear combinations ---------------------------------------------------

LC = tuple  # tuple[(wire_id, coeff_id), ...]


def lc_const(table: CoeffTable, c: int) -> LC:
    c = c % table.modulus
    if c == 0:
        return ()
    return ((0, table.cid(c)),)


def lc_single(wire: int, cid: int = COEFF_ONE) -> LC:
    return ((wire, cid),)


def lc_combine(table: CoeffTable, parts) -> LC:
    """Sum of scaled LCs: parts = [(lc, scale_int), ...] -> canonical LC."""
    acc: dict[int, int] = {}
    p = table.modulus
    for lc, scale in parts:
        if scale % p == 0:
            continue
        for wire, cid in lc:
            acc[wire] = (acc.get(wire, 0) + table[cid] * scale) % p
    return tuple(sorted((w, table.cid(v)) for w, v in acc.items() if v))


def lc_is_const(lc: LC) -> bool:
    return len(lc) == 0 or (len(lc) == 1 and lc[0][0] == 0)


def lc_const_value(table: CoeffTable, lc: LC) -> Optional[int]:
    if len(lc) == 0:
        return 0
    if len(lc) == 1 and lc[0][0] == 0:
        return table[lc[0][1]]
    return None


def lc_eval(table: CoeffTable, lc: LC, values) -> int:
    p = table.modulus
    return sum(table[cid] * values[w] for w, cid in lc) % p


# ---- hints, logs, debug ------------------------------------------------------


@dataclasses.dataclass
class Hint:
    """A solver callback: out_wires = fn(inputs) at witness-solve time
    (reference: frontend/compiled/hint.go:15, backend/hint/hint.go:86)."""
    uuid: int
    inputs: list  # list of LC
    out_wires: list


@dataclasses.dataclass
class LogEntry:
    """api.Println record, resolved at solve time (compiled/log.go:26)."""
    parts: list          # str | LC interleaved
    is_debug: bool = False
    constraint_id: int = -1


# ---- compiled system ---------------------------------------------------------


@dataclasses.dataclass
class SparseMatrix:
    """CSR of one R1CS matrix: row i holds the terms of constraint i."""
    indptr: np.ndarray   # int64[m+1]
    wires: np.ndarray    # int32[nnz]
    coeffs: np.ndarray   # int32[nnz] -> coeff table ids

    def row(self, i: int):
        s, e = self.indptr[i], self.indptr[i + 1]
        return tuple(zip(self.wires[s:e].tolist(), self.coeffs[s:e].tolist()))


@dataclasses.dataclass
class R1CS:
    """Compiled rank-1 constraint system (frontend.CompiledConstraintSystem
    analog, frontend/ccs.go:29; typed engine analog of
    internal/backend/<curve>/cs/r1cs.go:46)."""

    curve_name: str
    field_modulus: int
    nb_public: int          # includes the constant-one wire at index 0
    nb_secret: int
    nb_internal: int
    public_names: list
    secret_names: list
    coeffs: list            # python ints, index = coeff id
    L: SparseMatrix
    R: SparseMatrix
    O: SparseMatrix
    hints: list             # list[Hint]
    wire_to_hint: dict      # wire id -> index into hints
    levels: list            # list[list[constraint id]] parallel schedule
    logs: list              # list[LogEntry]
    debug_info: dict        # constraint id -> str
    counters: list = dataclasses.field(default_factory=list)

    @property
    def nb_constraints(self) -> int:
        return len(self.L.indptr) - 1

    @property
    def nb_wires(self) -> int:
        return self.nb_public + self.nb_secret + self.nb_internal

    def get_nb_variables(self):
        return self.nb_internal, self.nb_secret, self.nb_public

    def constraint_terms(self, i: int):
        return self.L.row(i), self.R.row(i), self.O.row(i)


def pack_matrix(rows: list) -> SparseMatrix:
    """list of LCs -> CSR arrays."""
    indptr = np.zeros(len(rows) + 1, np.int64)
    for i, lc in enumerate(rows):
        indptr[i + 1] = indptr[i] + len(lc)
    nnz = int(indptr[-1])
    wires = np.empty(nnz, np.int32)
    coeffs = np.empty(nnz, np.int32)
    k = 0
    for lc in rows:
        for w, cid in lc:
            wires[k] = w
            coeffs[k] = cid
            k += 1
    return SparseMatrix(indptr, wires, coeffs)
