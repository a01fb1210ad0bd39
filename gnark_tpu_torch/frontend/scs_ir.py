"""Sparse constraint system (PLONK gate) IR.

Gate semantics (reference frontend/compiled/r1cs_sparse.go:36, solver
internal/backend/bn254/cs/r1cs_sparse.go:305):

    qL*l + qR*r + qM*(l*r) + qO*o + qC = 0

Redesigned for array processing: gates freeze into column arrays (wire
ids int32[m] x 3, coefficient ids int32[m] x 5) that the PLONK setup
reads directly as the selector polynomials' Lagrange values and the
copy-constraint permutation input.  Wire id -1 = unused slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np



@dataclasses.dataclass
class SCS:
    """Compiled PLONK constraint system."""

    curve_name: str
    field_modulus: int
    nb_public: int           # no constant-one wire in the PLONK layout
    nb_secret: int
    nb_internal: int
    public_names: list
    secret_names: list
    coeffs: list             # ints, index = coeff id
    # per-gate columns, length m
    wires_l: np.ndarray      # int32[m], -1 = unused
    wires_r: np.ndarray
    wires_o: np.ndarray
    q_l: np.ndarray          # int32[m] coeff ids
    q_r: np.ndarray
    q_m: np.ndarray
    q_o: np.ndarray
    q_c: np.ndarray
    hints: list
    wire_to_hint: dict
    logs: list
    debug_info: dict
    counters: list = dataclasses.field(default_factory=list)
    # dependency levelization (buildLevels analog, reference
    # frontend/cs/scs/builder.go:356): levels[i] = gate indices whose
    # unknown slots depend only on wires solved in levels < i — the
    # schedule a vectorized/parallel PLONK solve consumes
    levels: list = dataclasses.field(default_factory=list)

    @property
    def nb_constraints(self) -> int:
        return len(self.q_l)

    @property
    def nb_wires(self) -> int:
        return self.nb_public + self.nb_secret + self.nb_internal
