"""Backend API layer: scheme dispatch + prover options.

The L3 analog (reference backend/backend.go:27 GROTH16/PLONK ids;
backend/groth16/groth16.go:159 and backend/plonk/plonk.go:115 type-switch
dispatchers).  Here dispatch is by the compiled system's type.  Keyword
options pass through to the scheme's own function: ``setup`` puts the
keys on ``device``, the card unless the caller names another.
"""

from __future__ import annotations

GROTH16 = "groth16"
PLONK = "plonk"


def _scheme_of(cs) -> str:
    from gnark_tpu_torch.frontend import ir
    return GROTH16 if isinstance(cs, ir.R1CS) else PLONK


def setup(cs, curve, **kw):
    """Scheme-dispatching Setup (groth16.Setup / plonk.Setup analog)."""
    if _scheme_of(cs) == GROTH16:
        from gnark_tpu_torch.backend import groth16
        return groth16.setup(cs, curve, **kw)
    from gnark_tpu_torch.backend import plonk
    return plonk.setup(cs, curve, **kw)


def prove(cs, pk, witness_values, **kw):
    if _scheme_of(cs) == GROTH16:
        from gnark_tpu_torch.backend import groth16
        return groth16.prove(cs, pk, witness_values, **kw)
    from gnark_tpu_torch.backend import plonk
    return plonk.prove(cs, pk, witness_values, **kw)


def verify(proof, vk, public_values):
    from gnark_tpu_torch.backend import groth16 as g16
    from gnark_tpu_torch.backend import plonk as plk
    if isinstance(proof, g16.Proof):
        return g16.verify(proof, vk, public_values)
    return plk.verify(proof, vk, public_values)


def solve(cs, witness_values, **kw):
    """Scheme-dispatching witness solver."""
    if _scheme_of(cs) == GROTH16:
        from gnark_tpu_torch.backend import solver
        return solver.solve(cs, witness_values, **kw)
    from gnark_tpu_torch.backend import scs_solver
    return scs_solver.solve(cs, witness_values, **kw)
