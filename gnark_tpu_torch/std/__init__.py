"""Gadget standard library (the reference's std/, SURVEY §2.7).

Gadgets are written against the frontend API so every gadget works with
both the R1CS (Groth16) and SCS (PLONK) builders.  Of gnark_tpu's gadgets
this package has MiMC so far.
"""

from gnark_tpu_torch.backend import hints as _hints


def register_hints():
    """Re-register the hints of the gadgets this package has (std/hints.go:18
    analog) — needed by servers that solve deserialized constraint systems.
    MiMC uses no hint, so these are the registry's built-in ones."""
    return _hints.all_registered()
