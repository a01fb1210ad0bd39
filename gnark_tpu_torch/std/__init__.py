"""Gadget standard library (the reference's std/, SURVEY §2.7).

Gadgets are written against the frontend API so every gadget works with
both the R1CS (Groth16) and SCS (PLONK) builders, and with the big-int
test engine.  Of gnark_tpu's gadgets this package has the BN254 ones:
MiMC, bits, twisted Edwards, EdDSA, Merkle and the Fiat-Shamir
transcript; the recursion gadgets of ``std/algebra`` are not ported yet.
"""

from gnark_tpu_torch.backend import hints as _hints


def register_hints():
    """Re-register the hints of the gadgets this package has (std/hints.go:18
    analog) — needed by servers that solve deserialized constraint systems.
    gnark_tpu also registers its BLS12-377 and BLS24-315 scalar
    decompositions, whose modules (``std/algebra``) this package lacks."""
    # importing the modules registers their hints
    from gnark_tpu_torch.std import bits  # noqa: F401
    from gnark_tpu_torch.std import twisted_edwards as _te
    _hints.register(_te.decompose_scalar_bandersnatch)
    return _hints.all_registered()
