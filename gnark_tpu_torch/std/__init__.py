"""Gadget standard library (the reference's std/, SURVEY §2.7).

Gadgets are written against the frontend API so every gadget works with
both the R1CS (Groth16) and SCS (PLONK) builders, and with the big-int
test engine.  This package has gnark_tpu's gadgets: MiMC, bits, twisted
Edwards, EdDSA, Merkle, the Fiat-Shamir transcript, and the recursion
gadgets of ``std/algebra`` with the in-circuit Groth16 verifiers of
BLS12-377 and BLS24-315 proofs (``groth16_bls12377``,
``groth16_bls24315``).
"""

from gnark_tpu_torch.backend import hints as _hints


def register_hints():
    """Re-register all stdlib hints (std/hints.go:18 analog) — needed by
    servers that solve deserialized constraint systems.  The same hints,
    under the same names and uuids, as gnark_tpu's ``register_hints``."""
    # importing the modules registers their hints
    from gnark_tpu_torch.std import bits  # noqa: F401
    from gnark_tpu_torch.std.algebra import sw_bls12377 as _sw
    from gnark_tpu_torch.std.algebra import sw_bls24315 as _sw24
    _hints.register(_sw.decompose_scalar_bls12377)   # std/hints.go:25 analog
    _hints.register(_sw24.decompose_scalar_bls24315)
    from gnark_tpu_torch.std import twisted_edwards as _te
    _hints.register(_te.decompose_scalar_bandersnatch)
    return _hints.all_registered()
