"""The MSM kernels' kinds, for the port's tests: BN254's G1 (``g1``) and
G2 over fp2 (``g2``), BLS24-315's G1 (``g1_bls24315``) and G2 over fp4
(``g2_bls24315``)."""

from gnark_tpu_torch.backend.groth16 import _Groups
from gnark_tpu_torch.curves import BLS24_315, BN254
from gnark_tpu_torch.ops import _cuda

KINDS = list(_cuda.KINDS)


def curve_of(kind):
    return BLS24_315 if kind.endswith("_bls24315") else BN254


def group(kind):
    """(curve ops, host curve, generator, the coordinate field's zero)."""
    curve = curve_of(kind)
    K = _Groups(curve)
    if kind.startswith("g1"):
        return K.g1, curve.host_g1, curve.g1_gen, 0
    return K.g2, curve.host_g2, curve.g2_gen, K.g2_zero


def r_mod(kind):
    """The scalar field's modulus (both curves' fr have 16 limbs)."""
    return curve_of(kind).fr.modulus
