"""In-circuit Groth16 verifier: verify a BLS24-315 proof inside a
circuit over BW6-633's scalar field (one-layer recursion; counterpart of
gnark_tpu/std/groth16_bls24315.py).

Reference: std/groth16_bls24315/verifier.go — the verifier equation
e(Ar, Bs) = e(alpha, beta) * e(ksum, gamma) * e(Krs, delta) evaluated
with the sw_bls24315 pairing gadget; VK points are circuit constants,
proof points and public inputs are witness variables.
"""

from __future__ import annotations

from gnark_tpu_torch.curves.pairing import pairing_for
from gnark_tpu_torch.std.algebra.fields_bls24315 import flat_to_tower
from gnark_tpu_torch.std.algebra.sw_bls24315 import G1Gadget, PairingGadget


def _gt_to_tower(x):
    """Host Fp24 (flat zeta-power basis, 24 fp coeffs) -> gadget tower."""
    return flat_to_tower(list(x))


def verify_proof(api, vk, ar, bs, krs, public_inputs):
    """Assert the BLS24-315 Groth16 proof verifies.

    vk: a backend.groth16.VerifyingKey over curves.BLS24_315 (host
    points; embedded as circuit constants).
    ar, krs: (x, y) variable pairs (G1); bs: ((x0..x3), (y0..y3)) E4
    variable pairs (G2, quartic v-basis); public_inputs: variables.
    """
    assert vk.curve.name == "bls24_315", \
        "recursion gadget expects an inner BLS24-315 VK"
    if len(public_inputs) != vk.nb_public - 1:
        raise ValueError(f"want {vk.nb_public - 1} public inputs")

    g1 = G1Gadget(api)
    pr = PairingGadget(api)

    # ksum = K[0] + sum inputs[i] * K[i+1]  (constant points)
    ksum = vk.K[0]
    if public_inputs:
        msm = g1.msm_with_constants(vk.K[1:], public_inputs)
        ksum = g1.add(msm, ksum)

    neg_ar = g1.neg(ar)
    f = pr.miller_loop([
        (neg_ar, bs),
        (ksum, vk.gamma_g2),
        (krs, vk.delta_g2),
    ])
    result = pr.final_exp(f)

    # must equal e(alpha, beta)^-1 = conj(e(alpha, beta)) — a constant
    host_pairing = pairing_for(vk.curve)
    expected = _gt_to_tower(host_pairing.gt.conj(vk.e_alpha_beta))
    pr.e24.assert_is_equal(result, expected)
