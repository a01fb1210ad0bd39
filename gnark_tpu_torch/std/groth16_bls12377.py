"""In-circuit Groth16 verifier: verify a BLS12-377 proof inside a
circuit over BW6-761's scalar field (one-layer recursion; counterpart of
gnark_tpu/std/groth16_bls12377.py).

Reference: std/groth16_bls12377/verifier.go:33-106 — the verifier
equation e(Ar, Bs) = e(alpha, beta) * e(ksum, gamma) * e(Krs, delta)
evaluated with the sw_bls12377 pairing gadget; VK points are circuit
constants, proof points and public inputs are witness variables.
"""

from __future__ import annotations

from gnark_tpu_torch.curves.pairing import pairing_for
from gnark_tpu_torch.std.algebra.sw_bls12377 import G1Gadget, PairingGadget


def _gt_to_tower(x):
    """Host Fp12 (w-basis, 6 fp2 coeffs) -> gadget tower constants."""
    c = list(x)
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))


def verify_proof(api, vk, ar, bs, krs, public_inputs):
    """Assert the BLS12-377 Groth16 proof verifies.

    vk: a backend.groth16.VerifyingKey over curves.BLS12_377 (host
    points; embedded as circuit constants).
    ar, krs: (x, y) variable pairs (G1); bs: ((x0,x1), (y0,y1)) E2
    variable pairs (G2); public_inputs: list of variables.
    """
    assert vk.curve.name == "bls12_377", \
        "recursion gadget expects an inner BLS12-377 VK"
    if len(public_inputs) != vk.nb_public - 1:
        raise ValueError(f"want {vk.nb_public - 1} public inputs")

    g1 = G1Gadget(api)
    pr = PairingGadget(api)

    # ksum = K[0] + sum inputs[i] * K[i+1]  (constant points)
    ksum = vk.K[0]
    if public_inputs:
        msm = g1.msm_with_constants(vk.K[1:], public_inputs)
        ksum = g1.add(msm, ksum)

    def g2_const(P):
        return (P[0], P[1])

    neg_ar = g1.neg(ar)
    f = pr.miller_loop([
        (neg_ar, bs),
        (ksum, g2_const(vk.gamma_g2)),
        (krs, g2_const(vk.delta_g2)),
    ])
    result = pr.final_exp(f)

    # must equal e(alpha, beta)^-1 = conj(e(alpha, beta)) — a constant
    host_pairing = pairing_for(vk.curve)
    expected = _gt_to_tower(host_pairing.fp12.conj(vk.e_alpha_beta))
    pr.e12.assert_is_equal(result, expected)
