"""Solidity Groth16 verifier export for BN254.

Counterpart of gnark_tpu/backend/solidity.py (the same text).
Reference: internal/backend/bn254/groth16/solidity.go (ExportSolidity
hook at verify.go:97-111) — emits a contract using the EVM precompiles
ecAdd (0x06), ecMul (0x07), ecPairing (0x08), which exist only for
alt_bn128, hence BN254-only.
"""

from __future__ import annotations

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Generated by gnark_tpu - Groth16 verifier for BN254 (alt_bn128 precompiles).
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 constant q = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant r = 21888242871839275222246405745257275088548364400416034343698204186575808495617;

    uint256 constant ALPHA_X = {alpha_x};
    uint256 constant ALPHA_Y = {alpha_y};
    uint256 constant BETA_X0 = {beta_x0};
    uint256 constant BETA_X1 = {beta_x1};
    uint256 constant BETA_Y0 = {beta_y0};
    uint256 constant BETA_Y1 = {beta_y1};
    uint256 constant GAMMA_X0 = {gamma_x0};
    uint256 constant GAMMA_X1 = {gamma_x1};
    uint256 constant GAMMA_Y0 = {gamma_y0};
    uint256 constant GAMMA_Y1 = {gamma_y1};
    uint256 constant DELTA_X0 = {delta_x0};
    uint256 constant DELTA_X1 = {delta_x1};
    uint256 constant DELTA_Y0 = {delta_y0};
    uint256 constant DELTA_Y1 = {delta_y1};

    function verifyProof(
        uint256[2] calldata a,
        uint256[2][2] calldata b,
        uint256[2] calldata c,
        uint256[{n_inputs}] calldata input
    ) external view returns (bool) {{
        uint256[2] memory k = [uint256({k0_x}), uint256({k0_y})];
{ksum_code}
        uint256[24] memory pairs;
        // -A, B
        pairs[0] = a[0];
        pairs[1] = a[1] % q == 0 ? 0 : q - (a[1] % q);
        pairs[2] = b[0][0];
        pairs[3] = b[0][1];
        pairs[4] = b[1][0];
        pairs[5] = b[1][1];
        // alpha, beta
        pairs[6] = ALPHA_X;
        pairs[7] = ALPHA_Y;
        pairs[8] = BETA_X0;
        pairs[9] = BETA_X1;
        pairs[10] = BETA_Y0;
        pairs[11] = BETA_Y1;
        // kSum, gamma
        pairs[12] = k[0];
        pairs[13] = k[1];
        pairs[14] = GAMMA_X0;
        pairs[15] = GAMMA_X1;
        pairs[16] = GAMMA_Y0;
        pairs[17] = GAMMA_Y1;
        // C, delta
        pairs[18] = c[0];
        pairs[19] = c[1];
        pairs[20] = DELTA_X0;
        pairs[21] = DELTA_X1;
        pairs[22] = DELTA_Y0;
        pairs[23] = DELTA_Y1;

        uint256[1] memory out;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 8, pairs, 768, out, 32)
        }}
        require(ok, "pairing precompile failed");
        return out[0] == 1;
    }}

    function _ecMulAdd(uint256[2] memory acc, uint256 px, uint256 py,
                       uint256 s) internal view returns (uint256[2] memory) {{
        uint256[3] memory mulIn = [px, py, s];
        uint256[2] memory mulOut;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 7, mulIn, 96, mulOut, 64)
        }}
        require(ok, "ecMul failed");
        uint256[4] memory addIn = [acc[0], acc[1], mulOut[0], mulOut[1]];
        uint256[2] memory addOut;
        assembly {{
            ok := staticcall(gas(), 6, addIn, 128, addOut, 64)
        }}
        require(ok, "ecAdd failed");
        return addOut;
    }}
}}
"""


def export_solidity(vk) -> str:
    """-> Solidity source of a verifier contract for this BN254 VK."""
    assert vk.curve.name == "bn254", "Solidity export is BN254-only"

    def g1(P):
        return (0, 0) if P is None else P

    def g2(P):
        # EVM ecPairing expects x = (x_imag, x_real) i.e. c1 first
        if P is None:
            return (0, 0, 0, 0)
        (x0, x1), (y0, y1) = P
        return (x1, x0, y1, y0)

    k0 = g1(vk.K[0])
    lines = []
    for i, point in enumerate(vk.K[1:]):
        px, py = g1(point)
        lines.append(
            f"        k = _ecMulAdd(k, uint256({px}), uint256({py}), "
            f"input[{i}] % r);")
    beta = g2(vk.beta_g2)
    gamma = g2(vk.gamma_g2)
    delta = g2(vk.delta_g2)
    alpha = g1(vk.alpha_g1)
    return _TEMPLATE.format(
        alpha_x=alpha[0], alpha_y=alpha[1],
        beta_x0=beta[0], beta_x1=beta[1], beta_y0=beta[2], beta_y1=beta[3],
        gamma_x0=gamma[0], gamma_x1=gamma[1],
        gamma_y0=gamma[2], gamma_y1=gamma[3],
        delta_x0=delta[0], delta_x1=delta[1],
        delta_y0=delta[2], delta_y1=delta[3],
        n_inputs=max(len(vk.K) - 1, 1),
        k0_x=k0[0], k0_y=k0[1],
        ksum_code="\n".join(lines) if lines else "        // no inputs",
    )
