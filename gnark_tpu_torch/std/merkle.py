"""MiMC Merkle tree: host tree/proof generation + in-circuit verifier.

Reference: std/accumulator/merkle/verify.go (VerifyProof :135, proof
helper bits :78) — a port of Sia's Merkle semantics: domain separation
prefixes leafSum (0x00) / nodeSum (0x01) are NOT used in the gnark MiMC
variant (it hashes field elements directly), so leaf = H(data),
node = H(left, right).
"""

from __future__ import annotations

from gnark_tpu_torch.std.mimc import MiMC, mimc_hash


# ---- host ------------------------------------------------------------------------


def build_tree(curve, leaves: list, hash_leaves: bool = True) -> list:
    """-> list of levels, level[0] = (hashed) leaves, level[-1] = [root].
    hash_leaves=False treats `leaves` as already-hashed digests."""
    assert leaves and (len(leaves) & (len(leaves) - 1)) == 0, \
        "leaf count must be a power of two"
    level = [mimc_hash(curve, v) for v in leaves] if hash_leaves \
        else list(leaves)
    levels = [level]
    while len(level) > 1:
        level = [mimc_hash(curve, level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
        levels.append(level)
    return levels


def root(curve, leaves: list) -> int:
    return build_tree(curve, leaves)[-1][0]


def prove(curve, leaves: list, index: int):
    """-> (proof_set, helper_bits): proof_set[0] is the raw leaf value,
    proof_set[1:] are sibling digests bottom-up; helper[i] == 1 means the
    running hash is the LEFT input at that level (merkle/verify.go:78)."""
    levels = build_tree(curve, leaves)
    proof = [leaves[index]]
    helper = []
    idx = index
    for level in levels[:-1]:
        sib = idx ^ 1
        proof.append(level[sib])
        helper.append(1 if idx % 2 == 0 else 0)
        idx //= 2
    return proof, helper


# ---- circuit ----------------------------------------------------------------------


def verify_proof(api, merkle_root, proof_set, helper):
    """In-circuit proof check (VerifyProof verify.go:135-149)."""
    h = MiMC(api)
    h.write(proof_set[0])
    acc = h.sum()
    for i in range(1, len(proof_set)):
        api.assert_is_boolean(helper[i - 1])
        d1 = api.select(helper[i - 1], acc, proof_set[i])
        d2 = api.select(helper[i - 1], proof_set[i], acc)
        h.reset()
        h.write(d1, d2)
        acc = h.sum()
    api.assert_is_equal(acc, merkle_root)
