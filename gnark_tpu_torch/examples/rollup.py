"""Toy rollup: batched transfers proven correct against Merkle state roots.

Reference: examples/rollup/{circuit.go:35-186, account.go, transfer.go,
operator.go} — per transfer the circuit checks 4 Merkle inclusion proofs
(sender/receiver x before/after), the sender's EdDSA signature over the
transfer hash, nonce increment, balance bounds and balance updates.

Host side: `Operator` maintains the account tree and builds witnesses.
"""

from __future__ import annotations

import dataclasses

from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret
from gnark_tpu_torch.std import eddsa, merkle
from gnark_tpu_torch.std.mimc import MiMC, MiMCHost

DEPTH = 4          # 2^4 = 16 accounts; inclusion proofs have DEPTH+1 = 5
                   # entries — matching the reference (circuit.go:29-31:
                   # nbAccounts = 16, depth = 5, batchSize = 1)
BATCH_SIZE = 1     # transfers per proof (reference batchSize = 1)


@dataclasses.dataclass
class Account:
    index: int
    nonce: int
    balance: int
    pub: tuple     # eddsa public key point (x, y)

    def leaf(self, curve) -> int:
        h = MiMCHost(curve)
        h.write(self.index, self.nonce, self.balance, self.pub[0], self.pub[1])
        return h.sum()


def transfer_hash_host(curve, nonce, amount, sender_pub, receiver_pub) -> int:
    h = MiMCHost(curve)
    h.write(nonce, amount, sender_pub[0], sender_pub[1],
            receiver_pub[0], receiver_pub[1])
    return h.sum()


class Operator:
    """Host state machine (examples/rollup/operator.go analog)."""

    def __init__(self, curve, keypairs):
        assert len(keypairs) == 1 << DEPTH
        self.curve = curve
        self.keys = keypairs
        self.accounts = [
            Account(index=i, nonce=0, balance=1000, pub=kp.public)
            for i, kp in enumerate(keypairs)]

    def leaves(self):
        return [a.leaf(self.curve) for a in self.accounts]

    def root(self) -> int:
        return merkle.build_tree(self.curve, self.leaves(),
                                 hash_leaves=False)[-1][0]

    def _raw_proof(self, index):
        """Merkle path over already-hashed leaves: drop the leaf-rehash
        level by proving over digests directly."""
        leaves = self.leaves()
        levels = merkle.build_tree(self.curve, leaves, hash_leaves=False)
        # proof over digest values: path starts at the account digest
        proof = [leaves[index]]
        helper = []
        idx = index
        for level in levels[:-1]:
            proof.append(level[idx ^ 1])
            helper.append(1 if idx % 2 == 0 else 0)
            idx //= 2
        return proof, helper

    def transfer(self, sender_idx: int, receiver_idx: int, amount: int):
        """Apply one transfer; returns the witness dict for RollupCircuit."""
        snd = self.accounts[sender_idx]
        rcv = self.accounts[receiver_idx]
        assert snd.balance >= amount

        root_before = self.root()
        snd_proof_b, snd_help_b = self._raw_proof(sender_idx)
        rcv_proof_b, rcv_help_b = self._raw_proof(receiver_idx)

        msg = transfer_hash_host(self.curve, snd.nonce, amount, snd.pub,
                                 rcv.pub)
        sig = self.keys[sender_idx].sign(msg, self.curve)

        before = (dataclasses.replace(snd), dataclasses.replace(rcv))
        snd.nonce += 1
        snd.balance -= amount
        rcv.balance += amount

        root_after = self.root()
        snd_proof_a, snd_help_a = self._raw_proof(sender_idx)
        rcv_proof_a, rcv_help_a = self._raw_proof(receiver_idx)

        w = RollupCircuit()
        w.root_before, w.root_after = root_before, root_after
        w.sender_nonce_before = before[0].nonce
        w.sender_balance_before = before[0].balance
        w.receiver_nonce_before = before[1].nonce
        w.receiver_balance_before = before[1].balance
        w.sender_nonce_after = snd.nonce
        w.sender_balance_after = snd.balance
        w.receiver_nonce_after = rcv.nonce
        w.receiver_balance_after = rcv.balance
        w.sender_index, w.receiver_index = sender_idx, receiver_idx
        w.sender_pub_x, w.sender_pub_y = snd.pub
        w.receiver_pub_x, w.receiver_pub_y = rcv.pub
        w.amount = amount
        w.sig_rx, w.sig_ry, w.sig_s = sig.r[0], sig.r[1], sig.s
        w.snd_proof_b, w.snd_help_b = snd_proof_b, snd_help_b
        w.rcv_proof_b, w.rcv_help_b = rcv_proof_b, rcv_help_b
        w.snd_proof_a, w.snd_help_a = snd_proof_a, snd_help_a
        w.rcv_proof_a, w.rcv_help_a = rcv_proof_a, rcv_help_a
        return w


class RollupCircuit(Circuit):
    # public state commitments
    root_before = Public()
    root_after = Public()

    # account fields (secret)
    sender_index = Secret()
    sender_nonce_before = Secret()
    sender_balance_before = Secret()
    sender_nonce_after = Secret()
    sender_balance_after = Secret()
    receiver_index = Secret()
    receiver_nonce_before = Secret()
    receiver_balance_before = Secret()
    receiver_nonce_after = Secret()
    receiver_balance_after = Secret()
    sender_pub_x = Secret()
    sender_pub_y = Secret()
    receiver_pub_x = Secret()
    receiver_pub_y = Secret()

    # transfer
    amount = Secret()
    sig_rx = Secret()
    sig_ry = Secret()
    sig_s = Secret()

    # merkle paths (proof[0] is the account digest; helpers are DEPTH bits)
    snd_proof_b = Secret(shape=(DEPTH + 1,))
    snd_help_b = Secret(shape=(DEPTH,))
    rcv_proof_b = Secret(shape=(DEPTH + 1,))
    rcv_help_b = Secret(shape=(DEPTH,))
    snd_proof_a = Secret(shape=(DEPTH + 1,))
    snd_help_a = Secret(shape=(DEPTH,))
    rcv_proof_a = Secret(shape=(DEPTH + 1,))
    rcv_help_a = Secret(shape=(DEPTH,))

    def define(self, api):
        def account_digest(index, nonce, balance, px, py):
            h = MiMC(api)
            h.write(index, nonce, balance, px, py)
            return h.sum()

        def verify_path(root, digest, proof, helper):
            # proof[0] must BE the account digest, then standard path
            api.assert_is_equal(proof[0], digest)
            acc = proof[0]
            for i in range(1, len(proof)):
                api.assert_is_boolean(helper[i - 1])
                d1 = api.select(helper[i - 1], acc, proof[i])
                d2 = api.select(helper[i - 1], proof[i], acc)
                h = MiMC(api)
                h.write(d1, d2)
                acc = h.sum()
            api.assert_is_equal(acc, root)

        snd_b = account_digest(self.sender_index, self.sender_nonce_before,
                               self.sender_balance_before,
                               self.sender_pub_x, self.sender_pub_y)
        rcv_b = account_digest(self.receiver_index,
                               self.receiver_nonce_before,
                               self.receiver_balance_before,
                               self.receiver_pub_x, self.receiver_pub_y)
        snd_a = account_digest(self.sender_index, self.sender_nonce_after,
                               self.sender_balance_after,
                               self.sender_pub_x, self.sender_pub_y)
        rcv_a = account_digest(self.receiver_index,
                               self.receiver_nonce_after,
                               self.receiver_balance_after,
                               self.receiver_pub_x, self.receiver_pub_y)

        # 4 inclusion proofs (circuit.go:130-136)
        verify_path(self.root_before, snd_b, self.snd_proof_b, self.snd_help_b)
        verify_path(self.root_before, rcv_b, self.rcv_proof_b, self.rcv_help_b)
        verify_path(self.root_after, snd_a, self.snd_proof_a, self.snd_help_a)
        verify_path(self.root_after, rcv_a, self.rcv_proof_a, self.rcv_help_a)

        # signature over H(nonce, amount, senderPub, receiverPub)
        h = MiMC(api)
        h.write(self.sender_nonce_before, self.amount,
                self.sender_pub_x, self.sender_pub_y,
                self.receiver_pub_x, self.receiver_pub_y)
        msg = h.sum()
        eddsa.verify(api, (self.sig_rx, self.sig_ry), self.sig_s, msg,
                     (self.sender_pub_x, self.sender_pub_y))

        # account updates (circuit.go:171-186)
        api.assert_is_equal(api.add(self.sender_nonce_before, 1),
                            self.sender_nonce_after)
        api.assert_is_less_or_equal(self.amount, self.sender_balance_before)
        api.assert_is_equal(api.sub(self.sender_balance_before, self.amount),
                            self.sender_balance_after)
        api.assert_is_equal(api.add(self.receiver_balance_before, self.amount),
                            self.receiver_balance_after)


def seeded_operator(curve) -> Operator:
    """An operator over 2^DEPTH accounts whose EdDSA keys come from the
    seeds bytes([i]) * 8, as the reference's rollup test makes them."""
    return Operator(curve, [eddsa.KeyPair.generate(curve, bytes([i]) * 8)
                            for i in range(1 << DEPTH)])


def main(device="cuda"):
    """One transfer proved under Groth16 and under PLONK/KZG with the keys
    on ``device``; each proof verifies and a wrong root_after is
    rejected.  In a fresh checkout the first setup and prove include the
    native core's and the kernels' builds."""
    import random
    import time

    from gnark_tpu_torch import backend
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.frontend import schema
    from gnark_tpu_torch.frontend.compile import compile_circuit

    w = seeded_operator(BN254).transfer(0, 1, 100)
    pub = schema.collect_values(w, "public")
    values = schema.collect_values(w)
    for scheme in (backend.GROTH16, backend.PLONK):
        t0 = time.perf_counter()
        cs = compile_circuit(RollupCircuit(), BN254, scheme=scheme)
        t1 = time.perf_counter()
        pk, vk = backend.setup(cs, BN254, rng=random.Random(0), device=device)
        t2 = time.perf_counter()
        proof = backend.prove(cs, pk, values, rng=random.Random(1))
        t3 = time.perf_counter()
        assert backend.verify(proof, vk, pub)
        assert not backend.verify(proof, vk, [pub[0], pub[1] + 1])
        print(f"rollup {scheme}: {cs.nb_constraints} constraints, compile "
              f"{t1 - t0:.2f} s, setup {t2 - t1:.2f} s, prove {t3 - t2:.2f} "
              f"s; verified, a wrong root_after rejected")


if __name__ == "__main__":
    main()
