"""Fiat-Shamir transcript (host, SHA-256).

Reference: gnark-crypto fiatshamir.Transcript as used by PLONK
(internal/backend/bn254/plonk/prove.go:69-72 NewTranscript(sha256,
"gamma","beta","alpha","zeta"); bind/derive at verify.go:249-307).
Challenges must be derived in registration order; each challenge hashes
the previous challenge value followed by its bound data.
"""

from __future__ import annotations

import hashlib


class Transcript:
    def __init__(self, *challenge_names: str, hash_name: str = "sha256"):
        self._names = list(challenge_names)
        self._order = {n: i for i, n in enumerate(challenge_names)}
        self._bindings = {n: [] for n in challenge_names}
        self._values = {}
        self._hash_name = hash_name

    def bind(self, name: str, data: bytes):
        if name in self._values:
            raise ValueError(f"challenge {name} already computed")
        self._bindings[name].append(bytes(data))

    def compute_challenge(self, name: str) -> bytes:
        if name in self._values:
            return self._values[name]
        idx = self._order[name]
        h = hashlib.new(self._hash_name)
        h.update(name.encode())
        if idx > 0:
            prev = self._names[idx - 1]
            if prev not in self._values:
                raise ValueError(
                    f"challenge {prev} must be computed before {name}")
            h.update(self._values[prev])
        for b in self._bindings[name]:
            h.update(b)
        v = h.digest()
        self._values[name] = v
        return v

    def challenge_int(self, name: str, modulus: int) -> int:
        return int.from_bytes(self.compute_challenge(name), "big") % modulus
