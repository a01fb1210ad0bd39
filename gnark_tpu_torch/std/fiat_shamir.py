"""In-circuit Fiat-Shamir transcript over a circuit hash gadget.

Reference: std/fiat-shamir/transcript.go:34-137 (Transcript, NewTranscript,
Bind, ComputeChallenge over a generic hash.Hash) — the building block for
in-circuit recursive verification.
"""

from __future__ import annotations


class CircuitTranscript:
    def __init__(self, api, hasher, *challenge_names: str):
        """hasher: a circuit hash gadget with write()/sum()/reset()
        (e.g. std.mimc.MiMC)."""
        self.api = api
        self.h = hasher
        self._names = list(challenge_names)
        self._order = {n: i for i, n in enumerate(challenge_names)}
        self._bindings = {n: [] for n in challenge_names}
        self._values = {}

    def bind(self, name: str, *values):
        if name in self._values:
            raise ValueError(f"challenge {name} already computed")
        self._bindings[name].extend(values)

    def compute_challenge(self, name: str):
        if name in self._values:
            return self._values[name]
        idx = self._order[name]
        self.h.reset()
        if idx > 0:
            prev = self._names[idx - 1]
            if prev not in self._values:
                raise ValueError(f"compute {prev} before {name}")
            self.h.write(self._values[prev])
        for v in self._bindings[name]:
            self.h.write(v)
        val = self.h.sum()
        self._values[name] = val
        return val
