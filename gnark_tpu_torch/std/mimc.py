"""MiMC hash: host implementation + in-circuit gadget.

Reference semantics (std/hash/mimc/{mimc.go:29-80, encrypt.go:36-137}):
Miyaguchi-Preneel over the MiMC block cipher; per curve the round
function is x <- (x + h + c_i)^5 (BN254, BLS12-381) or the inverse
round x <- (x + h + c_i)^-1 (BLS12-377); Sum folds h <- h + E(m) + m.

Round constants follow gnark-crypto's derivation: an iterated legacy
Keccak-256 chain from the seed string "seed" —
c_i = Keccak^(i+2)("seed") mod q (ecc/<curve>/fr/mimc/mimc.go
initConstants).  CAVEAT: gnark-crypto is not vendored in the reference
tree and this environment has no network, so the chain's exact
write/reset sequencing is reproduced from its documented structure and
cannot be byte-verified against upstream here; OUR host and circuit
implementations are bit-identical to each other (differential-tested)
and the digests are pinned as goldens in tests/test_std.py.
"""

from __future__ import annotations

import dataclasses

from gnark_tpu_torch.utils.keccak import keccak256


@dataclasses.dataclass(frozen=True)
class MiMCParams:
    n_rounds: int
    sbox: str        # "pow5" | "inverse"
    seed: str = "seed"   # gnark-crypto's seed string


PARAMS = {
    "bn254": MiMCParams(n_rounds=110, sbox="pow5"),
    "bls12_381": MiMCParams(n_rounds=111, sbox="pow5"),
    "bls12_377": MiMCParams(n_rounds=62, sbox="inverse"),
    # outer curves of the 2-chains: pow5 like the reference's BW6
    # variants (std/hash/mimc/encrypt.go:38-41 encryptPow5); round
    # counts from ceil(bits(q) / log2(5))
    "bw6_761": MiMCParams(n_rounds=137, sbox="pow5"),
    "bw6_633": MiMCParams(n_rounds=136, sbox="pow5"),
    "bls24_315": MiMCParams(n_rounds=109, sbox="pow5"),
}

_constants_cache = {}


def round_constants(curve_name: str, modulus: int) -> list:
    key = (curve_name, modulus)
    if key not in _constants_cache:
        params = PARAMS[curve_name]
        cs = []
        rnd = keccak256(params.seed.encode())
        for _ in range(params.n_rounds):
            rnd = keccak256(rnd)
            cs.append(int.from_bytes(rnd, "big") % modulus)
        _constants_cache[key] = cs
    return _constants_cache[key]


# ---- host ----------------------------------------------------------------------


class MiMCHost:
    """Host MiMC (python ints) — the gnark-crypto fr/mimc analog used to
    build witnesses (Merkle roots, EdDSA hashes)."""

    def __init__(self, curve):
        self.q = curve.fr.modulus
        self.params = PARAMS[curve.name]
        self.constants = round_constants(curve.name, self.q)
        self.h = 0
        self._data = []

    def write(self, *values: int):
        self._data.extend(v % self.q for v in values)

    def reset(self):
        self.h = 0
        self._data = []

    def _encrypt(self, m: int) -> int:
        q, h = self.q, self.h
        x = m
        if self.params.sbox == "pow5":
            for c in self.constants:
                x = pow((x + h + c) % q, 5, q)
        else:
            for c in self.constants:
                t = (x + h + c) % q
                x = pow(t, -1, q) if t else 0
        return (x + h) % q

    def sum(self) -> int:
        for m in self._data:
            self.h = (self.h + self._encrypt(m) + m) % self.q
        self._data = []
        return self.h


def mimc_hash(curve, *values: int) -> int:
    h = MiMCHost(curve)
    h.write(*values)
    return h.sum()


# ---- circuit gadget --------------------------------------------------------------


class MiMC:
    """In-circuit MiMC (std/hash/mimc/mimc.go:38 NewMiMC analog)."""

    def __init__(self, api):
        self.api = api
        curve_name = api.curve_id()
        self.params = PARAMS[curve_name]
        q = api.curve.fr.modulus
        self.constants = round_constants(curve_name, q)
        self.h = 0
        self._data = []

    def write(self, *values):
        self._data.extend(values)

    def reset(self):
        self.h = 0
        self._data = []

    def _encrypt(self, m):
        api = self.api
        x = m
        if self.params.sbox == "pow5":
            for c in self.constants:
                t = api.add(x, self.h, c)
                r = api.mul(t, t)
                r = api.mul(r, r)
                x = api.mul(r, t)
        else:
            for c in self.constants:
                x = api.inverse(api.add(x, self.h, c))
        return api.add(x, self.h)

    def sum(self):
        for m in self._data:
            self.h = self.api.add(self.h, self._encrypt(m), m)
        self._data = []
        return self.h
