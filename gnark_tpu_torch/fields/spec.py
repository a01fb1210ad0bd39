"""Field specifications for prime fields on limb planes.

A field element batch is a ``uint32[L, n]`` array ("limb planes"): L limbs of
W=16 bits each, least-significant limb first.  Values are kept in Montgomery
form (R = 2**(W*L)) on device; host-side big.Int <-> limb conversion lives
here.

The reference keeps this layer in gnark-crypto (Go + x86-64 asm, 4x64-bit
Montgomery limbs; SURVEY §2.9).  This design instead
parameterizes one set of kernels by this FieldSpec — replacing the reference's
per-curve code generation (internal/generator/backend/main.go).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

W = 16  # bits per limb (stored in uint32 lanes; 16x16 products fit uint32)
MASK = (1 << W) - 1


def _limbs_of_int(x: int, L: int) -> np.ndarray:
    return np.array([(x >> (W * i)) & MASK for i in range(L)], dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Immutable description of a prime field and its limb/Montgomery layout."""

    name: str
    modulus: int
    # smallest generator of the multiplicative group (gnark-crypto's
    # FrMultiplicativeGen; used as the coset shift for coset-NTT).
    multiplicative_generator: int

    @functools.cached_property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @functools.cached_property
    def L(self) -> int:
        """Number of 16-bit limbs (rounded up to a multiple of 4 for tiling).

        At least one SLACK BIT above the modulus is required: the device
        kernels hold conditional-subtract intermediates < 2p (add, and
        the Montgomery REDC pre-subtract value), so 2p must fit in the
        limb planes.  A modulus that exactly fills its limbs (e.g. the
        64-bit Goldilocks prime in 4 limbs) silently wraps (mul/add/inv wrong
        for values near p), so such moduli get an extra limb."""
        raw = -(-self.bits // W)
        if self.bits == W * raw:    # no slack bit: 2p overflows
            raw += 1
        return ((raw + 3) // 4) * 4

    @functools.cached_property
    def R(self) -> int:
        return pow(2, W * self.L, self.modulus)

    @functools.cached_property
    def R2(self) -> int:
        return pow(2, 2 * W * self.L, self.modulus)

    @functools.cached_property
    def n0inv(self) -> int:
        """-modulus^{-1} mod 2^W (Montgomery REDC constant)."""
        return (-pow(self.modulus, -1, 1 << W)) % (1 << W)

    @functools.cached_property
    def two_adicity(self) -> int:
        s, m = 0, self.modulus - 1
        while m % 2 == 0:
            s, m = s + 1, m // 2
        return s

    @functools.cached_property
    def two_adic_root(self) -> int:
        """Generator of the 2^two_adicity-order subgroup."""
        odd = (self.modulus - 1) >> self.two_adicity
        return pow(self.multiplicative_generator, odd, self.modulus)

    def root_of_unity(self, order: int) -> int:
        """Primitive root of unity of the given power-of-two order."""
        assert order & (order - 1) == 0
        log = order.bit_length() - 1
        assert log <= self.two_adicity, f"no 2^{log}-th root of unity in {self.name}"
        return pow(self.two_adic_root, 1 << (self.two_adicity - log), self.modulus)

    # ---- host <-> limb conversions (numpy; device ops live in ops/limbs.py)

    def to_limbs(self, values, montgomery: bool = True) -> np.ndarray:
        """ints (or iterable of ints) -> uint32[L, n] limb planes."""
        if isinstance(values, int):
            values = [values]
        p, R, L = self.modulus, self.R, self.L
        out = np.empty((L, len(values)), dtype=np.uint32)
        for j, v in enumerate(values):
            v = (v % p) * R % p if montgomery else v % p
            for i in range(L):
                out[i, j] = v & MASK
                v >>= W
        return out

    def from_limbs(self, arr, montgomery: bool = True) -> list:
        """uint32[L, n] limb planes -> list of python ints (canonical form)."""
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        rinv = pow(self.R, -1, self.modulus) if montgomery else 1
        out = []
        for j in range(arr.shape[1]):
            v = 0
            for i in reversed(range(arr.shape[0])):
                v = (v << W) | int(arr[i, j])
            out.append(v * rinv % self.modulus)
        return out

    # ---- constants as numpy limb planes (shape [L, 1]; broadcast over n)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return _limbs_of_int(self.modulus, self.L)[:, None]

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return _limbs_of_int(self.R2, self.L)[:, None]

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        return _limbs_of_int(self.R % self.modulus, self.L)[:, None]

    def validate(self) -> None:
        p, g = self.modulus, self.multiplicative_generator
        assert pow(g, (p - 1) // 2, p) != 1, "generator is a QR — not a generator"
        assert (self.n0inv * p) % (1 << W) == (1 << W) - 1
