"""Bit/base conversion gadgets (std/math/bits analog).

Reference: std/math/bits/conversion*.go — ToBase/FromBase for binary and
ternary, NAF decomposition (naf.go), all hint-backed with recomposition
constraints.  The hints carry gnark_tpu's names (``gnark_tpu.std.bits.*``),
so a constraint system that calls them binds them in either package.
"""

from __future__ import annotations

from gnark_tpu_torch.backend.hints import register_as_reference


@register_as_reference
def n_trits(modulus, inputs, n_out):
    """Little-endian base-3 digits (conversion_ternary.go NTrits)."""
    (a,) = inputs
    out = []
    for _ in range(n_out):
        out.append(a % 3)
        a //= 3
    return out


@register_as_reference
def n_naf(modulus, inputs, n_out):
    """Non-adjacent form digits in {-1, 0, 1} mod p (naf.go NNAF)."""
    (a,) = inputs
    out = []
    for _ in range(n_out):
        if a % 2:
            d = 2 - (a % 4)
            out.append(d % modulus)
            a -= d
        else:
            out.append(0)
        a //= 2
    return out


def to_binary(api, v, nb_bits=None, unconstrained=False):
    return api.to_binary(v, nb_bits, unconstrained=unconstrained)


def from_binary(api, bits, unconstrained=False):
    return api.from_binary(bits, unconstrained=unconstrained)


def to_ternary(api, v, nb_trits=None):
    """Base-3 decomposition with digit-range and recomposition constraints."""
    q = api.curve.fr.modulus
    if nb_trits is None:
        nb_trits = 1
        while 3 ** nb_trits < q:
            nb_trits += 1
    trits = api.new_hint(n_trits, nb_trits, v)
    acc = 0
    pw = 1
    for t in trits:
        # t in {0,1,2}: t(t-1)(t-2) == 0
        api.assert_is_equal(
            api.mul(t, api.sub(t, 1), api.sub(t, 2)), 0)
        acc = api.add(acc, api.mul(t, pw))
        pw = pw * 3 % q
    api.assert_is_equal(acc, v)
    return trits


def to_naf(api, v, nb_digits=None):
    """NAF digits in {-1, 0, 1} with recomposition constraint."""
    q = api.curve.fr.modulus
    if nb_digits is None:
        nb_digits = q.bit_length() + 1
    digits = api.new_hint(n_naf, nb_digits, v)
    acc = 0
    pw = 1
    for d in digits:
        # d in {-1,0,1}: d(d-1)(d+1) == 0
        api.assert_is_equal(api.mul(d, api.sub(d, 1), api.add(d, 1)), 0)
        acc = api.add(acc, api.mul(d, pw))
        pw = pw * 2 % q
    api.assert_is_equal(acc, v)
    return digits
