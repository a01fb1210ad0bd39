"""Hint registry: solver-time callbacks for out-of-circuit computation.

Reference: backend/hint/{hint.go:86 (Function signature), registry.go:13
(global Register/GetRegistered), builtin.go:16 (IsZero = 1 - a^(q-1))}.
A hint function receives the field modulus and resolved input values and
returns the output values; the circuit then constrains the outputs.
UUID = FNV-1a 32-bit hash of the function's qualified name so serialized
constraint systems can re-bind functions by id (std/hints.go:18 pattern).
"""

from __future__ import annotations

from typing import Callable, Sequence

HintFunction = Callable[[int, Sequence[int], int], Sequence[int]]
# (field_modulus, inputs, n_outputs) -> outputs

_registry: dict[int, HintFunction] = {}
_names: dict[int, str] = {}


def uuid_of(fn: Callable) -> int:
    name = getattr(fn, "_hint_name", None) or f"{fn.__module__}.{fn.__qualname__}"
    h = 0x811C9DC5
    for b in name.encode():
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def register(fn: HintFunction) -> HintFunction:
    uid = uuid_of(fn)
    existing = _registry.get(uid)
    if existing is not None and existing is not fn:
        raise ValueError(f"hint uuid collision for {fn}")
    _registry[uid] = fn
    _names[uid] = getattr(fn, "_hint_name", None) or f"{fn.__module__}.{fn.__qualname__}"
    return fn


def get(uid: int) -> HintFunction:
    fn = _registry.get(uid)
    if fn is None:
        raise KeyError(f"hint {uid:#x} is not registered (call hints.register)")
    return fn


def name_of(uid: int) -> str:
    return _names.get(uid, f"{uid:#x}")


def all_registered():
    return dict(_registry)


# ---- builtins ---------------------------------------------------------------


def register_as_reference(fn: HintFunction) -> HintFunction:
    """Register a hint under the reference package's name for it (its
    module's path with ``gnark_tpu_torch`` read as ``gnark_tpu``), so that
    its uuid, and a constraint system that calls it, is the same in both
    packages.  The name is a string: nothing of it is imported."""
    rest = fn.__module__.partition(".")[2]
    fn._hint_name = f"gnark_tpu.{rest}.{fn.__qualname__}"
    return register(fn)


@register_as_reference
def is_zero(modulus, inputs, n_out):
    """m = 1 - a^(q-1): 1 if a == 0 else 0 (backend/hint/builtin.go:16)."""
    (a,) = inputs
    return [(1 - pow(a, modulus - 1, modulus)) % modulus]


@register_as_reference
def n_bits(modulus, inputs, n_out):
    """Little-endian bits of the input (std/math/bits NBits)."""
    (a,) = inputs
    return [(a >> i) & 1 for i in range(n_out)]


@register_as_reference
def ith_bit(modulus, inputs, n_out):
    """inputs = (n, i) -> i-th little-endian bit of n."""
    n, i = inputs
    if i >= n.bit_length() + 64:
        return [0]
    return [(n >> i) & 1]


@register_as_reference
def inv_zero(modulus, inputs, n_out):
    """a^{-1}, with 0 -> 0."""
    (a,) = inputs
    return [pow(a, -1, modulus) if a % modulus else 0]
