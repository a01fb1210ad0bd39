"""Circuit schema: declaration-order walk of Public/Secret signals.

The reference walks Go structs by reflection with `gnark:"name,public"`
tags (frontend/schema/schema.go:41, tags.go).  The Python-native design:
signals are declared as class attributes (`x = Secret()`,
`y = Public(shape=(4,))`); the same schema walk serves wire allocation at
compile, witness collection, and fuzz-filling — mirroring the three
LeafHandler uses at frontend/compile.go:82,
internal/backend/bn254/witness/witness.go:103 and test/fuzz.go:116.
"""

from __future__ import annotations

import itertools

_declaration_counter = itertools.count()


class Signal:
    visibility = None

    def __init__(self, shape=None):
        self.shape = shape
        self.order = next(_declaration_counter)


class Public(Signal):
    visibility = "public"


class Secret(Signal):
    visibility = "secret"


class Circuit:
    """Base class for user circuits; subclasses declare signals as class
    attributes and implement define(self, api)."""

    def define(self, api):
        raise NotImplementedError


def _leaf_names(name, shape):
    if not shape:
        return [name]
    if isinstance(shape, int):
        shape = (shape,)
    out = []
    head, rest = shape[0], tuple(shape[1:])
    for i in range(head):
        out.extend(_leaf_names(f"{name}[{i}]", rest))
    return out


def _signals(cls):
    sigs = []
    for klass in reversed(cls.__mro__):
        for name, value in vars(klass).items():
            if isinstance(value, Signal):
                sigs.append((name, value))
    sigs.sort(key=lambda nv: nv[1].order)
    return sigs


def schema_of(cls):
    """-> (public_leaves, secret_leaves): lists of (attr, index_path, leaf_name).

    index_path is a tuple of ints into the (possibly nested) list value.
    Public leaves come first in witness order, then secret — both in
    declaration order (matching the reference's wire layout
    frontend/cs/r1cs/builder.go:398).
    """
    pub, sec = [], []
    for name, sig in _signals(cls):
        shape = sig.shape
        if isinstance(shape, int):
            shape = (shape,)
        paths = [()]
        for dim in (shape or ()):
            paths = [p + (i,) for p in paths for i in range(dim)]
        target = pub if sig.visibility == "public" else sec
        for path in paths:
            leaf = name + "".join(f"[{i}]" for i in path)
            target.append((name, path, leaf))
    return pub, sec


def _nested(shape, fill):
    if not shape:
        return fill(())
    def rec(path, dims):
        if not dims:
            return fill(path)
        return [rec(path + (i,), dims[1:]) for i in range(dims[0])]
    if isinstance(shape, int):
        shape = (shape,)
    return rec((), tuple(shape))


def instantiate(circuit, make_leaf):
    """Set every declared signal on `circuit` to variables produced by
    make_leaf(visibility, leaf_name) (in schema order: public then secret)."""
    pub, sec = schema_of(type(circuit))
    built = {}
    for vis, leaves in (("public", pub), ("secret", sec)):
        for name, path, leaf in leaves:
            built.setdefault(name, {})[path] = make_leaf(vis, leaf)
    for name, sig in _signals(type(circuit)):
        shape = sig.shape
        values = built.get(name, {})
        setattr(circuit, name, _nested(shape, lambda p: values[p]))


def collect_values(assignment, visibility=None):
    """Walk an assignment instance, return ordered leaf values (ints).

    visibility: None = public then secret; "public"/"secret" = that group.
    """
    pub, sec = schema_of(type(assignment))
    groups = {"public": pub, "secret": sec}
    order = [visibility] if visibility else ["public", "secret"]
    out = []
    for vis in order:
        for name, path, leaf in groups[vis]:
            v = getattr(assignment, name)
            if isinstance(v, Signal):
                raise ValueError(f"assignment is missing a value for {leaf}")
            for i in path:
                v = v[i]
            out.append(_to_int(v, leaf))
    return out


def _to_int(v, leaf):
    """Coerce assignment leaf values (int, numpy scalar, decimal/hex string)
    to int — the FromInterface analog (internal/utils/convert.go)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        return int(v, 0)
    if hasattr(v, "item"):
        return int(v.item())
    raise TypeError(f"cannot convert witness value for {leaf}: {type(v)}")
