"""Big-int reference engine: runs Define() on concrete values.

The oracle pattern of the reference's test engine (test/engine.go:44):
implements the same api protocol as the builders but computes directly
on python ints — no constraints, just semantics.  Every assertion in the
test harness first checks the circuit against this engine, then against
the real compile/solve/prove path.
"""

from __future__ import annotations

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.frontend import schema as schema_mod


class EngineError(Exception):
    pass


class BigIntEngine:
    """api implementation on python ints (mod q)."""

    scheme = "engine"

    def __init__(self, curve):
        self.curve = curve
        self.q = curve.fr.modulus

    # -- value plumbing ---------------------------------------------------

    def _v(self, x) -> int:
        if isinstance(x, bool):
            return int(x)
        if isinstance(x, int):
            return x % self.q
        if isinstance(x, str):
            return int(x, 0) % self.q
        raise TypeError(f"engine variable must be int, got {type(x)}")

    def constant_value(self, x):
        return self._v(x), True

    # -- arithmetic ----------------------------------------------------------

    def add(self, a, b, *rest):
        return (self._v(a) + self._v(b) + sum(self._v(r) for r in rest)) % self.q

    def sub(self, a, b, *rest):
        return (self._v(a) - self._v(b) - sum(self._v(r) for r in rest)) % self.q

    def neg(self, a):
        return (-self._v(a)) % self.q

    def mul(self, a, b, *rest):
        out = self._v(a) * self._v(b) % self.q
        for r in rest:
            out = out * self._v(r) % self.q
        return out

    def div_unchecked(self, a, b):
        a, b = self._v(a), self._v(b)
        if b == 0:
            if a == 0:
                return 0
            raise EngineError("division by 0")
        return a * pow(b, -1, self.q) % self.q

    def div(self, a, b):
        a, b = self._v(a), self._v(b)
        if b == 0:
            raise EngineError("division by 0")
        return a * pow(b, -1, self.q) % self.q

    def inverse(self, a):
        a = self._v(a)
        if a == 0:
            raise EngineError("inverse of 0")
        return pow(a, -1, self.q)

    # -- bits -------------------------------------------------------------------

    def to_binary(self, a, nb_bits=None, unconstrained=False):
        if nb_bits is None:
            nb_bits = self.q.bit_length()
        a = self._v(a)
        if a >= (1 << nb_bits):
            raise EngineError(f"{a} does not fit in {nb_bits} bits")
        return [(a >> i) & 1 for i in range(nb_bits)]

    def from_binary(self, *bits, unconstrained=False):
        if len(bits) == 1 and isinstance(bits[0], (list, tuple)):
            bits = bits[0]
        out = 0
        for i, b in enumerate(bits):
            b = self._v(b)
            if b not in (0, 1):
                raise EngineError("from_binary: digit not boolean")
            out += b << i
        return out % self.q

    def _bool(self, x):
        v = self._v(x)
        if v not in (0, 1):
            raise EngineError(f"value {v} is not boolean")
        return v

    def xor(self, a, b):
        return self._bool(a) ^ self._bool(b)

    def or_(self, a, b):
        return self._bool(a) | self._bool(b)

    def and_(self, a, b):
        return self._bool(a) & self._bool(b)

    # -- conditionals ----------------------------------------------------------

    def select(self, cond, t, f):
        return self._v(t) if self._bool(cond) else self._v(f)

    def lookup2(self, b0, b1, i0, i1, i2, i3):
        idx = self._bool(b0) + 2 * self._bool(b1)
        return self._v([i0, i1, i2, i3][idx])

    def is_zero(self, a):
        return int(self._v(a) == 0)

    def cmp(self, a, b):
        a, b = self._v(a), self._v(b)
        if a > b:
            return 1
        if a == b:
            return 0
        return (-1) % self.q

    # -- assertions ----------------------------------------------------------------

    def assert_is_equal(self, a, b):
        if self._v(a) != self._v(b):
            raise EngineError(f"{self._v(a)} != {self._v(b)}")

    def assert_is_different(self, a, b):
        if self._v(a) == self._v(b):
            raise EngineError(f"{self._v(a)} == {self._v(b)}")

    def assert_is_boolean(self, a):
        self._bool(a)

    def assert_is_less_or_equal(self, v, bound):
        if self._v(v) > self._v(bound):
            raise EngineError(f"{self._v(v)} > {self._v(bound)}")

    def mark_boolean(self, v):
        pass

    def is_boolean(self, v):
        return self._v(v) in (0, 1)

    # -- hints / misc ------------------------------------------------------------------

    def new_hint(self, fn, nb_outputs, *inputs):
        outs = fn(self.q, [self._v(i) for i in inputs], nb_outputs)
        return [o % self.q for o in outs]

    def println(self, *args):
        print("engine:", *[self._v(a) if isinstance(a, int) else a for a in args])

    def tag(self, name):
        return name

    def add_counter(self, frm, to):
        pass

    def compiler(self):
        return self

    def curve_id(self):
        return self.curve.name

    def bit_len(self):
        return self.q.bit_length()


def is_solved(circuit, assignment, curve) -> None:
    """Run Define on the assignment's concrete values; raises on failure
    (the test.IsSolved analog, test/engine.go:57)."""
    eng = BigIntEngine(curve)
    values = {}
    pub, sec = schema_mod.schema_of(type(assignment))
    for name, path, leaf in pub + sec:
        v = getattr(assignment, name)
        for i in path:
            v = v[i]
        values[(name, path)] = eng._v(schema_mod._to_int(v, leaf))

    # place concrete values on the circuit instance's signal slots
    circuit_copy = circuit
    by_name = {}
    for (name, path), v in values.items():
        by_name.setdefault(name, {})[path] = v
    for name, sig in schema_mod._signals(type(circuit)):
        vals = by_name.get(name, {})
        setattr(circuit_copy, name,
                schema_mod._nested(sig.shape, lambda p: vals[p]))
    circuit_copy.define(eng)
