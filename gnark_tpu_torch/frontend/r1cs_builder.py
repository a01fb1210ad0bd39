"""R1CS circuit builder: the frontend.API implementation for Groth16.

Implements the 25-method circuit DSL (reference interface
frontend/api.go:28-143; R1CS semantics from frontend/cs/r1cs/api.go —
e.g. IsZero's hint+2-constraint gadget at api.go:427, the Lookup2
3-constraint form at api.go:380, the binary-decomposition range check at
api_assertions.go:91) as a fresh Python eDSL over the array IR in ir.py.

Differences from the reference by design:
  * linear expressions are canonical dict-merged tuples, not sorted Go
    slices; constants ride on wire 0;
  * compile() freezes constraints into CSR numpy arrays and a level
    schedule (the vectorizable analog of builder.go:407 buildLevels).
"""

from __future__ import annotations

import dataclasses
import sys

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.frontend import ir
from gnark_tpu_torch.frontend.ir import (
    CoeffTable, Hint, LogEntry,
    lc_combine, lc_const, lc_const_value, lc_single,
)


class Variable:
    """Opaque circuit variable (a linear combination over wires)."""

    __slots__ = ("lc",)

    def __init__(self, lc):
        self.lc = lc

    def __repr__(self):
        return f"Variable({self.lc})"


class CompileError(Exception):
    pass


@dataclasses.dataclass
class CompileConfig:
    capacity: int = 0
    ignore_unconstrained_inputs: bool = False
    debug: bool = True  # capture op/location for failable constraints


class R1CSBuilder:
    """Accumulates rank-1 constraints; emits ir.R1CS via compile()."""

    scheme = "groth16"

    def __init__(self, curve, config: CompileConfig | None = None):
        self.curve = curve
        self.field = curve.fr
        self.q = curve.fr.modulus
        self.config = config or CompileConfig()
        self.table = CoeffTable(self.q)
        # wire layout: [one | public... | secret... | internal...]
        self.public_names = ["one"]
        self.secret_names = []
        self.nb_internal = 0
        self._sealed_inputs = False
        self.constraints_L = []
        self.constraints_R = []
        self.constraints_O = []
        self.hints = []
        self.wire_to_hint = {}
        self._booleans = set()
        self.logs = []
        self.debug_info = {}
        self.counters = []
        self._tags = {}

    # ---- wire allocation --------------------------------------------------

    def add_public_variable(self, name):
        assert not self._sealed_inputs
        wid = len(self.public_names)
        self.public_names.append(name)
        return Variable(lc_single(wid))

    def add_secret_variable(self, name):
        assert not self._sealed_inputs
        self._pending_secret = True
        wid = -(len(self.secret_names) + 1)  # patched in _seal
        self.secret_names.append(name)
        return Variable(lc_single(wid))

    def _seal_inputs(self):
        """Fix wire numbering once all inputs are declared: secrets get ids
        after the publics (negative placeholders are patched)."""
        if self._sealed_inputs:
            return
        self._sealed_inputs = True
        self._nb_public = len(self.public_names)

    def _wire(self, w):
        return w if w >= 0 else self._nb_public - 1 - w  # -1 -> nbPub, -2 -> nbPub+1

    def new_internal(self):
        self._seal_inputs()
        wid = self._nb_public + len(self.secret_names) + self.nb_internal
        self.nb_internal += 1
        return wid

    # ---- LC plumbing ---------------------------------------------------------

    def one(self):
        return lc_single(0)

    def _lc(self, v):
        if isinstance(v, Variable):
            # first use of a variable inside define(): input declaration is
            # over, so wire numbering can be fixed
            self._seal_inputs()
            return tuple(sorted((self._wire(w), c) for w, c in v.lc))
        if isinstance(v, bool):
            return lc_const(self.table, int(v))
        if isinstance(v, int):
            return lc_const(self.table, v)
        if isinstance(v, str):
            return lc_const(self.table, int(v, 0))
        raise TypeError(f"cannot use {type(v)} as a circuit variable")

    def constant_value(self, v):
        """-> (int, True) if v is a compile-time constant else (None, False)."""
        lc = self._lc(v)
        c = lc_const_value(self.table, lc)
        return (c, True) if c is not None else (None, False)

    def _add_constraint(self, l, r, o, debug_op=None):
        # shorter expression into R ("B matrix") — prover infinity-point
        # optimization mirrored from the reference builder (newR1C swap,
        # frontend/cs/r1cs/builder.go:157).
        if len(l) < len(r):
            l, r = r, l
        cid = len(self.constraints_L)
        self.constraints_L.append(l)
        self.constraints_R.append(r)
        self.constraints_O.append(o)
        if debug_op and self.config.debug:
            self.debug_info[cid] = self._debug_location(debug_op)
        return cid

    def _debug_location(self, op):
        f = sys._getframe(2)
        # walk out of builder frames to user code
        while f and f.f_globals.get("__name__", "").startswith("gnark_tpu_torch."):
            f = f.f_back
        where = f"{f.f_code.co_filename}:{f.f_lineno}" if f else "?"
        return f"{op} at {where}"

    # ---- arithmetic -----------------------------------------------------------

    def add(self, a, b, *rest):
        parts = [(self._lc(v), 1) for v in (a, b, *rest)]
        return Variable(lc_combine(self.table, parts))

    def neg(self, a):
        return Variable(lc_combine(self.table, [(self._lc(a), -1)]))

    def sub(self, a, b, *rest):
        parts = [(self._lc(a), 1)] + [(self._lc(v), -1) for v in (b, *rest)]
        return Variable(lc_combine(self.table, parts))

    def mul(self, a, b, *rest):
        res = self._mul2(a, b)
        for v in rest:
            res = self._mul2(res, v)
        return res

    def _mul2(self, a, b):
        la, lb = self._lc(a), self._lc(b)
        ca = lc_const_value(self.table, la)
        cb = lc_const_value(self.table, lb)
        if ca is not None and cb is not None:
            return Variable(lc_const(self.table, ca * cb))
        if ca is not None:
            return Variable(lc_combine(self.table, [(lb, ca)]))
        if cb is not None:
            return Variable(lc_combine(self.table, [(la, cb)]))
        o = self.new_internal()
        self._add_constraint(la, lb, lc_single(o))
        return Variable(lc_single(o))

    def div_unchecked(self, a, b):
        """a / b with 0/0 = 0 (single constraint b * res = a)."""
        la, lb = self._lc(a), self._lc(b)
        ca = lc_const_value(self.table, la)
        cb = lc_const_value(self.table, lb)
        if cb is not None:
            if cb == 0:
                raise ZeroDivisionError("div by constant(0)")
            inv = pow(cb, -1, self.q)
            if ca is not None:
                return Variable(lc_const(self.table, ca * inv))
            return Variable(lc_combine(self.table, [(la, inv)]))
        res = self.new_internal()
        self._add_constraint(lb, lc_single(res), la, debug_op="div")
        return Variable(lc_single(res))

    def div(self, a, b):
        """a / b, additionally constraining b != 0."""
        la, lb = self._lc(a), self._lc(b)
        cb = lc_const_value(self.table, lb)
        if cb is not None:
            return self.div_unchecked(a, b)
        binv = self.new_internal()
        self._add_constraint(lb, lc_single(binv), self.one(), debug_op="div")
        res = self.new_internal()
        self._add_constraint(la, lc_single(binv), lc_single(res), debug_op="div")
        return Variable(lc_single(res))

    def inverse(self, a):
        la = self._lc(a)
        ca = lc_const_value(self.table, la)
        if ca is not None:
            if ca == 0:
                raise ZeroDivisionError("inverse of constant(0)")
            return Variable(lc_const(self.table, pow(ca, -1, self.q)))
        res = self.new_internal()
        self._add_constraint(lc_single(res), la, self.one(), debug_op="inverse")
        return Variable(lc_single(res))

    # ---- bit ops -------------------------------------------------------------

    def to_binary(self, a, nb_bits=None, unconstrained=False):
        if nb_bits is None:
            nb_bits = self.q.bit_length()
        la = self._lc(a)
        ca = lc_const_value(self.table, la)
        if ca is not None:
            return [Variable(lc_const(self.table, (ca >> i) & 1))
                    for i in range(nb_bits)]
        bits = self.new_hint(hint_registry.n_bits, nb_bits, a)
        acc_parts = []
        for i, b in enumerate(bits):
            if not unconstrained:
                self.assert_is_boolean(b)
            acc_parts.append((self._lc(b), 1 << i))
        total = Variable(lc_combine(self.table, acc_parts))
        if not unconstrained:
            self.assert_is_equal(total, a)
        else:
            # still record the recomposition so the decomposition is sound
            self.assert_is_equal(total, a)
        return bits

    def from_binary(self, *bits, unconstrained=False):
        if len(bits) == 1 and isinstance(bits[0], (list, tuple)):
            bits = bits[0]
        parts = []
        for i, b in enumerate(bits):
            if not unconstrained:
                self.assert_is_boolean(b)
            parts.append((self._lc(b), 1 << i))
        return Variable(lc_combine(self.table, parts))

    def xor(self, a, b):
        """a ^ b for booleans: one constraint (2a) * b == a + b - res."""
        la, lb = self._lc(a), self._lc(b)
        ca = lc_const_value(self.table, la)
        cb = lc_const_value(self.table, lb)
        if ca is not None and cb is not None:
            return Variable(lc_const(self.table, ca ^ cb))
        self.assert_is_boolean(Variable(la))
        self.assert_is_boolean(Variable(lb))
        res = self.new_internal()
        self.mark_boolean(Variable(lc_single(res)))
        o = lc_combine(self.table,
                       [(la, 1), (lb, 1), (lc_single(res), -1)])
        self._add_constraint(lc_combine(self.table, [(la, 2)]), lb, o)
        return Variable(lc_single(res))

    def or_(self, a, b):
        la, lb = self._lc(a), self._lc(b)
        ca = lc_const_value(self.table, la)
        cb = lc_const_value(self.table, lb)
        if ca is not None and cb is not None:
            return Variable(lc_const(self.table, ca | cb))
        self.assert_is_boolean(Variable(la))
        self.assert_is_boolean(Variable(lb))
        res = self.new_internal()
        self.mark_boolean(Variable(lc_single(res)))
        o = lc_combine(self.table,
                       [(la, 1), (lb, 1), (lc_single(res), -1)])
        self._add_constraint(la, lb, o)
        return Variable(lc_single(res))

    def and_(self, a, b):
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        res = self.mul(a, b)
        self.mark_boolean(res)
        return res

    # ---- conditionals ----------------------------------------------------------

    def select(self, cond, t, f):
        lc_cond = self._lc(cond)
        cc = lc_const_value(self.table, lc_cond)
        if cc is not None:
            return t if cc != 0 else f
        self.assert_is_boolean(Variable(lc_cond))
        # res = f + cond * (t - f): one constraint cond*(t-f) == res - f
        lt, lf = self._lc(t), self._lc(f)
        diff = lc_combine(self.table, [(lt, 1), (lf, -1)])
        res = self.new_internal()
        o = lc_combine(self.table, [(lc_single(res), 1), (lf, -1)])
        self._add_constraint(diff, lc_cond, o)
        return Variable(lc_single(res))

    def lookup2(self, b0, b1, i0, i1, i2, i3):
        """2-bit lookup, 3 constraints (semantics of frontend/cs/r1cs/api.go:380)."""
        self.assert_is_boolean(b0)
        self.assert_is_boolean(b1)
        c0, k0 = self.constant_value(b0)
        c1, k1 = self.constant_value(b1)
        if k0 and c0 is not None and k1 and c1 is not None:
            return [i0, i1, i2, i3][(1 if c0 else 0) + (2 if c1 else 0)]
        # tmp1 = b1*(i3 - i2 - i1 + i0) + i1 - i0 ; tmp2 = tmp1 * b0
        # res  = (i2 - i0)*b1 + tmp2 + i0
        tmp1 = self.sub(self.mul(self.sub(self.add(i3, i0), i2, i1), b1),
                        self.sub(i0, i1))
        tmp2 = self.mul(tmp1, b0)
        return self.add(self.mul(self.sub(i2, i0), b1), tmp2, i0)

    def is_zero(self, a):
        """1 if a == 0 else 0 (hint + 2 constraints + boolean constraint;
        semantics of frontend/cs/r1cs/api.go:427)."""
        la = self._lc(a)
        ca = lc_const_value(self.table, la)
        if ca is not None:
            return Variable(lc_const(self.table, int(ca == 0)))
        (m,) = self.new_hint(hint_registry.is_zero, 1, a)
        # a * m == 0 ; m boolean ; inverse(m + a) forces m=1 when a=0
        self._add_constraint(la, self._lc(m), (), debug_op="isZero")
        self.assert_is_boolean(m)
        self.inverse(self.add(m, a))
        return m

    def cmp(self, a, b):
        """1 if a > b, 0 if equal, -1 (i.e. q-1) if a < b.

        Semantics of frontend/cs/r1cs/api.go:459 (most significant
        differing bit decides) at 2 constraints/bit instead of the
        reference's ~11: both bits are boolean, so d = a_i - b_i is a
        free linear term in {-1, 0, 1}, d^2 is a 1-constraint
        inequality flag (boolean by construction), and scanning
        lsb->msb with an overwrite-select leaves the most significant
        d in res.
        """
        nb = self.q.bit_length()
        ba = self.to_binary(a, nb)
        bb = self.to_binary(b, nb)
        res = Variable(lc_const(self.table, 0))
        for i in range(nb):
            d = self.sub(ba[i], bb[i])
            neq = self.mul(d, d)
            self.mark_boolean(neq)
            res = self.select(neq, d, res)
        return res

    # ---- assertions ---------------------------------------------------------------

    def assert_is_equal(self, a, b):
        la, lb = self._lc(a), self._lc(b)
        self._add_constraint(la, self.one(), lb, debug_op="assertIsEqual")

    def assert_is_different(self, a, b):
        self.inverse(self.sub(a, b))

    def mark_boolean(self, v):
        self._booleans.add(self._lc(v))

    def is_boolean(self, v):
        lc = self._lc(v)
        c = lc_const_value(self.table, lc)
        if c is not None:
            return c in (0, 1)
        return lc in self._booleans

    def assert_is_boolean(self, v):
        lc = self._lc(v)
        c = lc_const_value(self.table, lc)
        if c is not None:
            if c not in (0, 1):
                raise CompileError(f"assertIsBoolean of constant {c}")
            return
        if lc in self._booleans:
            return
        self._booleans.add(lc)
        # (1 - v) * v == 0
        one_minus = lc_combine(self.table, [(self.one(), 1), (lc, -1)])
        self._add_constraint(one_minus, lc, (), debug_op="assertIsBoolean")

    def assert_is_less_or_equal(self, v, bound):
        cb, is_const = self.constant_value(bound)
        if is_const and cb is not None:
            self._less_or_eq_const(v, cb)
        else:
            self._less_or_eq_var(v, bound)

    def _less_or_eq_var(self, a, bound):
        """Binary-decomposition comparison (api_assertions.go:91 semantics)."""
        nb = self.q.bit_length()
        a_bits = self.to_binary(a, nb, unconstrained=True)
        bound_bits = self.to_binary(bound, nb)
        p = [None] * (nb + 1)
        p[nb] = Variable(lc_const(self.table, 1))
        for i in range(nb - 1, -1, -1):
            v = self.mul(p[i + 1], a_bits[i])
            p[i] = self.select(bound_bits[i], v, p[i + 1])
            t = self.select(bound_bits[i], 0, p[i + 1])
            # (1 - t - a_i) * a_i == 0
            l = self.sub(1, t, a_bits[i])
            self.mark_boolean(a_bits[i])
            self._add_constraint(self._lc(l), self._lc(a_bits[i]), (),
                                 debug_op="mustBeLessOrEq")

    def _less_or_eq_const(self, a, bound: int):
        nb = self.q.bit_length()
        if bound < 0:
            raise CompileError("AssertIsLessOrEqual: negative bound")
        if bound.bit_length() > nb:
            raise CompileError("AssertIsLessOrEqual: bound too large")
        ca, is_const = self.constant_value(a)
        if is_const and ca is not None:
            if ca > bound:
                raise CompileError(f"{ca} > {bound}")
            return
        a_bits = self.to_binary(a, nb, unconstrained=True)
        p = [None] * (nb + 1)
        p[nb] = Variable(lc_const(self.table, 1))
        for i in range(nb - 1, -1, -1):
            if (bound >> i) & 1:
                p[i] = self.mul(p[i + 1], a_bits[i])
            else:
                p[i] = p[i + 1]
        for i in range(nb - 1, -1, -1):
            if (bound >> i) & 1 == 0:
                l = self.sub(1, p[i + 1], a_bits[i])
                self._add_constraint(self._lc(l), self._lc(a_bits[i]), (),
                                     debug_op="mustBeLessOrEq")
                self.mark_boolean(a_bits[i])
            else:
                self.assert_is_boolean(a_bits[i])

    # ---- hints / misc -----------------------------------------------------------

    def new_hint(self, fn, nb_outputs, *inputs):
        uid = hint_registry.uuid_of(fn)
        hint_registry.register(fn)  # idempotent
        in_lcs = [self._lc(v) for v in inputs]
        outs = [self.new_internal() for _ in range(nb_outputs)]
        h = Hint(uuid=uid, inputs=in_lcs, out_wires=outs)
        hidx = len(self.hints)
        self.hints.append(h)
        for w in outs:
            self.wire_to_hint[w] = hidx
        return [Variable(lc_single(w)) for w in outs]

    def println(self, *args):
        parts = []
        for a in args:
            if isinstance(a, Variable):
                parts.append(self._lc(a))
            else:
                parts.append(str(a))
        self.logs.append(LogEntry(parts=parts,
                                  constraint_id=len(self.constraints_L)))

    def tag(self, name):
        self._tags[name] = len(self.constraints_L)
        return name

    def add_counter(self, frm, to):
        self.counters.append(
            (frm, to, self._tags.get(to, len(self.constraints_L)) -
             self._tags.get(frm, 0)))

    def compiler(self):
        return self

    def curve_id(self):
        return self.curve.name

    def backend_id(self):
        return self.scheme

    def bit_len(self):
        return self.q.bit_length()

    # ---- compile -----------------------------------------------------------------

    def compile_system(self) -> ir.R1CS:
        self._seal_inputs()
        self._check_variables()
        levels = self._build_levels()
        return ir.R1CS(
            curve_name=self.curve.name,
            field_modulus=self.q,
            nb_public=self._nb_public,
            nb_secret=len(self.secret_names),
            nb_internal=self.nb_internal,
            public_names=self.public_names,
            secret_names=self.secret_names,
            coeffs=list(self.table.values),
            L=ir.pack_matrix(self.constraints_L),
            R=ir.pack_matrix(self.constraints_R),
            O=ir.pack_matrix(self.constraints_O),
            hints=self.hints,
            wire_to_hint=dict(self.wire_to_hint),
            levels=levels,
            logs=self.logs,
            debug_info=self.debug_info,
            counters=self.counters,
        )

    def _check_variables(self):
        """Unconstrained-input detection (builder.go:237 semantics)."""
        if self.config.ignore_unconstrained_inputs:
            return
        seen = set()
        for rows in (self.constraints_L, self.constraints_R, self.constraints_O):
            for lc in rows:
                for w, _ in lc:
                    seen.add(w)
        for h in self.hints:
            for lc in h.inputs:
                for w, _ in lc:
                    seen.add(w)
        missing = []
        for i, name in enumerate(self.public_names[1:], start=1):
            if i not in seen:
                missing.append(f"public:{name}")
        for j, name in enumerate(self.secret_names):
            if self._nb_public + j not in seen:
                missing.append(f"secret:{name}")
        if missing:
            raise CompileError(
                "unconstrained inputs: " + ", ".join(missing)
                + " (use ignore_unconstrained_inputs to bypass)")

    def _build_levels(self):
        """Dependency levelization for parallel solving (the vectorizable
        analog of frontend/cs/r1cs/builder.go:407 buildLevels)."""
        nb_inputs = self._nb_public + len(self.secret_names)
        level_of = {}

        def wire_level(w):
            if w < nb_inputs:
                return -1
            if w in level_of:
                return level_of[w]
            hidx = self.wire_to_hint.get(w)
            if hidx is None:
                return None  # unsolved non-hint wire
            h = self.hints[hidx]
            lv = -1
            for lc in h.inputs:
                for iw, _ in lc:
                    ilv = wire_level(iw)
                    if ilv is None:
                        raise CompileError("hint depends on unsolved wire")
                    lv = max(lv, ilv)
            lv = lv + 1
            for ow in h.out_wires:
                level_of[ow] = lv
            return lv

        levels = []
        for ci in range(len(self.constraints_L)):
            unknown = None
            lv = -1
            for lc in (self.constraints_L[ci], self.constraints_R[ci],
                       self.constraints_O[ci]):
                for w, _ in lc:
                    wl = wire_level(w)
                    if wl is None:
                        if unknown is None or unknown == w:
                            unknown = w
                        else:
                            raise CompileError(
                                f"constraint {ci} has two unsolved wires")
                    else:
                        lv = max(lv, wl)
            lv += 1
            if unknown is not None:
                level_of[unknown] = lv
            while len(levels) <= lv:
                levels.append([])
            levels[lv].append(ci)
        return levels
