"""SCS (PLONK gate) circuit builder: the frontend.API for PLONK.

Same 25-method DSL as the R1CS builder, emitting sparse gates
qL*l + qR*r + qM*l*r + qO*o + qC = 0 (reference frontend/cs/scs/
{api.go, builder.go}; gate emission addPlonkConstraint builder.go:87).

Fresh design choice vs the reference: a variable is an *affine term*
(wire, coeff, shift) with value coeff*w + shift.  Scaling and
constant-addition are free (they fold into the term), and a product of
two affine terms still fits ONE gate (qM = ca*cb, qL = ca*sb,
qR = cb*sa, qC = sa*sb) — strictly fewer gates than the reference's
splitSum/splitProd chains for the same circuits.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from gnark_tpu_torch.backend import hints as hint_registry
from gnark_tpu_torch.frontend import scs_ir
from gnark_tpu_torch.frontend.ir import CoeffTable, Hint, LogEntry
from gnark_tpu_torch.frontend.r1cs_builder import CompileConfig, CompileError


@dataclasses.dataclass(frozen=True)
class AffineTerm:
    """value = coeff * wire + shift (coeff, shift reduced mod q)."""
    wire: int
    coeff: int
    shift: int


class SCSBuilder:
    scheme = "plonk"

    def __init__(self, curve, config: CompileConfig | None = None):
        self.curve = curve
        self.q = curve.fr.modulus
        self.config = config or CompileConfig()
        self.public_names = []
        self.secret_names = []
        self.nb_internal = 0
        self._sealed = False
        # gate columns
        self.gl, self.gr, self.go = [], [], []
        self.ql, self.qr, self.qm, self.qo, self.qc = [], [], [], [], []
        self.hints = []
        self.wire_to_hint = {}
        self._booleans = set()
        self.logs = []
        self.debug_info = {}
        self.counters = []
        self._tags = {}

    # ---- wires -----------------------------------------------------------

    def add_public_variable(self, name):
        assert not self._sealed
        wid = len(self.public_names)
        self.public_names.append(name)
        return AffineTerm(wid, 1, 0)

    def add_secret_variable(self, name):
        assert not self._sealed
        wid = -(len(self.secret_names) + 1)
        self.secret_names.append(name)
        return AffineTerm(wid, 1, 0)

    def _seal(self):
        if not self._sealed:
            self._sealed = True
            self._nb_public = len(self.public_names)

    def _fix(self, t: AffineTerm) -> AffineTerm:
        self._seal()
        if t.wire < 0:
            return AffineTerm(self._nb_public - 1 - t.wire, t.coeff, t.shift)
        return t

    def new_internal(self) -> int:
        self._seal()
        wid = self._nb_public + len(self.secret_names) + self.nb_internal
        self.nb_internal += 1
        return wid

    # ---- term plumbing ------------------------------------------------------

    def _term(self, v):
        if isinstance(v, AffineTerm):
            return self._fix(v)
        if isinstance(v, bool):
            return AffineTerm(-1 - self.q, 0, int(v))  # pure constant
        if isinstance(v, int):
            return AffineTerm(-1 - self.q, 0, v % self.q)
        if isinstance(v, str):
            return AffineTerm(-1 - self.q, 0, int(v, 0) % self.q)
        raise TypeError(f"cannot use {type(v)} as a circuit variable")

    @staticmethod
    def _is_const(t: AffineTerm) -> bool:
        return t.coeff == 0

    def constant_value(self, v):
        t = self._term(v)
        return (t.shift, True) if self._is_const(t) else (None, False)

    def _gate(self, l=None, r=None, o=None, ql=0, qr=0, qm=0, qo=0, qc=0,
              debug_op=None):
        """Append one gate.  l/r/o are wire ids or None."""
        p = self.q
        cid = len(self.ql)
        self.gl.append(-1 if l is None else l)
        self.gr.append(-1 if r is None else r)
        self.go.append(-1 if o is None else o)
        self.ql.append(ql % p)
        self.qr.append(qr % p)
        self.qm.append(qm % p)
        self.qo.append(qo % p)
        self.qc.append(qc % p)
        if debug_op and self.config.debug:
            f = sys._getframe(2)
            while f and f.f_globals.get("__name__", "").startswith("gnark_tpu_torch."):
                f = f.f_back
            where = f"{f.f_code.co_filename}:{f.f_lineno}" if f else "?"
            self.debug_info[cid] = f"{debug_op} at {where}"
        return cid

    # ---- arithmetic ------------------------------------------------------------

    def add(self, a, b, *rest):
        terms = [self._term(v) for v in (a, b, *rest)]
        return self._sum(terms)

    def _sum(self, terms):
        p = self.q
        const = sum(t.shift for t in terms if self._is_const(t)) % p
        live = [t for t in terms if not self._is_const(t)]
        if not live:
            return AffineTerm(-1 - p, 0, const)
        acc = dataclasses.replace(live[0], shift=(live[0].shift + const) % p)
        for t in live[1:]:
            if t.wire == acc.wire:  # same wire: coefficients merge free
                acc = AffineTerm(acc.wire, (acc.coeff + t.coeff) % p,
                                 (acc.shift + t.shift) % p)
                if acc.coeff == 0:
                    acc = AffineTerm(-1 - p, 0, acc.shift)
                continue
            o = self.new_internal()
            # o = acc + t
            self._gate(l=acc.wire, r=t.wire, o=o, ql=acc.coeff, qr=t.coeff,
                       qo=-1, qc=acc.shift + t.shift)
            acc = AffineTerm(o, 1, 0)
        return acc

    def neg(self, a):
        t = self._term(a)
        return AffineTerm(t.wire, (-t.coeff) % self.q, (-t.shift) % self.q)

    def sub(self, a, b, *rest):
        terms = [self._term(a)] + [self.neg(v) for v in (b, *rest)]
        return self._sum(terms)

    def mul(self, a, b, *rest):
        res = self._mul2(self._term(a), self._term(b))
        for v in rest:
            res = self._mul2(res, self._term(v))
        return res

    def _mul2(self, ta, tb):
        p = self.q
        if self._is_const(ta) and self._is_const(tb):
            return AffineTerm(-1 - p, 0, ta.shift * tb.shift % p)
        if self._is_const(ta):
            ta, tb = tb, ta
        if self._is_const(tb):  # scale: free
            k = tb.shift
            return AffineTerm(ta.wire, ta.coeff * k % p, ta.shift * k % p)
        o = self.new_internal()
        # (ca a + sa)(cb b + sb) = o
        self._gate(l=ta.wire, r=tb.wire, o=o,
                   qm=ta.coeff * tb.coeff, ql=ta.coeff * tb.shift,
                   qr=tb.coeff * ta.shift, qo=-1, qc=ta.shift * tb.shift)
        return AffineTerm(o, 1, 0)

    def div_unchecked(self, a, b):
        ta, tb = self._term(a), self._term(b)
        p = self.q
        if self._is_const(tb):
            if tb.shift == 0:
                raise ZeroDivisionError("div by constant(0)")
            return self._mul2(ta, AffineTerm(-1 - p, 0, pow(tb.shift, -1, p)))
        res = self.new_internal()
        # b * res = a: qM(b,res) - a = 0
        self._gate(l=tb.wire, r=res, o=ta.wire if not self._is_const(ta) else None,
                   qm=tb.coeff, qr=tb.shift,
                   qo=(-ta.coeff) % p, qc=(-ta.shift) % p, debug_op="div")
        return AffineTerm(res, 1, 0)

    def div(self, a, b):
        tb = self._term(b)
        if self._is_const(tb):
            return self.div_unchecked(a, b)
        self.inverse(b)  # constrains b != 0
        return self.div_unchecked(a, b)

    def inverse(self, a):
        ta = self._term(a)
        p = self.q
        if self._is_const(ta):
            if ta.shift == 0:
                raise ZeroDivisionError("inverse of constant(0)")
            return AffineTerm(-1 - p, 0, pow(ta.shift, -1, p))
        res = self.new_internal()
        # a * res = 1
        self._gate(l=ta.wire, r=res, qm=ta.coeff, qr=ta.shift, qc=-1,
                   debug_op="inverse")
        return AffineTerm(res, 1, 0)

    # ---- bit ops ----------------------------------------------------------------

    def to_binary(self, a, nb_bits=None, unconstrained=False):
        if nb_bits is None:
            nb_bits = self.q.bit_length()
        ta = self._term(a)
        if self._is_const(ta):
            return [self._term((ta.shift >> i) & 1) for i in range(nb_bits)]
        bits = self.new_hint(hint_registry.n_bits, nb_bits, a)
        for b in bits:
            self.assert_is_boolean(b)
        acc = self._sum([self._scale_pow2(b, i) for i, b in enumerate(bits)])
        self.assert_is_equal(acc, a)
        return bits

    def _scale_pow2(self, v, i):
        t = self._term(v)
        k = pow(2, i, self.q)
        return AffineTerm(t.wire, t.coeff * k % self.q, t.shift * k % self.q)

    def from_binary(self, *bits, unconstrained=False):
        if len(bits) == 1 and isinstance(bits[0], (list, tuple)):
            bits = bits[0]
        for b in bits:
            if not unconstrained:
                self.assert_is_boolean(b)
        return self._sum([self._scale_pow2(b, i) for i, b in enumerate(bits)])

    def xor(self, a, b):
        ca, ka = self.constant_value(a)
        cb, kb = self.constant_value(b)
        if ka and kb:
            return self._term(ca ^ cb)
        if ka or kb:
            # one constant operand: xor(v, c) = v*(1-2c) + c is a free
            # affine transform (gnark api.Xor accepts constants)
            v, c = (b, ca) if ka else (a, cb)
            self.assert_is_boolean(v)
            t = self._term(v)
            k = (1 - 2 * c) % self.q
            out = AffineTerm(t.wire, t.coeff * k % self.q,
                             (t.shift * k + c) % self.q)
            self._booleans.add((out.wire, out.coeff, out.shift))
            return out
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        ta, tb = self._term(a), self._term(b)
        res = self.new_internal()
        # res = a + b - 2ab: qM(a,b)*2 + res - a - b = 0 with affine shifts
        # expand with affine terms: 2(ca a + sa)(cb b + sb) - (ca a + sa)
        #   - (cb b + sb) + res = 0
        self._gate(l=ta.wire, r=tb.wire, o=res,
                   qm=2 * ta.coeff * tb.coeff,
                   ql=2 * ta.coeff * tb.shift - ta.coeff,
                   qr=2 * tb.coeff * ta.shift - tb.coeff,
                   qo=1, qc=2 * ta.shift * tb.shift - ta.shift - tb.shift)
        out = AffineTerm(res, 1, 0)
        self._booleans.add((res, 1, 0))
        return out

    def or_(self, a, b):
        ca, ka = self.constant_value(a)
        cb, kb = self.constant_value(b)
        if ka and kb:
            return self._term(ca | cb)
        if ka or kb:
            # or(v, c) = v*(1-c) + c: affine, no gate (gnark api.Or)
            v, c = (b, ca) if ka else (a, cb)
            self.assert_is_boolean(v)
            if c:
                return self._term(1)
            return self._term(v)
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        ta, tb = self._term(a), self._term(b)
        res = self.new_internal()
        # res = a + b - ab
        self._gate(l=ta.wire, r=tb.wire, o=res,
                   qm=ta.coeff * tb.coeff,
                   ql=ta.coeff * tb.shift - ta.coeff,
                   qr=tb.coeff * ta.shift - tb.coeff,
                   qo=1, qc=ta.shift * tb.shift - ta.shift - tb.shift)
        out = AffineTerm(res, 1, 0)
        self._booleans.add((res, 1, 0))
        return out

    def and_(self, a, b):
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        res = self.mul(a, b)
        self.mark_boolean(res)
        return res

    # ---- conditionals -------------------------------------------------------------

    def select(self, cond, t, f):
        cc, kc = self.constant_value(cond)
        if kc:
            return t if cc != 0 else f
        self.assert_is_boolean(cond)
        d = self.sub(t, f)
        return self.add(self.mul(cond, d), f)

    def lookup2(self, b0, b1, i0, i1, i2, i3):
        self.assert_is_boolean(b0)
        self.assert_is_boolean(b1)
        c0, k0 = self.constant_value(b0)
        c1, k1 = self.constant_value(b1)
        if k0 and k1:
            return self._term([i0, i1, i2, i3][(1 if c0 else 0) + (2 if c1 else 0)])
        tmp1 = self.sub(self.mul(self.sub(self.add(i3, i0), i2, i1), b1),
                        self.sub(i0, i1))
        tmp2 = self.mul(tmp1, b0)
        return self.add(self.mul(self.sub(i2, i0), b1), tmp2, i0)

    def is_zero(self, a):
        ta = self._term(a)
        if self._is_const(ta):
            return self._term(int(ta.shift == 0))
        (m,) = self.new_hint(hint_registry.is_zero, 1, a)
        tm = self._term(m)
        # a * m == 0
        self._gate(l=ta.wire, r=tm.wire, qm=ta.coeff * tm.coeff,
                   ql=ta.coeff * tm.shift, qr=tm.coeff * ta.shift,
                   qc=ta.shift * tm.shift, debug_op="isZero")
        self.assert_is_boolean(m)
        self.inverse(self.add(m, a))
        return m

    def cmp(self, a, b):
        """Most-significant-differing-bit comparison (semantics of
        frontend/cs/scs/api.go Cmp) via the cheap formulation: with
        boolean bits, d = a_i - b_i is in {-1, 0, 1}, d^2 flags
        inequality, and an lsb->msb overwrite-select keeps the most
        significant d.  ~5 gates/bit vs the reference's ~12."""
        nb = self.q.bit_length()
        ba = self.to_binary(a, nb)
        bb = self.to_binary(b, nb)
        res = self._term(0)
        for i in range(nb):
            d = self.sub(ba[i], bb[i])
            neq = self.mul(d, d)
            self.mark_boolean(neq)
            res = self.select(neq, d, res)
        return res

    # ---- assertions ------------------------------------------------------------------

    def assert_is_equal(self, a, b):
        ta, tb = self._term(a), self._term(b)
        if self._is_const(ta) and self._is_const(tb):
            if ta.shift != tb.shift:
                raise CompileError(f"assertIsEqual({ta.shift}, {tb.shift})")
            return
        if self._is_const(tb):
            self._gate(l=ta.wire, ql=ta.coeff, qc=ta.shift - tb.shift,
                       debug_op="assertIsEqual")
        elif self._is_const(ta):
            self._gate(l=tb.wire, ql=tb.coeff, qc=tb.shift - ta.shift,
                       debug_op="assertIsEqual")
        elif ta.wire == tb.wire:
            if (ta.coeff - tb.coeff) % self.q == 0:
                if (ta.shift - tb.shift) % self.q:
                    raise CompileError("assertIsEqual: unsatisfiable")
                return
            self._gate(l=ta.wire, ql=ta.coeff - tb.coeff,
                       qc=ta.shift - tb.shift, debug_op="assertIsEqual")
        else:
            self._gate(l=ta.wire, r=tb.wire, ql=ta.coeff,
                       qr=-tb.coeff, qc=ta.shift - tb.shift,
                       debug_op="assertIsEqual")

    def assert_is_different(self, a, b):
        self.inverse(self.sub(a, b))

    def mark_boolean(self, v):
        t = self._term(v)
        self._booleans.add((t.wire, t.coeff, t.shift))

    def is_boolean(self, v):
        t = self._term(v)
        if self._is_const(t):
            return t.shift in (0, 1)
        return (t.wire, t.coeff, t.shift) in self._booleans

    def assert_is_boolean(self, v):
        t = self._term(v)
        if self._is_const(t):
            if t.shift not in (0, 1):
                raise CompileError(f"assertIsBoolean of constant {t.shift}")
            return
        key = (t.wire, t.coeff, t.shift)
        if key in self._booleans:
            return
        self._booleans.add(key)
        # v^2 - v == 0 with v = c w + s
        c, s = t.coeff, t.shift
        self._gate(l=t.wire, r=t.wire, qm=c * c, ql=2 * c * s - c,
                   qc=s * s - s, debug_op="assertIsBoolean")

    def assert_is_less_or_equal(self, v, bound):
        cb, is_const = self.constant_value(bound)
        if is_const:
            self._less_or_eq_const(v, cb)
        else:
            self._less_or_eq_var(v, bound)

    def _less_or_eq_var(self, a, bound):
        nb = self.q.bit_length()
        a_bits = self.to_binary(a, nb)
        bound_bits = self.to_binary(bound, nb)
        p = self._term(1)
        for i in range(nb - 1, -1, -1):
            vv = self.mul(p, a_bits[i])
            p_next = self.select(bound_bits[i], vv, p)
            t = self.select(bound_bits[i], 0, p)
            l = self.sub(1, t, a_bits[i])
            self.assert_is_equal(self.mul(l, a_bits[i]), 0)
            p = p_next

    def _less_or_eq_const(self, a, bound: int):
        nb = self.q.bit_length()
        if bound < 0 or bound.bit_length() > nb:
            raise CompileError("AssertIsLessOrEqual: bad bound")
        ca, is_const = self.constant_value(a)
        if is_const:
            if ca > bound:
                raise CompileError(f"{ca} > {bound}")
            return
        a_bits = self.to_binary(a, nb)
        p = self._term(1)
        for i in range(nb - 1, -1, -1):
            if (bound >> i) & 1:
                p = self.mul(p, a_bits[i])
            else:
                l = self.sub(1, p, a_bits[i])
                self.assert_is_equal(self.mul(l, a_bits[i]), 0)

    # ---- hints / misc --------------------------------------------------------------------

    def new_hint(self, fn, nb_outputs, *inputs):
        uid = hint_registry.uuid_of(fn)
        hint_registry.register(fn)
        in_terms = [self._term(v) for v in inputs]
        outs = [self.new_internal() for _ in range(nb_outputs)]
        # hint inputs as LC-form [(wire, coeff-value), ...] + const via wire -1
        in_lcs = []
        for t in in_terms:
            lc = []
            if t.coeff:
                lc.append((t.wire, t.coeff))
            if t.shift:
                lc.append((-1, t.shift))
            in_lcs.append(tuple(lc))
        h = Hint(uuid=uid, inputs=in_lcs, out_wires=outs)
        hidx = len(self.hints)
        self.hints.append(h)
        for w in outs:
            self.wire_to_hint[w] = hidx
        return [AffineTerm(w, 1, 0) for w in outs]

    def println(self, *args):
        parts = []
        for a in args:
            if isinstance(a, AffineTerm):
                t = self._fix(a)
                parts.append(((t.wire, t.coeff), (-1, t.shift)))
            else:
                parts.append(str(a))
        self.logs.append(LogEntry(parts=parts, constraint_id=len(self.ql)))

    def tag(self, name):
        self._tags[name] = len(self.ql)
        return name

    def add_counter(self, frm, to):
        self.counters.append(
            (frm, to, self._tags.get(to, len(self.ql)) - self._tags.get(frm, 0)))

    def compiler(self):
        return self

    def curve_id(self):
        return self.curve.name

    def backend_id(self):
        return self.scheme

    def bit_len(self):
        return self.q.bit_length()

    def one(self):
        return self._term(1)

    # ---- compile ------------------------------------------------------------------------------

    def _build_levels(self):
        """Dependency levelization (buildLevels, reference
        frontend/cs/scs/builder.go:356): mirrors r1cs_builder's version
        for the 3-slot gate layout."""
        nb_inputs = self._nb_public + len(self.secret_names)
        level_of = {}

        def wire_level(w):
            if w < nb_inputs:
                return -1
            if w in level_of:
                return level_of[w]
            hidx = self.wire_to_hint.get(w)
            if hidx is None:
                return None
            h = self.hints[hidx]
            lv = -1
            for lc in h.inputs:
                for iw, _ in lc:
                    if iw < 0:
                        continue
                    ilv = wire_level(iw)
                    if ilv is None:
                        raise CompileError("hint depends on unsolved wire")
                    lv = max(lv, ilv)
            lv += 1
            for ow in h.out_wires:
                level_of[ow] = lv
            return lv

        levels = []
        for ci in range(len(self.gl)):
            unknown = None
            lv = -1
            for w in (self.gl[ci], self.gr[ci], self.go[ci]):
                if w < 0:
                    continue
                wl = wire_level(w)
                if wl is None:
                    if unknown is None or unknown == w:
                        unknown = w
                    else:
                        raise CompileError(
                            f"gate {ci} has two unsolved wires")
                else:
                    lv = max(lv, wl)
            lv += 1
            if unknown is not None:
                level_of[unknown] = lv
            while len(levels) <= lv:
                levels.append([])
            levels[lv].append(ci)
        return levels

    def compile_system(self) -> scs_ir.SCS:
        self._seal()
        self._check_variables()
        table = CoeffTable(self.q)
        levels = self._build_levels()
        return scs_ir.SCS(
            curve_name=self.curve.name,
            field_modulus=self.q,
            nb_public=self._nb_public,
            nb_secret=len(self.secret_names),
            nb_internal=self.nb_internal,
            public_names=self.public_names,
            secret_names=self.secret_names,
            wires_l=np.asarray(self.gl, np.int32),
            wires_r=np.asarray(self.gr, np.int32),
            wires_o=np.asarray(self.go, np.int32),
            q_l=np.asarray([table.cid(v) for v in self.ql], np.int32),
            q_r=np.asarray([table.cid(v) for v in self.qr], np.int32),
            q_m=np.asarray([table.cid(v) for v in self.qm], np.int32),
            q_o=np.asarray([table.cid(v) for v in self.qo], np.int32),
            q_c=np.asarray([table.cid(v) for v in self.qc], np.int32),
            coeffs=list(table.values),
            hints=self.hints,
            wire_to_hint=dict(self.wire_to_hint),
            logs=self.logs,
            debug_info=self.debug_info,
            counters=self.counters,
            levels=levels,
        )

    def _check_variables(self):
        if self.config.ignore_unconstrained_inputs:
            return
        seen = set()
        for col in (self.gl, self.gr, self.go):
            seen.update(w for w in col if w >= 0)
        for h in self.hints:
            for lc in h.inputs:
                seen.update(w for w, _ in lc if w >= 0)
        missing = []
        for i, name in enumerate(self.public_names):
            if i not in seen:
                missing.append(f"public:{name}")
        for j, name in enumerate(self.secret_names):
            if self._nb_public + j not in seen:
                missing.append(f"secret:{name}")
        if missing:
            raise CompileError(
                "unconstrained inputs: " + ", ".join(missing)
                + " (use ignore_unconstrained_inputs to bypass)")
