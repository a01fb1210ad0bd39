"""Constraint-count regression stats (internal/stats analog).

The reference compiles ~20 API/gadget snippets per {curve x scheme} and
CI-checks the constraint counts against a golden file
(internal/stats/{stats.go:74, snippet.go:38, latest.stats}).  Here the
snippets are circuit factories; goldens live in tests/stats_golden.json.
Counterpart of gnark_tpu/stats.py: the same snippets over the port's
frontend and gadgets, so both packages print the same counts.

    python -m gnark_tpu_torch.stats > counts.json
"""

from __future__ import annotations

import json

from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret


_snippets = {}


def register_snippet(name):
    def deco(fn):
        _snippets[name] = fn
        return fn
    return deco


def snippet_stats(curve, scheme: str) -> dict:
    """-> {snippet name: constraint count}.  Snippets whose gadget has no
    parameters for this curve (e.g. no twisted-Edwards companion) are
    skipped — same shape as the reference's per-curve snippet matrix."""
    out = {}
    for name, make in sorted(_snippets.items()):
        try:
            cs = compile_circuit(make(), curve, scheme=scheme)
        except Exception as e:
            if isinstance(e, KeyError) or \
                    isinstance(getattr(e, "cause", None), KeyError):
                continue
            raise
        out[name] = cs.nb_constraints
    return out


def all_stats(curves, schemes=("groth16", "plonk")) -> dict:
    return {
        f"{c.name}/{s}": snippet_stats(c, s)
        for c in curves for s in schemes
    }


# ---- snippet corpus (snippet.go:38 initSnippets analog) -----------------------


def _simple(define_impl):
    class Snippet(Circuit):
        x = Secret()
        y = Public()

        def define(self, api):
            define_impl(api, self.x, self.y)
    return Snippet


@register_snippet("add")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.add(x, x, x), y))()


@register_snippet("mul")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.mul(x, x), y))()


@register_snippet("div")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.div(x, y), 1))()


@register_snippet("inverse")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.inverse(x), y))()


@register_snippet("is_zero")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.is_zero(x), y))()


@register_snippet("select")
def _():
    return _simple(
        lambda api, x, y: api.assert_is_equal(api.select(x, 1, 2), y))()


@register_snippet("lookup2")
def _():
    return _simple(
        lambda api, x, y: api.assert_is_equal(
            api.lookup2(x, x, 1, 2, 3, 4), y))()


@register_snippet("xor")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.xor(x, y), 0))()


@register_snippet("to_binary_8")
def _():
    return _simple(
        lambda api, x, y: api.assert_is_equal(api.to_binary(x, 8)[7], y))()


@register_snippet("to_binary_full")
def _():
    return _simple(
        lambda api, x, y: api.assert_is_equal(api.to_binary(x)[0], y))()


@register_snippet("assert_le_const")
def _():
    def d(api, x, y):
        api.assert_is_less_or_equal(x, 255)
        api.assert_is_equal(x, y)
    return _simple(d)()


@register_snippet("cmp")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.cmp(x, y), 1))()


@register_snippet("mimc")
def _():
    def d(api, x, y):
        from gnark_tpu_torch.std.mimc import MiMC
        h = MiMC(api)
        h.write(x)
        api.assert_is_equal(h.sum(), y)
    return _simple(d)()


@register_snippet("or")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.or_(x, y), 1))()


@register_snippet("and")
def _():
    return _simple(lambda api, x, y: api.assert_is_equal(api.and_(x, y), 0))()


@register_snippet("from_binary_8")
def _():
    def d(api, x, y):
        bits = api.to_binary(x, 8)
        api.assert_is_equal(api.from_binary(*bits), y)
    return _simple(d)()


@register_snippet("assert_boolean")
def _():
    def d(api, x, y):
        api.assert_is_boolean(x)
        api.assert_is_equal(x, y)
    return _simple(d)()


@register_snippet("glv_scalar_mul")
def _():
    def d(api, x, y):
        # only meaningful over BW6-761 (inner BLS12-377 points)
        from gnark_tpu_torch.curves import BLS12_377
        from gnark_tpu_torch.std.algebra.sw_bls12377 import G1Gadget
        if api.curve.fr.modulus != BLS12_377.fp.modulus:
            raise KeyError("bw6_761 only")
        g = G1Gadget(api)
        P = g.scalar_mul_var(
            BLS12_377.g1_gen, x)
        api.assert_is_equal(P[0], y)
    return _simple(d)()


@register_snippet("eddsa_scalar_mul_64")
def _():
    def d(api, x, y):
        from gnark_tpu_torch.std.twisted_edwards import EdCurve
        c = EdCurve(api)
        P = c.scalar_mul(c.params.base, x, nb_bits=64)
        api.assert_is_equal(P[0], y)
    return _simple(d)()


def main():
    from gnark_tpu_torch.curves import ALL_CURVES
    print(json.dumps(all_stats(list(ALL_CURVES.values())), indent=2))


if __name__ == "__main__":
    main()
