"""gnark_tpu_torch's own host modules against gnark_tpu's originals.

The port keeps a copy of every host module it needs (frontend, solvers,
curves and pairings, fields, the native core, MiMC).  Each package has its
own ``Circuit`` base class and hint registry, so a circuit is defined once
as a function of the frontend and compiled by both:

  * equal R1CS and sparse R1CS, field by field;
  * equal witnesses from both solvers (scalar walk, numpy sweep, native
    core), and both reject the invalid assignment;
  * ``pairing_for`` agrees on seeded points, ``native_msm`` on seeded
    scalars, ``mimc_hash`` on seeded inputs.

Inputs come from a numpy seed.  Tolerance: none; everything compares
exactly.
"""

import dataclasses

import numpy as np
import pytest

import circuits_corpus
import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu.std.mimc as jax_mimc
import gnark_tpu_torch.frontend.schema as torch_schema
import gnark_tpu_torch.std.mimc as torch_mimc
from gnark_tpu.backend import hints as jax_hints
from gnark_tpu.backend import scs_solver as jax_scs_solver
from gnark_tpu.backend import solver as jax_solver
from gnark_tpu.backend.native_field import native_msm as jax_native_msm
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.curves.pairing import pairing_for as jax_pairing_for
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import hints as torch_hints
from gnark_tpu_torch.backend import scs_solver as torch_scs_solver
from gnark_tpu_torch.backend import solver as torch_solver
from gnark_tpu_torch.backend.native_field import native_msm
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.curves.pairing import pairing_for
from gnark_tpu_torch.frontend.compile import compile_circuit
from gnark_tpu_torch.ops.limbs import ints_to_limbs

SEED = 11
R_MOD = BN254.fr.modulus


def twin(cls):
    """The same circuit as a class of the port's frontend: the same signal
    declarations in the same order, and the same ``define``."""
    ns = {"define": cls.define}
    for name, sig in jax_schema._signals(cls):
        kind = (torch_schema.Public if sig.visibility == "public"
                else torch_schema.Secret)
        ns[name] = kind(shape=sig.shape)
    return type(cls.__name__, (torch_schema.Circuit,), ns)


def cubic(schema):
    class Cubic(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))
    return Cubic


def mimc_one(schema, mimc):
    class MiMCOne(schema.Circuit):
        pre = schema.Secret()
        digest = schema.Public()

        def define(self, api):
            h = mimc.MiMC(api)
            h.write(self.pre)
            api.assert_is_equal(h.sum(), self.digest)
    return MiMCOne


def _mimc_digest(pre):
    h = jax_mimc.MiMCHost(JBN254)
    h.write(pre)
    return h.sum()


CORPUS = {cls.__name__: (cls, good, bad)
          for cls, good, bad in circuits_corpus.CORPUS}
CORPUS_NAMES = ["AddCircuit", "DivCircuit", "XorCircuit", "ToBinaryCircuit",
                "FromBinaryCircuit", "IsZeroCircuit", "ExpCircuit",
                "RangeCheckCircuit", "HintCorpusCircuit"]
CASES = ["cubic", "mimc"] + CORPUS_NAMES


def _case(name):
    """-> (gnark_tpu circuit class, port circuit class, valid witness,
    invalid witness), witnesses as [public | secret] ints."""
    if name == "cubic":
        return (cubic(jax_schema), cubic(torch_schema), [35, 3], [36, 3])
    if name == "mimc":
        pre = int(np.random.default_rng(SEED).integers(1, 1 << 62))
        return (mimc_one(jax_schema, jax_mimc),
                mimc_one(torch_schema, torch_mimc),
                [_mimc_digest(pre), pre], [_mimc_digest(pre) + 1, pre])
    cls, good, bad = CORPUS[name]
    return (cls, twin(cls), jax_schema.collect_values(good),
            jax_schema.collect_values(bad))


def same(a, b, path="cs"):
    """Deep equality over dataclasses, arrays, lists and dicts; classes of
    the two packages match by name.  A hint's uuid compares as it is: the
    built-ins carry the reference's names in both packages."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, path


BUILTIN_HINTS = ("is_zero", "n_bits", "ith_bit", "inv_zero")


@pytest.mark.parametrize("hint", BUILTIN_HINTS)
def test_builtin_hint_uuids_agree(hint):
    """A built-in hint has one uuid in both packages, and each registry
    finds its own function under it, so a constraint system that calls it
    binds in either."""
    fn, ref = getattr(torch_hints, hint), getattr(jax_hints, hint)
    uid = torch_hints.uuid_of(fn)
    assert uid == jax_hints.uuid_of(ref)
    assert torch_hints.get(uid) is fn and jax_hints.get(uid) is ref
    assert torch_hints.name_of(uid) == jax_hints.name_of(uid)


def test_every_port_builtin_hint_is_checked():
    """The port registers no built-in that BUILTIN_HINTS leaves out."""
    own = {f.__name__ for f in torch_hints.all_registered().values()
           if f.__module__ == torch_hints.__name__}
    assert own == set(BUILTIN_HINTS)


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
@pytest.mark.parametrize("name", CASES)
def test_both_frontends_compile_the_same_system(name, scheme):
    jcls, tcls, _, _ = _case(name)
    jcs = jax_compile(jcls(), JBN254, scheme=scheme)
    tcs = compile_circuit(tcls(), BN254, scheme=scheme)
    assert type(tcs).__module__.startswith("gnark_tpu_torch.")
    same(jcs, tcs)


@pytest.mark.parametrize("name", CASES)
def test_both_r1cs_solvers_give_the_same_witness(name):
    jcls, tcls, good, bad = _case(name)
    jcs = jax_compile(jcls(), JBN254)
    tcs = compile_circuit(tcls(), BN254)
    for kw in ({"vectorized": False}, {"vectorized": True}, {}):
        want = jax_solver.solve(jcs, good, **kw)
        got = torch_solver.solve(tcs, good, **kw)
        for f in ("values", "a", "b", "c"):
            assert getattr(got, f) == getattr(want, f), (f, kw)
    with pytest.raises(torch_solver.UnsatisfiedConstraintError):
        torch_solver.solve(tcs, bad)


@pytest.mark.parametrize("name", CASES)
def test_both_scs_solvers_give_the_same_witness(name):
    jcls, tcls, good, bad = _case(name)
    jcs = jax_compile(jcls(), JBN254, scheme="plonk")
    tcs = compile_circuit(tcls(), BN254, scheme="plonk")
    for kw in ({"native": False}, {"native": True}, {}):
        want = jax_scs_solver.solve(jcs, good, **kw)
        got = torch_scs_solver.solve(tcs, good, **kw)
        for f in ("values", "l", "r", "o"):
            assert getattr(got, f) == getattr(want, f), (f, kw)
    with pytest.raises(torch_solver.UnsatisfiedConstraintError):
        torch_scs_solver.solve(tcs, bad)


def test_native_r1cs_solver_matches_on_a_large_chain():
    """2,500 constraints: past the size where ``solve`` picks the native
    core by itself."""
    def chain(schema):
        class Chain(schema.Circuit):
            x = schema.Secret()
            y = schema.Public()

            def define(self, api):
                v = self.x
                for _ in range(2500):
                    v = api.mul(v, v)
                api.assert_is_equal(v, self.y)
        return Chain()

    y = 3
    for _ in range(2500):
        y = y * y % R_MOD
    for scheme, jsolve, tsolve, w, fields in (
            ("groth16", jax_solver.solve, torch_solver.solve, [y, 3],
             ("values", "a", "b", "c")),
            ("plonk", jax_scs_solver.solve, torch_scs_solver.solve, [y, 3],
             ("values", "l", "r", "o"))):
        jcs = jax_compile(chain(jax_schema), JBN254, scheme=scheme)
        tcs = compile_circuit(chain(torch_schema), BN254, scheme=scheme)
        want, got = jsolve(jcs, w), tsolve(tcs, w)
        assert got.limbs is not None            # the native core's planes
        for f in fields:
            assert getattr(got, f) == getattr(want, f), (scheme, f)


def _seeded_points(k):
    rng = np.random.default_rng(SEED)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(2 * k)]
    g1 = [BN254.host_g1.scalar_mul(BN254.g1_gen, s) for s in scalars[:k]]
    g2 = [BN254.host_g2.scalar_mul(BN254.g2_gen, s) for s in scalars[k:]]
    return scalars, g1, g2


def test_pairing_agrees_on_seeded_points():
    _, g1, g2 = _seeded_points(2)
    pr, jpr = pairing_for(BN254), jax_pairing_for(JBN254)
    for P, Q in zip(g1, g2):
        assert pr.pair(P, Q) == jpr.pair(P, Q)
    pairs = list(zip(g1, g2))
    assert pr.final_exp(pr.miller_loop(pairs)) == \
        jpr.final_exp(jpr.miller_loop(pairs))
    # e(aG, bH) e(-abG, H) = 1
    a, b = 5, 7
    check = [(BN254.host_g1.scalar_mul(BN254.g1_gen, a),
              BN254.host_g2.scalar_mul(BN254.g2_gen, b)),
             (BN254.host_g1.neg(BN254.host_g1.scalar_mul(BN254.g1_gen, a * b)),
              BN254.g2_gen)]
    assert pr.pairing_check(check) and jpr.pairing_check(check)


def test_curve_specs_agree():
    for f in ("b", "b2", "fp2_beta", "g1_gen", "g2_gen"):
        assert getattr(BN254, f) == getattr(JBN254, f), f
    for f in ("modulus", "L", "R", "R2", "multiplicative_generator"):
        assert getattr(BN254.fr, f) == getattr(JBN254.fr, f), f
        assert getattr(BN254.fp, f) == getattr(JBN254.fp, f), f
    assert BN254.fr.root_of_unity(1 << 10) == JBN254.fr.root_of_unity(1 << 10)


@pytest.mark.parametrize("n", [1, 37, 300])
def test_native_msm_agrees(n):
    rng = np.random.default_rng(SEED + n)
    base = [BN254.host_g1.scalar_mul(BN254.g1_gen, int(k))
            for k in rng.integers(1, 1 << 30, 8)]
    pts = [base[i % 8] for i in range(n)]
    if n > 2:
        pts[2] = None
    scalars = [int.from_bytes(rng.bytes(32), "little") % R_MOD
               for _ in range(n)]
    L = BN254.fp.L
    xs = ints_to_limbs([0 if p is None else p[0] for p in pts], L)
    ys = ints_to_limbs([0 if p is None else p[1] for p in pts], L)
    inf = np.array([p is None for p in pts], bool)
    sc = ints_to_limbs(scalars, BN254.fr.L)
    got = native_msm(BN254, xs, ys, inf, sc)
    assert got == jax_native_msm(JBN254, xs, ys, inf, sc)
    want = None
    for p, s in zip(pts, scalars):
        if p is not None:
            want = BN254.host_g1.add(want, BN254.host_g1.scalar_mul(p, s))
    assert got == want


def test_mimc_hash_agrees():
    rng = np.random.default_rng(SEED)
    for _ in range(3):
        msgs = [int.from_bytes(rng.bytes(32), "little") % R_MOD
                for _ in range(int(rng.integers(1, 4)))]
        assert torch_mimc.mimc_hash(BN254, *msgs) == \
            jax_mimc.mimc_hash(JBN254, *msgs)
    assert torch_mimc.round_constants("bn254", R_MOD) == \
        jax_mimc.round_constants("bn254", R_MOD)
