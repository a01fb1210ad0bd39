"""gnark_tpu_torch's gadget library, big-int engine and harness against
gnark_tpu's.

Each gadget circuit is defined once as a function of a package (its
frontend and its gadget modules) and compiled by both:

  * equal R1CS and sparse R1CS, field by field (hint uuids included);
  * equal witnesses from both solvers, and the port's solver rejects the
    invalid assignment;
  * the port's harness (engine, solver) accepts the valid assignment and
    rejects the invalid one;
  * both big-int engines give the same gadget outputs;
  * EdDSA keys and signatures, Merkle trees and proofs, the twisted
    Edwards parameters of every curve, the Bandersnatch GLV constants and
    decompositions, the ternary and NAF hints are equal;
  * the gadget hints carry gnark_tpu's uuids, and the port's
    ``register_hints`` registers the same library hints as gnark_tpu's,
    the two of ``std/algebra`` (BLS12-377 and BLS24-315 scalar
    decompositions) among them.

Inputs come from a numpy seed.  Tolerance: none; field elements and
points compare exactly as Python ints.
"""

import dataclasses
import types

import numpy as np
import pytest

import gnark_tpu.curves as jax_curves
import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu.std as jax_std
import gnark_tpu.std.bits as jax_bits
import gnark_tpu.std.eddsa as jax_eddsa
import gnark_tpu.std.fiat_shamir as jax_fs
import gnark_tpu.std.merkle as jax_merkle
import gnark_tpu.std.mimc as jax_mimc
import gnark_tpu.std.twisted_edwards as jax_te
import gnark_tpu.test_engine as jax_engine
import gnark_tpu_torch.curves as torch_curves
import gnark_tpu_torch.frontend.schema as torch_schema
import gnark_tpu_torch.std as torch_std
import gnark_tpu_torch.std.bits as torch_bits
import gnark_tpu_torch.std.eddsa as torch_eddsa
import gnark_tpu_torch.std.fiat_shamir as torch_fs
import gnark_tpu_torch.std.merkle as torch_merkle
import gnark_tpu_torch.std.mimc as torch_mimc
import gnark_tpu_torch.std.twisted_edwards as torch_te
import gnark_tpu_torch.test_engine as torch_engine
from gnark_tpu.backend import hints as jax_hints
from gnark_tpu.backend import scs_solver as jax_scs_solver
from gnark_tpu.backend import solver as jax_solver
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch import test_harness
from gnark_tpu_torch.backend import hints as torch_hints
from gnark_tpu_torch.backend import scs_solver as torch_scs_solver
from gnark_tpu_torch.backend import solver as torch_solver
from gnark_tpu_torch.frontend.compile import compile_circuit
from test_torch_host_parity import same

SEED = 23

JAX = types.SimpleNamespace(
    schema=jax_schema, bits=jax_bits, te=jax_te, eddsa=jax_eddsa,
    merkle=jax_merkle, fs=jax_fs, mimc=jax_mimc, curves=jax_curves,
    engine=jax_engine, hints=jax_hints, std=jax_std)
PORT = types.SimpleNamespace(
    schema=torch_schema, bits=torch_bits, te=torch_te, eddsa=torch_eddsa,
    merkle=torch_merkle, fs=torch_fs, mimc=torch_mimc, curves=torch_curves,
    engine=torch_engine, hints=torch_hints, std=torch_std)


# ---- the gadget circuits, as functions of a package ----------------------


def merkle_circuit(P):
    S = P.schema

    class MerkleCircuit(S.Circuit):
        root = S.Public()
        proof = S.Secret(shape=(4,))
        helper = S.Secret(shape=(3,))

        def define(self, api):
            P.merkle.verify_proof(api, self.root, self.proof, self.helper)
    return MerkleCircuit


def ed_scalar_mul_circuit(P):
    S = P.schema

    class ScalarMul(S.Circuit):
        k = S.Secret()
        x = S.Public()
        y = S.Public()

        def define(self, api):
            c = P.te.EdCurve(api)
            Q = c.scalar_mul(c.params.base, self.k, nb_bits=64)
            api.assert_is_equal(Q[0], self.x)
            api.assert_is_equal(Q[1], self.y)
    return ScalarMul


def eddsa_circuit(P):
    S = P.schema

    class EdDSACircuit(S.Circuit):
        msg = S.Public()
        rx = S.Secret()
        ry = S.Secret()
        s = S.Secret()
        ax = S.Secret()
        ay = S.Secret()

        def define(self, api):
            P.eddsa.verify(api, (self.rx, self.ry), self.s, self.msg,
                           (self.ax, self.ay))
    return EdDSACircuit


def bits_circuit(P):
    S = P.schema

    class Ternary(S.Circuit):
        v = S.Secret()
        w = S.Public()

        def define(self, api):
            P.bits.to_ternary(api, self.v, nb_trits=12)
            P.bits.to_naf(api, self.w, nb_digits=12)
    return Ternary


def transcript_circuit(P):
    S = P.schema

    class Transcript(S.Circuit):
        a = S.Secret()
        b = S.Secret()
        c = S.Secret()
        alpha = S.Public()
        beta = S.Public()

        def define(self, api):
            fs = P.fs.CircuitTranscript(api, P.mimc.MiMC(api), "alpha", "beta")
            fs.bind("alpha", self.a, self.b)
            fs.bind("beta", self.c)
            api.assert_is_equal(fs.compute_challenge("alpha"), self.alpha)
            api.assert_is_equal(fs.compute_challenge("beta"), self.beta)
    return Transcript


def glv_circuit(P):
    """Bandersnatch's GLV ladder over a variable base (BLS12-381's fr)."""
    S = P.schema

    class Glv(S.Circuit):
        out_x = S.Public()
        out_y = S.Public()
        bx = S.Secret()
        by = S.Secret()
        k = S.Secret()

        def define(self, api):
            c = P.te.EdCurve(api, P.te.BANDERSNATCH)
            Q = c.scalar_mul_glv((self.bx, self.by), self.k)
            api.assert_is_equal(Q[0], self.out_x)
            api.assert_is_equal(Q[1], self.out_y)
    return Glv


def _witnesses(name):
    """-> (curve name, valid values, invalid values) as {signal: value},
    made from the seed with the port's host functions."""
    rng = np.random.default_rng(SEED)
    bn = torch_curves.BN254
    if name == "merkle":
        leaves = [int(v) for v in rng.integers(1, 1 << 62, 8)]
        proof, helper = torch_merkle.prove(bn, leaves, 5)
        good = {"root": torch_merkle.root(bn, leaves), "proof": proof,
                "helper": helper}
        return "bn254", good, {**good, "proof": [proof[0] + 1] + proof[1:]}
    if name == "ed_scalar_mul":
        ed = torch_te.host_curve("bn254")
        k = int(rng.integers(1, 1 << 62)) << 2 | 3
        x, y = ed.scalar_mul(ed.params.base, k)
        return "bn254", {"k": k, "x": x, "y": y}, {"k": k, "x": x, "y": y + 1}
    if name == "eddsa":
        kp = torch_eddsa.KeyPair.generate(bn, rng.bytes(16))
        msg = int(rng.integers(1, 1 << 62))
        sig = kp.sign(msg, bn)
        good = {"msg": msg, "rx": sig.r[0], "ry": sig.r[1], "s": sig.s,
                "ax": kp.public[0], "ay": kp.public[1]}
        return "bn254", good, {**good, "msg": msg + 1}
    if name == "bits":
        v, w = int(rng.integers(0, 3 ** 12)), int(rng.integers(0, 1 << 10))
        return "bn254", {"v": v, "w": w}, {"v": 3 ** 12 + v, "w": w}
    if name == "transcript":
        a, b, c = (int(x) for x in rng.integers(0, 1 << 62, 3))
        alpha = torch_mimc.mimc_hash(bn, a, b)
        beta = torch_mimc.mimc_hash(bn, alpha, c)
        good = {"a": a, "b": b, "c": c, "alpha": alpha, "beta": beta}
        return "bn254", good, {**good, "beta": beta + 1}
    if name == "glv":
        host = torch_te.EdHost(torch_te.BANDERSNATCH)
        base = host.scalar_mul(torch_te.BANDERSNATCH.base, 3)
        k = int.from_bytes(rng.bytes(32), "little") % torch_te.BANDERSNATCH.order
        x, y = host.scalar_mul(base, k)
        good = {"out_x": x, "out_y": y, "bx": base[0], "by": base[1], "k": k}
        return "bls12_381", good, {**good, "out_y": y + 1}
    raise KeyError(name)


CIRCUITS = {"merkle": merkle_circuit, "ed_scalar_mul": ed_scalar_mul_circuit,
            "eddsa": eddsa_circuit, "bits": bits_circuit,
            "transcript": transcript_circuit, "glv": glv_circuit}


def _assign(cls, values):
    a = cls()
    for k, v in values.items():
        setattr(a, k, v)
    return a


def _case(name):
    """-> (gnark_tpu class, port class, curve name, valid and invalid
    witnesses as [public | secret] ints, valid and invalid port
    assignments)."""
    curve, good, bad = _witnesses(name)
    jcls, tcls = CIRCUITS[name](JAX), CIRCUITS[name](PORT)
    return (jcls, tcls, curve,
            torch_schema.collect_values(_assign(tcls, good)),
            torch_schema.collect_values(_assign(tcls, bad)),
            _assign(tcls, good), _assign(tcls, bad))


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_both_frontends_compile_the_same_system(name, scheme):
    jcls, tcls, curve, *_ = _case(name)
    jcs = jax_compile(jcls(), jax_curves.ALL_CURVES[curve], scheme=scheme)
    tcs = compile_circuit(tcls(), torch_curves.ALL_CURVES[curve], scheme=scheme)
    assert type(tcs).__module__.startswith("gnark_tpu_torch.")
    same(jcs, tcs)


@pytest.mark.parametrize("scheme", ["groth16", "plonk"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_both_solvers_give_the_same_witness(name, scheme):
    jcls, tcls, curve, good, bad, *_ = _case(name)
    jcs = jax_compile(jcls(), jax_curves.ALL_CURVES[curve], scheme=scheme)
    tcs = compile_circuit(tcls(), torch_curves.ALL_CURVES[curve], scheme=scheme)
    if scheme == "groth16":
        ref, port, fields = jax_solver, torch_solver, ("values", "a", "b", "c")
    else:
        ref, port, fields = (jax_scs_solver, torch_scs_solver,
                             ("values", "l", "r", "o"))
    want, got = ref.solve(jcs, good), port.solve(tcs, good)
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(torch_solver.UnsatisfiedConstraintError):
        port.solve(tcs, bad)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_port_harness_accepts_valid_and_rejects_invalid(name):
    _, tcls, curve, _, _, good, bad = _case(name)
    c = torch_curves.ALL_CURVES[curve]
    assert test_harness.prover_succeeded(tcls, good, curves=[c]) == {}
    test_harness.prover_failed(tcls, bad, curves=[c])


def test_engines_give_the_same_gadget_outputs():
    """Both big-int engines run the gadgets on plain ints: twisted Edwards
    double-and-add and the GLV ladder, the NAF and ternary digits, the
    transcript's challenges."""
    rng = np.random.default_rng(SEED)
    k = int.from_bytes(rng.bytes(32), "little")
    v = int(rng.integers(0, 3 ** 12))
    outs = []
    for P in (JAX, PORT):
        eng = P.engine.BigIntEngine(P.curves.BLS12_381)
        ed = P.te.EdCurve(eng, P.te.BANDERSNATCH)
        base = P.te.EdHost(P.te.BANDERSNATCH).scalar_mul(
            P.te.BANDERSNATCH.base, 3)
        bn = P.engine.BigIntEngine(P.curves.BN254)
        fs = P.fs.CircuitTranscript(bn, P.mimc.MiMC(bn), "x", "y")
        fs.bind("x", v, k)
        fs.bind("y", k)
        with pytest.raises(ValueError):
            fs.compute_challenge("y")
        x = fs.compute_challenge("x")
        outs.append((ed.scalar_mul_glv(base, k % P.te.BANDERSNATCH.order),
                     ed.scalar_mul(base, k % (1 << 64), nb_bits=64),
                     P.bits.to_naf(bn, k % (1 << 40), nb_digits=42),
                     P.bits.to_ternary(bn, v, nb_trits=12),
                     x, fs.compute_challenge("y")))
    assert outs[0] == outs[1]
    host = torch_te.EdHost(torch_te.BANDERSNATCH)
    base = host.scalar_mul(torch_te.BANDERSNATCH.base, 3)
    assert outs[1][0] == host.scalar_mul(base, k)
    assert outs[1][1] == host.scalar_mul(base, k % (1 << 64))


@pytest.mark.parametrize("curve", ["bn254", "bls12_377"])
def test_eddsa_keys_and_signatures_equal(curve):
    rng = np.random.default_rng(SEED)
    jc, tc = jax_curves.ALL_CURVES[curve], torch_curves.ALL_CURVES[curve]
    for _ in range(3):
        seed = rng.bytes(12)
        msg = int.from_bytes(rng.bytes(32), "little") % tc.fr.modulus
        jkp = jax_eddsa.KeyPair.generate(jc, seed)
        tkp = torch_eddsa.KeyPair.generate(tc, seed)
        assert (tkp.curve_name, tkp.secret, tkp.public) == \
            (jkp.curve_name, jkp.secret, jkp.public)
        jsig, tsig = jkp.sign(msg, jc), tkp.sign(msg, tc)
        assert (tsig.r, tsig.s) == (jsig.r, jsig.s)
        assert torch_eddsa.host_verify(tsig, msg, tkp.public, tc)
        assert not torch_eddsa.host_verify(tsig, msg + 1, tkp.public, tc)


def test_merkle_roots_and_proofs_equal():
    rng = np.random.default_rng(SEED)
    jc, tc = jax_curves.BN254, torch_curves.BN254
    for n in (1, 2, 8, 16):
        leaves = [int(v) for v in rng.integers(0, 1 << 62, n)]
        assert torch_merkle.build_tree(tc, leaves) == \
            jax_merkle.build_tree(jc, leaves)
        assert torch_merkle.build_tree(tc, leaves, hash_leaves=False) == \
            jax_merkle.build_tree(jc, leaves, hash_leaves=False)
        assert torch_merkle.root(tc, leaves) == jax_merkle.root(jc, leaves)
        for i in range(n):
            assert torch_merkle.prove(tc, leaves, i) == \
                jax_merkle.prove(jc, leaves, i)


@pytest.mark.parametrize("name", sorted(jax_te.BY_SNARK_CURVE) + ["bandersnatch"])
def test_twisted_edwards_parameters_equal(name):
    if name == "bandersnatch":
        got, want = torch_te.BANDERSNATCH, jax_te.BANDERSNATCH
    else:
        assert sorted(torch_te.BY_SNARK_CURVE) == sorted(jax_te.BY_SNARK_CURVE)
        got, want = torch_te.BY_SNARK_CURVE[name], jax_te.BY_SNARK_CURVE[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    torch_te.EdHost(got).validate()


def test_bandersnatch_glv_constants_and_decompositions_equal():
    J, T = jax_te, torch_te
    assert dataclasses.asdict(T.BANDERSNATCH_ENDO) == \
        dataclasses.asdict(J.BANDERSNATCH_ENDO)
    args = (T.BANDERSNATCH.order, T.BANDERSNATCH_ENDO.lam)
    assert T._glv_basis(*args) == J._glv_basis(*args)
    order, lam = args
    assert pow(lam, 2, order) == order - 2
    rng = np.random.default_rng(SEED)
    q = torch_curves.BLS12_381.fr.modulus
    failed = 0
    for s in [0, 1, order - 1, q - 1] + [
            int.from_bytes(rng.bytes(32), "little") % q for _ in range(20)]:
        # gnark_tpu's sign normalisation gives up on some scalars (about
        # one in fifteen below the order); the copy gives up on the same
        try:
            want = J.decompose_scalar_bandersnatch(q, [s], 3)
        except AssertionError:
            failed += 1
            with pytest.raises(AssertionError, match="GLV normalization"):
                T.decompose_scalar_bandersnatch(q, [s], 3)
            continue
        got = T.decompose_scalar_bandersnatch(q, [s], 3)
        assert got == want
        s1, s2, k = got
        assert lam * s2 - s1 == s % order + k * order
    assert failed == 1


def test_ternary_and_naf_hints_agree():
    rng = np.random.default_rng(SEED)
    q = torch_curves.BN254.fr.modulus
    for a in [0, 1, 2, 3, q - 1] + [
            int.from_bytes(rng.bytes(32), "little") % q for _ in range(20)]:
        for n_out in (12, q.bit_length() + 1):
            assert torch_bits.n_naf(q, [a], n_out) == \
                jax_bits.n_naf(q, [a], n_out)
        assert torch_bits.n_trits(q, [a], 161) == jax_bits.n_trits(q, [a], 161)


@pytest.mark.parametrize("hint", [(torch_bits, jax_bits, "n_trits"),
                                  (torch_bits, jax_bits, "n_naf"),
                                  (torch_te, jax_te,
                                   "decompose_scalar_bandersnatch")],
                         ids=lambda h: h[2])
def test_gadget_hint_uuids_agree(hint):
    tmod, jmod, name = hint
    torch_std.register_hints()
    jax_std.register_hints()
    fn, ref = getattr(tmod, name), getattr(jmod, name)
    uid = torch_hints.uuid_of(fn)
    assert uid == jax_hints.uuid_of(ref)
    assert torch_hints.get(uid) is fn and jax_hints.get(uid) is ref
    assert torch_hints.name_of(uid) == jax_hints.name_of(uid) == \
        f"{jmod.__name__}.{name}"


def test_register_hints_lacks_only_the_algebra_hints():
    """gnark_tpu registers two scalar decompositions of ``std/algebra``
    (the BLS12-377 and BLS24-315 recursion gadgets); the port has them
    too now, so it lacks none: every library hint is in both registries,
    those two among them."""
    def library(P, registered):
        return {P.hints.name_of(u) for u in registered
                if P.hints.name_of(u).startswith(("gnark_tpu.std.",
                                                  "gnark_tpu.backend."))}
    want = library(JAX, jax_std.register_hints())
    got = library(PORT, torch_std.register_hints())
    assert got == want
    assert {"gnark_tpu.std.algebra.sw_bls12377.decompose_scalar_bls12377",
            "gnark_tpu.std.algebra.sw_bls24315.decompose_scalar_bls24315"
            } <= got
