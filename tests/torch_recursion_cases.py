"""What test_torch_recursion.py (BLS12-377 inside BW6-761) and
test_torch_recursion_bls24.py (BLS24-315 inside BW6-633) share: the
inner proof, the verifier circuit as a function of a package, its
witness, and the build of both packages' verifier systems.

A package here is a namespace of one side's modules (``PORT``,
``JAX``): its frontend schema, compiler, curves, groth16 backend, cs_io,
solver, big-int engine and the in-circuit verifier of each inner curve.
"""

import hashlib
import random
import types

import gnark_tpu.backend.cs_io as jax_cs_io
import gnark_tpu.backend.groth16 as jax_groth16
import gnark_tpu.backend.solver as jax_solver
import gnark_tpu.curves as jax_curves
import gnark_tpu.frontend.compile as jax_compile
import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu.std.groth16_bls12377 as jax_v12
import gnark_tpu.std.groth16_bls24315 as jax_v24
import gnark_tpu.test_engine as jax_engine
import gnark_tpu_torch.backend.cs_io as torch_cs_io
import gnark_tpu_torch.backend.groth16 as torch_groth16
import gnark_tpu_torch.backend.solver as torch_solver
import gnark_tpu_torch.curves as torch_curves
import gnark_tpu_torch.frontend.compile as torch_compile
import gnark_tpu_torch.frontend.schema as torch_schema
import gnark_tpu_torch.std.groth16_bls12377 as torch_v12
import gnark_tpu_torch.std.groth16_bls24315 as torch_v24
import gnark_tpu_torch.test_engine as torch_engine
from test_torch_plonk import cubic_circuit


def _package(schema, compile_mod, curves, groth16, cs_io, solver, engine,
             v12, v24):
    return types.SimpleNamespace(
        schema=schema, compile=compile_mod.compile_circuit, curves=curves,
        groth16=groth16, cs_io=cs_io, solver=solver, engine=engine,
        verifier={"bls12_377": v12, "bls24_315": v24})


PORT = _package(torch_schema, torch_compile, torch_curves, torch_groth16,
                torch_cs_io, torch_solver, torch_engine, torch_v12, torch_v24)
JAX = _package(jax_schema, jax_compile, jax_curves, jax_groth16, jax_cs_io,
               jax_solver, jax_engine, jax_v12, jax_v24)

OUTER = {"bls12_377": "bw6_761", "bls24_315": "bw6_633"}
# the outer key's domain (and n_pad) of each verifier
OUTER_DOMAIN = {"bls12_377": 1 << 17, "bls24_315": 1 << 18}


def inner_proof(inner):
    """gnark_tpu's host-mode cubic proof over ``inner`` (the reference's
    own test fixture: rng 9), with its verifying key."""
    curve = jax_curves.ALL_CURVES[inner]
    cs = jax_compile.compile_circuit(cubic_circuit(jax_schema), curve)
    rng = random.Random(9)
    pk, vk = jax_groth16.setup(cs, curve, rng=rng, host=True)
    proof = jax_groth16.prove(cs, pk, [35, 3], rng=rng)
    assert jax_groth16.verify(proof, vk, [35])
    return vk, proof


def vk_for(P, vk):
    """A verifying key as package ``P``'s dataclass over its own curve."""
    return P.groth16.VerifyingKey(
        curve=P.curves.ALL_CURVES[vk.curve.name],
        **{f: getattr(vk, f) for f in (
            "alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "K",
            "e_alpha_beta", "nb_public", "beta_g1", "delta_g1")})


def recursion_circuit(P, vk):
    """The reference tests' RecursionCircuit (tests/test_recursion.py and
    tests/test_recursion_bls24.py) over package ``P``, verifying proofs
    of ``vk``: the same signals in the same order."""
    schema, inner = P.schema, vk.curve.name
    verifier = P.verifier[inner]
    vk = vk_for(P, vk)
    if inner == "bls12_377":
        class RecursionCircuit(schema.Circuit):
            inner_y = schema.Public()
            ar_x = schema.Secret(); ar_y = schema.Secret()      # noqa: E702
            krs_x = schema.Secret(); krs_y = schema.Secret()    # noqa: E702
            bs_x0 = schema.Secret(); bs_x1 = schema.Secret()    # noqa: E702
            bs_y0 = schema.Secret(); bs_y1 = schema.Secret()    # noqa: E702

            def define(self, api):
                verifier.verify_proof(
                    api, vk, (self.ar_x, self.ar_y),
                    ((self.bs_x0, self.bs_x1), (self.bs_y0, self.bs_y1)),
                    (self.krs_x, self.krs_y), [self.inner_y])
    else:
        class RecursionCircuit(schema.Circuit):
            inner_y = schema.Public()
            ar_x = schema.Secret(); ar_y = schema.Secret()      # noqa: E702
            krs_x = schema.Secret(); krs_y = schema.Secret()    # noqa: E702
            bs_x = schema.Secret(shape=(4,))
            bs_y = schema.Secret(shape=(4,))

            def define(self, api):
                verifier.verify_proof(
                    api, vk, (self.ar_x, self.ar_y),
                    (tuple(self.bs_x), tuple(self.bs_y)),
                    (self.krs_x, self.krs_y), [self.inner_y])
    return RecursionCircuit


def assignment(cls, proof, public_value):
    """An instance of a RecursionCircuit class holding ``proof``."""
    a = cls()
    a.inner_y = public_value
    a.ar_x, a.ar_y = proof.ar
    a.krs_x, a.krs_y = proof.krs
    if hasattr(cls, "bs_x0"):
        (a.bs_x0, a.bs_x1), (a.bs_y0, a.bs_y1) = proof.bs
    else:
        a.bs_x, a.bs_y = list(proof.bs[0]), list(proof.bs[1])
    return a


def witness(P, cls, proof, public_value):
    """[public | secret] values of the verifier circuit for ``proof``."""
    a = assignment(cls, proof, public_value)
    return (P.schema.collect_values(a, "public")
            + P.schema.collect_values(a, "secret"))


def verifier_systems(inner):
    """Both packages' verifier systems for gnark_tpu's inner proof over
    ``inner``: the port's circuit class and system, the SHA-256 of each
    package's ``cs_io`` bytes (hundreds of MB for a verifier system:
    gnark_tpu's system is dropped once hashed, so that two are never held
    at once), and the inner (vk, proof)."""
    vk, proof = inner_proof(inner)
    digests = {}
    for side, P in (("jax", JAX), ("port", PORT)):
        cls = recursion_circuit(P, vk)
        cs = P.compile(cls(), P.curves.ALL_CURVES[OUTER[inner]])
        digests[side] = hashlib.sha256(P.cs_io.cs_to_bytes(cs)).digest()
        if P is JAX:
            del cs
    return cls, cs, digests, vk, proof


def assert_outer_proofs_equal(systems, reference_host=False):
    """The outer Groth16 proof of the verifier over gnark_tpu's inner
    proof, made by each package as the reference's
    ``test_outer_proof_end_to_end`` makes it: setup over the outer curve
    with rng 11, prove with rng 12, verify the public input 35, reject 36.
    The port's goes through its device entry points with the CPU as the
    device (the native route: key points and MSMs on the native core, the
    quotient's NTTs on the device); gnark_tpu's from its own compile of
    the same circuit, on its default device (the JAX CPU), or with
    ``reference_host`` in its host mode (the quotient on host ints; the
    same rng draws, so the same key and proof).  The two verifying keys
    and the two proofs are equal."""
    cls, cs, _, vk_in, proof_in = systems
    inner = vk_in.curve.name
    outer = OUTER[inner]
    curve = PORT.curves.ALL_CURVES[outer]
    pk, vk = PORT.groth16.setup(cs, curve, rng=random.Random(11),
                                device="cpu")
    assert PORT.groth16.native_route(curve) and not pk.host
    assert pk.domain_n == pk.n_pad == OUTER_DOMAIN[inner]
    proof = PORT.groth16.prove(cs, pk, witness(PORT, cls, proof_in, 35),
                               rng=random.Random(12))
    assert PORT.groth16.verify(proof, vk, [35])
    assert not PORT.groth16.verify(proof, vk, [36])
    del pk

    jcls = recursion_circuit(JAX, vk_in)
    jcs = JAX.compile(jcls(), JAX.curves.ALL_CURVES[outer])
    jpk, jvk = JAX.groth16.setup(jcs, JAX.curves.ALL_CURVES[outer],
                                 rng=random.Random(11), host=reference_host)
    jproof = JAX.groth16.prove(jcs, jpk, witness(JAX, jcls, proof_in, 35),
                               rng=random.Random(12))
    assert JAX.groth16.verify(jproof, jvk, [35])
    assert not JAX.groth16.verify(jproof, jvk, [36])
    for f in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "K",
              "e_alpha_beta"):
        assert getattr(vk, f) == getattr(jvk, f), f
    assert (proof.ar, proof.bs, proof.krs) == \
        (jproof.ar, jproof.bs, jproof.krs)
