"""gnark_tpu_torch.backend.groth16 against gnark_tpu.backend.groth16.

Each package compiles the circuit with its own frontend and solves with
its own solver.  The same rng gives the same key and the same proof: the
port's setup equals the JAX package's setup(host=True) point for point,
and the port's prove on proving_key_from_jax(pk) equals the JAX package's
prove exactly and verifies under its verify.  The quotient of a 1-hash MiMC chain is
held against the JAX package's host chain.  (The full 58,741-constraint
MiMC prove runs on the card, in chip_smoke.py.)

Tolerance: none; points compare exactly as Python ints.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu.std.mimc as jax_mimc
import gnark_tpu_torch.frontend.schema as torch_schema
import gnark_tpu_torch.std.mimc as torch_mimc
from gnark_tpu.backend import groth16 as jg
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import groth16 as tg
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend.compile import compile_circuit

torch.set_num_threads(1)


def cubic_circuit(schema):
    """The circuit as a class of one frontend: each package has its own
    ``Circuit`` base class and hint registry."""
    class Cubic(schema.Circuit):
        x = schema.Secret()
        y = schema.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))
    return Cubic()


def mimc_one_circuit(schema, mimc):
    class MiMCOne(schema.Circuit):
        pre = schema.Secret()
        digest = schema.Public()

        def define(self, api):
            h = mimc.MiMC(api)
            h.write(self.pre)
            api.assert_is_equal(h.sum(), self.digest)
    return MiMCOne()


@pytest.fixture(scope="module")
def cubic():
    jcs = jax_compile(cubic_circuit(jax_schema), JBN254)
    cs = compile_circuit(cubic_circuit(torch_schema), BN254)
    jpk, jvk = jg.setup(jcs, JBN254, rng=random.Random(1), host=True)
    tpk, tvk = tg.setup(cs, BN254, rng=random.Random(1), device="cpu")
    return (jcs, cs), jpk, jvk, tpk, tvk


def _affine(G, planes):
    x, y, inf = planes
    xs, ys, infs = G.F.unpack(x), G.F.unpack(y), inf.tolist()
    return [None if infs[i] else (xs[i], ys[i]) for i in range(len(xs))]


@pytest.mark.parametrize("name", ["A", "B1", "K", "Z", "B2"])
def test_setup_key_points_equal_jax_host_setup(cubic, name):
    cs, jpk, jvk, tpk, tvk = cubic
    K = tg._Groups(BN254)
    G = K.g2 if name == "B2" else K.g1
    assert tpk.n_pad == jpk.n_pad and tpk.domain_n == jpk.domain_n
    assert _affine(G, getattr(tpk, name)) == getattr(jpk, name)


def test_setup_verifying_key_equals_jax(cubic):
    cs, jpk, jvk, tpk, tvk = cubic
    for f in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "K",
              "e_alpha_beta", "nb_public", "beta_g1", "delta_g1"):
        assert getattr(tvk, f) == getattr(jvk, f), f
    for f in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        assert getattr(tpk, f) == getattr(jpk, f), f


def test_prove_equals_jax_prove_and_verifies(cubic):
    (jcs, cs), jpk, jvk, tpk, tvk = cubic
    want = jg.prove(jcs, jpk, [35, 3], rng=random.Random(2))
    timings = {}
    got = tg.prove(cs, tg.proving_key_from_jax(jpk, "cpu"), [35, 3],
                   rng=random.Random(2), timings=timings)
    assert (got.ar, got.bs, got.krs) == (want.ar, want.bs, want.krs)
    assert set(timings) == {"solve", "compute_h", "msm_g1_A", "msm_g1_B1",
                            "msm_g2_B2", "msm_g1_K", "msm_g1_Z", "to_host",
                            "assembly"}
    assert jg.verify(jg.Proof(got.ar, got.bs, got.krs), jvk, [35])
    assert tg.verify(got, tvk, [35])
    assert not tg.verify(got, tvk, [36])


def test_proving_key_from_jax_reads_device_arrays(cubic):
    """A JAX key whose points are device arrays, handed over as numpy
    (uint32 limb planes and bool masks), becomes the same key."""
    cs, jpk, jvk, tpk, tvk = cubic
    names = ("A", "B1", "B2", "K", "Z")
    as_jax = {n: tuple(a.numpy().astype(np.uint32) if a.dtype == torch.int64
                       else a.numpy() for a in getattr(tpk, n))
              for n in names}
    got = tg.proving_key_from_jax(
        dataclasses.replace(jpk, host=False, **as_jax), "cpu")
    for n in names:
        assert all(torch.equal(a, b)
                   for a, b in zip(getattr(got, n), getattr(tpk, n))), n


def test_mimc_chain_quotient_matches_host_chain():
    """The 1-hash MiMC chain (domain 512): the port's solver's witness
    through the port's compute_h against gnark_tpu's host quotient chain
    over gnark_tpu's solver's witness."""
    from gnark_tpu.backend.groth16 import _host_ntt
    from gnark_tpu.backend.solver import solve
    from gnark_tpu_torch.backend.solver import solve as torch_solve
    from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm

    cs = jax_compile(mimc_one_circuit(jax_schema, jax_mimc), JBN254)
    tcs = compile_circuit(mimc_one_circuit(torch_schema, torch_mimc), BN254)
    pre = 12345
    h = jax_mimc.MiMCHost(JBN254)
    h.write(pre)
    sol = solve(cs, [h.sum(), pre])
    tsol = torch_solve(tcs, [h.sum(), pre])
    q, spec = BN254.fr.modulus, BN254.fr
    n = tg._next_pow2(cs.nb_constraints)
    assert n == 512
    omega, g = spec.root_of_unity(n), spec.multiplicative_generator % q

    def pad(v):
        return [x % q for x in v] + [0] * (n - len(v))

    def coset_evals(vals):
        coeffs = _host_ntt(pad(vals), omega, q, inverse=True)
        return _host_ntt([c * pow(g, i, q) % q for i, c in enumerate(coeffs)],
                         omega, q)

    ae, be, ce = (coset_evals(v) for v in (sol.a, sol.b, sol.c))
    den = pow(pow(g, n, q) - 1, -1, q)
    hh = _host_ntt([(a * b - c) % q * den % q for a, b, c in zip(ae, be, ce)],
                   omega, q, inverse=True)
    ginv = pow(g, -1, q)
    hh = [c * pow(ginv, i, q) % q for i, c in enumerate(hh)]
    want = [hh[i] for i in bit_reverse_perm(n)]
    assert want[-1] == 0                      # deg h <= n - 2

    d = Domain(spec, n, "cpu")
    F = d.F
    got = tg.compute_h(d, *(F.pack(pad(v), "cpu")
                            for v in (tsol.a, tsol.b, tsol.c)))
    assert F.unpack(got) == want
