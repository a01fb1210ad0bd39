"""gnark_tpu_torch.backend.cs_io against gnark_tpu's.

  * the same circuit compiled by both packages serializes to the same
    bytes: the cubic (R1CS and SCS), a seeded MiMC chain (R1CS and SCS),
    a gadget circuit that calls hints (their uuids travel in the bytes);
  * a system saved by one package, to bytes or to a file, loads in the
    other, serializes back to the same bytes and solves to the witness of
    the original.

Inputs come from a numpy seed.  Tolerance: none; bytes and field elements
compare exactly.
"""

import numpy as np
import pytest

import gnark_tpu.frontend.schema as jax_schema
import gnark_tpu.std.bits as jax_bits
import gnark_tpu.std.mimc as jax_mimc
import gnark_tpu_torch.frontend.schema as torch_schema
import gnark_tpu_torch.std.bits as torch_bits
import gnark_tpu_torch.std.mimc as torch_mimc
from gnark_tpu.backend import cs_io as jax_cs_io
from gnark_tpu.backend import scs_solver as jax_scs_solver
from gnark_tpu.backend import solver as jax_solver
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu.frontend.compile import compile_circuit as jax_compile
from gnark_tpu_torch.backend import cs_io
from gnark_tpu_torch.backend import scs_solver, solver
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend.compile import compile_circuit
from test_torch_plonk import cubic_circuit

SEED = 5
N_HASHES = 3


def mimc_chain(schema, mimc):
    class MiMCChain(schema.Circuit):
        pre = schema.Secret()
        digest = schema.Public()

        def define(self, api):
            acc = self.pre
            for _ in range(N_HASHES):
                h = mimc.MiMC(api)
                h.write(acc)
                acc = h.sum()
            api.assert_is_equal(acc, self.digest)
    return MiMCChain()


def naf_circuit(schema, bits):
    class Naf(schema.Circuit):
        v = schema.Secret()
        y = schema.Public()

        def define(self, api):
            digits = bits.to_naf(api, self.v, 16)
            acc = 0
            for i, d in enumerate(digits):
                acc = api.add(acc, api.mul(d, 1 << i))
            api.assert_is_equal(acc, self.y)
    return Naf()


def _case(name):
    """-> (gnark_tpu circuit, port circuit, witness [public | secret])."""
    rng = np.random.default_rng(SEED)
    if name == "cubic":
        return cubic_circuit(jax_schema), cubic_circuit(torch_schema), [35, 3]
    if name == "mimc":
        pre = int(rng.integers(1, 1 << 62))
        acc = pre
        for _ in range(N_HASHES):
            acc = jax_mimc.mimc_hash(JBN254, acc)
        return (mimc_chain(jax_schema, jax_mimc),
                mimc_chain(torch_schema, torch_mimc), [acc, pre])
    v = int(rng.integers(1, 1 << 15))
    return naf_circuit(jax_schema, jax_bits), naf_circuit(torch_schema,
                                                          torch_bits), [v, v]


CASES = [(name, scheme) for name in ("cubic", "mimc", "naf")
         for scheme in ("groth16", "plonk")]


def _systems(name, scheme):
    jc, tc, w = _case(name)
    return (jax_compile(jc, JBN254, scheme=scheme),
            compile_circuit(tc, BN254, scheme=scheme), w)


@pytest.mark.parametrize("name, scheme", CASES)
def test_both_packages_give_the_same_bytes(name, scheme):
    jcs, cs, w = _systems(name, scheme)
    data = cs_io.cs_to_bytes(cs)
    assert data == jax_cs_io.cs_to_bytes(jcs)
    assert cs_io.cs_to_bytes(cs_io.cs_from_bytes(data)) == data
    if name == "naf":
        assert cs.hints and all(h.uuid for h in cs.hints)


@pytest.mark.parametrize("name, scheme", CASES)
def test_saved_by_one_package_solves_in_the_other(name, scheme, tmp_path):
    jcs, cs, w = _systems(name, scheme)
    solve = solver.solve if scheme == "groth16" else scs_solver.solve
    jsolve = jax_solver.solve if scheme == "groth16" else jax_scs_solver.solve
    want = jsolve(jcs, w)

    # the port's file, read by gnark_tpu
    path = str(tmp_path / "port.cs")
    cs_io.save_cs(cs, path)
    jcs2 = jax_cs_io.load_cs(path)
    assert jax_cs_io.cs_to_bytes(jcs2) == cs_io.cs_to_bytes(cs)
    assert jsolve(jcs2, w).values == want.values

    # gnark_tpu's bytes, read by the port
    cs2 = cs_io.cs_from_bytes(jax_cs_io.cs_to_bytes(jcs))
    assert type(cs2) is type(cs)
    assert cs_io.cs_to_bytes(cs2) == jax_cs_io.cs_to_bytes(jcs)
    assert solve(cs2, w).values == want.values
    bad = [w[0] + 1] + w[1:]
    with pytest.raises(Exception):
        solve(cs2, bad)
