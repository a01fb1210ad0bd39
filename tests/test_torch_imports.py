"""gnark_tpu_torch stands alone, without JAX and without gnark_tpu, and
never falls back from a kernel.

  * with ``jax`` blocked at import, the port's prover and MSM modules load
    and ``chip_smoke.py`` exits nonzero at once (no CUDA here), printing
    no result;
  * with ``jax`` and ``gnark_tpu`` both refused by a meta-path finder, every
    module of the port imports, and a circuit compiles, proves and
    verifies under Groth16 and under PLONK on the CPU; the gadget library,
    the engine and harness, the scheme dispatch and the examples import
    by name, and the rollup compiles and solves; so do the serialization
    and recursion modules, a key through a file and the serialization
    example; so do the mesh, fuzz and stats modules;
  * ``chip_smoke.py`` alone in a directory exits nonzero;
  * no source line of the port imports jax or gnark_tpu;
  * the kernel path given a non-CUDA tensor, or with no CUDA present,
    raises instead of running the plain version.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_JAX = "import sys; sys.modules['jax'] = None; "


def _run(code, cwd=REPO, timeout=120, **extra_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "GNARK_TPU_NO_COMPILE_CACHE")}
    env["PYTHONPATH"] = REPO
    env.update(extra_env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax():
    res = _run(BLOCK_JAX + (
        "import gnark_tpu_torch.backend.groth16, gnark_tpu_torch.ops.msm, "
        "gnark_tpu_torch.ops.fixed_base; "
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m] "
        "or m.startswith('jax.')]; "
        "assert not bad, bad; print('ok')"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_fast_without_cuda():
    # hide any card, so that the check holds on a host that has one
    res = _run(BLOCK_JAX + "import runpy; "
               "runpy.run_path('chip_smoke.py', run_name='__main__')",
               timeout=60, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "CUDA is not available" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


REFUSE_BOTH = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gnark_tpu"):
            raise ImportError(f"refused: {name}")

sys.meta_path.insert(0, Refuse())
"""

STANDALONE_PROVE = REFUSE_BOTH + """
import importlib, pkgutil, random
import gnark_tpu_torch

names = [m.name for m in pkgutil.walk_packages(gnark_tpu_torch.__path__,
                                               "gnark_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) > 30, names

from gnark_tpu_torch.backend import groth16, plonk
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.frontend import Circuit, Public, Secret, compile_circuit

class Cubic(Circuit):
    x = Secret()
    y = Public()

    def define(self, api):
        x3 = api.mul(self.x, self.x, self.x)
        api.assert_is_equal(self.y, api.add(x3, self.x, 5))

cs = compile_circuit(Cubic(), BN254)
pk, vk = groth16.setup(cs, BN254, rng=random.Random(1), device="cpu")
proof = groth16.prove(cs, pk, [35, 3], rng=random.Random(2))
assert groth16.verify(proof, vk, [35]) and not groth16.verify(proof, vk, [36])

scs = compile_circuit(Cubic(), BN254, scheme="plonk")
ppk, pvk = plonk.setup(scs, BN254, rng=random.Random(1), host=True)
pproof = plonk.prove(scs, ppk, [35, 3], rng=random.Random(2))
assert plonk.verify(pproof, pvk, [35]) and not plonk.verify(pproof, pvk, [36])

bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
assert not bad, bad
print("ok", len(names))
"""


def test_port_proves_with_jax_and_gnark_tpu_refused():
    res = _run(STANDALONE_PROVE, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[0] == "ok"


GADGETS_AND_EXAMPLES = REFUSE_BOTH + """
import importlib
mods = ["gnark_tpu_torch.std", "gnark_tpu_torch.std.bits",
        "gnark_tpu_torch.std.twisted_edwards", "gnark_tpu_torch.std.eddsa",
        "gnark_tpu_torch.std.merkle", "gnark_tpu_torch.std.fiat_shamir",
        "gnark_tpu_torch.test_engine", "gnark_tpu_torch.test_harness",
        "gnark_tpu_torch.backend", "gnark_tpu_torch.examples",
        "gnark_tpu_torch.examples.cubic",
        "gnark_tpu_torch.examples.exponentiate",
        "gnark_tpu_torch.examples.mimc", "gnark_tpu_torch.examples.plonk_main",
        "gnark_tpu_torch.examples.rollup"]
for name in mods:
    importlib.import_module(name)

from gnark_tpu_torch import backend, std, test_harness
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.examples import rollup
from gnark_tpu_torch.frontend import compile_circuit, schema

assert len(std.register_hints()) >= 7
w = rollup.seeded_operator(BN254).transfer(0, 1, 100)
test_harness.prover_succeeded(rollup.RollupCircuit, w, schemes=["groth16"])
cs = compile_circuit(rollup.RollupCircuit(), BN254, scheme="plonk")
backend.solve(cs, schema.collect_values(w))
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
assert not bad, bad
print("ok", cs.nb_constraints)
"""


def test_gadgets_harness_and_examples_run_with_jax_and_gnark_tpu_refused():
    """The gadget library, the engine and harness, the scheme dispatch and
    the examples import and compile and solve the rollup with ``jax`` and
    ``gnark_tpu`` refused."""
    res = _run(GADGETS_AND_EXAMPLES, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok", "38790"]


SERIALIZATION_AND_RECURSION = REFUSE_BOTH + """
import importlib, io, random
mods = ["gnark_tpu_torch.utils.profiling",
        "gnark_tpu_torch.backend.serialize", "gnark_tpu_torch.backend.key_io",
        "gnark_tpu_torch.backend.cs_io", "gnark_tpu_torch.backend.solidity",
        "gnark_tpu_torch.examples.serialization_main",
        "gnark_tpu_torch.std.algebra",
        "gnark_tpu_torch.std.algebra.fields_bls12377",
        "gnark_tpu_torch.std.algebra.sw_bls12377",
        "gnark_tpu_torch.std.algebra.fields_bls24315",
        "gnark_tpu_torch.std.algebra.sw_bls24315",
        "gnark_tpu_torch.std.groth16_bls12377",
        "gnark_tpu_torch.std.groth16_bls24315"]
for name in mods:
    importlib.import_module(name)

from gnark_tpu_torch import std
from gnark_tpu_torch.backend import cs_io, groth16, key_io, solver
from gnark_tpu_torch.curves import BLS12_381
from gnark_tpu_torch.examples import serialization_main
from gnark_tpu_torch.examples.cubic import CubicCircuit
from gnark_tpu_torch.frontend import compile_circuit

assert len(std.register_hints()) >= 9
cs = cs_io.cs_from_bytes(cs_io.cs_to_bytes(
    compile_circuit(CubicCircuit(), BLS12_381)))
pk, vk = groth16.setup(cs, BLS12_381, rng=random.Random(1), device="cpu")
buf = io.BytesIO()
key_io.groth16_pk_write(pk, buf)
buf.seek(0)
pk2 = key_io.groth16_pk_read(buf, safe=True, device="cpu")
proof = groth16.prove(cs, pk2, [35, 3], rng=random.Random(2))
assert groth16.verify(proof, vk, [35]) and not groth16.verify(proof, vk, [36])
serialization_main.main(device="cpu")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
assert not bad, bad
print("ok", len(mods))
"""


def test_serialization_and_recursion_modules_run_with_jax_and_gnark_tpu_refused():
    """The thirteen modules of the serialization and recursion slice import
    by name with ``jax`` and ``gnark_tpu`` refused; a native-route key goes
    through a file and proves, a system through cs_io, and the
    serialization example runs on the CPU."""
    res = _run(SERIALIZATION_AND_RECURSION, timeout=300,
               OMP_NUM_THREADS="1")
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-2:] == ["ok", "13"]


MESH_FUZZ_STATS = REFUSE_BOTH + """
import importlib, json
mods = ["gnark_tpu_torch.fuzz", "gnark_tpu_torch.stats",
        "gnark_tpu_torch.parallel", "gnark_tpu_torch.parallel.multihost",
        "gnark_tpu_torch.parallel.ranks",
        "gnark_tpu_torch.parallel.sharded_msm",
        "gnark_tpu_torch.parallel.sharded_ntt"]
for name in mods:
    importlib.import_module(name)

from gnark_tpu_torch import fuzz, stats
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.examples.cubic import CubicCircuit

assert sum(fuzz.fuzz(CubicCircuit, BN254, iterations=4, seed=1)) == 4
counts = stats.snippet_stats(BN254, "groth16")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
assert not bad, bad
print("ok", len(mods), json.dumps(counts))
"""


def test_mesh_fuzz_and_stats_modules_run_with_jax_and_gnark_tpu_refused():
    """The seven modules of the mesh, fuzz and stats slice import by name
    with ``jax`` and ``gnark_tpu`` refused; the fuzzer and the snippet
    counts run."""
    res = _run(MESH_FUZZ_STATS, timeout=300, OMP_NUM_THREADS="1")
    assert res.returncode == 0, res.stderr
    ok, n, counts = res.stdout.strip().splitlines()[-1].split(" ", 2)
    assert (ok, n) == ("ok", "7")
    with open(os.path.join(REPO, "tests", "stats_golden.json")) as f:
        assert json.loads(counts) == json.load(f)["bn254/groth16"]


def test_refusing_finder_refuses():
    res = _run(REFUSE_BOTH + "import gnark_tpu.fields")
    assert res.returncode != 0 and "refused: gnark_tpu" in res.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|gnark_tpu)(\.|\s|$)")
    assert pattern.match("from gnark_tpu.curves import BN254")
    assert pattern.match("    import jax.numpy as jnp")
    assert not pattern.match("from gnark_tpu_torch.curves import BN254")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gnark_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f"{f}:{i + 1}" for f in files
                 for i, line in enumerate(open(f)) if pattern.match(line)]
    assert not offenders, offenders


def test_kernel_path_raises_instead_of_falling_back():
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops.ec_complete import CompleteOps
    from gnark_tpu_torch.ops.limbs import field_ops

    GC = CompleteOps(field_ops(BN254.fp), BN254.b)
    sx = torch.zeros(2, 1, 16, 4, dtype=torch.int64)
    # a CUDA launch needs CUDA tensors and a CUDA runtime; neither is here
    with pytest.raises(ValueError):
        _cuda.leaf_prefix(sx, sx, "g1")
    with pytest.raises(ValueError):
        _cuda.ladder(sx[0, 0], sx[0, 0], torch.zeros(4, dtype=torch.bool),
                     sx[0, 0], "g1")
    with pytest.raises(RuntimeError):
        _cuda.load()
    # a device with no kernel and no plain version
    with pytest.raises(ValueError):
        M.leaf_prefix(sx.to("meta"), sx.to("meta"), GC)
    # the kernels are built for BN254 G1 / G2 only
    with pytest.raises(NotImplementedError):
        _cuda.kind_of(CompleteOps(field_ops(BN254.fr), 5))
    assert _cuda.kind_of(GC) == "g1"
    assert not any(_cuda.launches.values())
    # device tables for a CUDA device are not built on the CPU instead
    from gnark_tpu_torch.ops.ntt import Domain
    with pytest.raises((RuntimeError, AssertionError)):
        Domain(BN254.fr, 8, "cuda").table("tw")
