"""gnark_tpu_torch stands without JAX, and never falls back from a kernel.

  * with ``jax`` blocked at import, the port's prover and MSM modules load
    and ``chip_smoke.py`` exits nonzero at once (no CUDA here), printing
    no result;
  * ``chip_smoke.py`` alone in a directory exits nonzero;
  * no source line of the port imports jax;
  * the kernel path given a non-CUDA tensor, or with no CUDA present,
    raises instead of running the plain version.
"""

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


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from) jax")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gnark_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f"{f}:{i + 1}" for f in files
                 for i, line in enumerate(open(f)) if pattern.match(line)]
    assert not offenders, offenders


def test_kernel_path_raises_instead_of_falling_back():
    from gnark_tpu.curves import BN254
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
