"""Native (C++) runtime components, loaded via ctypes.

Build-on-demand: the shared library compiles once with g++ into
``_build/`` and is reused across processes (mtime-checked against the
source).  No pybind11 — plain C ABI + ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")


def _ensure_lib(name: str, sources: list) -> str:
    """Compile sources into _build/lib<name>.so if stale; return its path.
    Raises when g++ is missing or fails: the provers' host passes run in
    this library and have no other route."""
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(_BUILD, f"lib{name}.so")
    srcs = [os.path.join(_DIR, s) for s in sources]
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs):
        return out
    # built under a name of this process's own, then renamed: several
    # processes (test workers) may build at once, none loads a partial file
    tmp = f"{out}.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp] + [s for s in srcs if s.endswith(".cpp")]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native core: cannot run g++: {e}") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native core: g++ failed ({e.returncode}):\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


_solver_lib = None


def solver_lib():
    """ctypes handle to the solver core, built at first use; raises when
    it cannot be built."""
    global _solver_lib
    if _solver_lib is not None:
        return _solver_lib
    path = _ensure_lib("gnark_solver", ["solver_core.cpp", "msm_core.cpp", "field_common.h"])
    lib = ctypes.CDLL(path)
    for fn in ("gnark_solve_r1cs", "gnark_solve_scs", "gnark_qap_accumulate",
               "gnark_lincomb3", "gnark_powers", "gnark_vecmul",
               "gnark_batch_inv", "gnark_solve_scs", "gnark_vecadd",
               "gnark_prefix_mul", "gnark_synth_div", "gnark_msm", "gnark_fixed_base"):
        getattr(lib, fn).restype = ctypes.c_int64
    _solver_lib = lib
    return lib
