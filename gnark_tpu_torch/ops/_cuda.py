"""Build and bind the CUDA MSM kernels (csrc/msm_kernels.cu).

On first use, nvcc compiles the sources in this checkout into a shared
library with a plain C interface under ``gnark_tpu_torch/_build/`` (the
file name carries a hash of the sources, so an edit rebuilds), and ctypes
loads it.  No torch headers are compiled in.  Every launcher returns
``cudaGetLastError()``; a nonzero code raises.

``launches`` counts kernel launches by name (``leaf_prefix_g1``, ...);
only the wrappers here add to it, where they launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_SOURCES = ("field.cuh", "ec_complete.cuh", "ec.cuh", "msm_kernels.cu")

WINDOW_KERNELS = ("leaf_prefix", "lane_offsets", "weighted_sum", "horner_fold")
KERNELS = WINDOW_KERNELS + ("ladder", "reduce")
REDUCE_LANES = 256       # msm_kernels.cu's reduce_kernel
KINDS = ("g1", "g2")
_L16 = {"g1": 16, "g2": 32}     # 16-bit limb planes of one coordinate

launches = {f"{k}_{kind}": 0 for k in KERNELS for kind in KINDS}
build_info = {}          # seconds, command, ptxas report of the last build
_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def load():
    """Build (once per source version) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the MSM kernels need a GPU")
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD, f"libgnark_msm_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, "msm_kernels.cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        build_info.update(seconds=time.perf_counter() - t0,
                          command=" ".join(cmd), ptxas=res.stderr)
    else:
        build_info.update(seconds=0.0, command="(cached)", ptxas="")
    lib = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for kind in KINDS:
        for name, args in (
                ("leaf_prefix", [vp, vp, vp, ci, ci, ci, vp]),
                ("lane_offsets", [vp, vp, vp, ci, ci, vp]),
                ("weighted_sum", [vp, vp, vp, ci, ci, vp]),
                ("horner_fold", [vp, vp, ci, ci, vp]),
                ("ladder", [vp, vp, vp, vp, vp, ci, ci, vp]),
                ("reduce", [vp, vp, vp, ci, vp]),
                ("point_bytes", [])):
            fn = getattr(lib, f"gnark_msm_{name}_{kind}")
            fn.argtypes = args
            fn.restype = ci
    _lib = lib
    return lib


def kind_of(GC) -> str:
    """'g1' or 'g2' for the BN254 groups the kernels are built for."""
    from gnark_tpu.curves import BN254
    F = GC.F
    if hasattr(F, "base"):
        if F.base.spec == BN254.fp and F.beta == BN254.fp2_beta \
                and tuple(GC.b) == tuple(BN254.b2):
            return "g2"
    elif F.spec == BN254.fp and GC.b == BN254.b:
        return "g1"
    raise NotImplementedError("the MSM kernels are built for BN254 G1/G2 only")


def _check(t: torch.Tensor, shape, name):
    if not (t.is_cuda and t.dtype == torch.int64 and t.is_contiguous()):
        raise ValueError(f"{name}: want a contiguous int64 CUDA tensor, got "
                         f"{t.dtype} on {t.device}, contiguous="
                         f"{t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _launch(name, kind, *args):
    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"gnark_msm_{name}_{kind}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_{kind}: launch failed, cudaError {rc}")
    launches[f"{name}_{kind}"] += 1


def _point_bytes(kind) -> int:
    return getattr(load(), f"gnark_msm_point_bytes_{kind}")()


def leaf_prefix(sx, sy, kind):
    nw, C, _, R = sx.shape
    L = _L16[kind]
    _check(sx, (nw, C, L, R), "sx")
    _check(sy, (nw, C, L, R), "sy")
    rows = torch.empty((nw, C * R, 3 * L), dtype=torch.int64,
                       device=sx.device)
    _launch("leaf_prefix", kind, sx.data_ptr(), sy.data_ptr(),
            rows.data_ptr(), nw, C, R)
    return rows


def _scratch(points, kind, device):
    nbytes = points * _point_bytes(kind)
    return torch.empty((nbytes + 3) // 4, dtype=torch.int32, device=device)


def lane_offsets(tot, kind):
    _, nw, R = tot.shape
    _check(tot, (3 * _L16[kind], nw, R), "totals")
    out = torch.empty_like(tot)
    scratch = _scratch(2 * nw * R, kind, tot.device)
    _launch("lane_offsets", kind, tot.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), nw, R)
    return out


def weighted_sum(bk, kind):
    _, nw, nb = bk.shape
    L3 = 3 * _L16[kind]
    _check(bk, (L3, nw, nb), "buckets")
    if nb & (nb - 1):
        raise ValueError(f"bucket count {nb} is not a power of two")
    out = torch.empty((L3, nw), dtype=torch.int64, device=bk.device)
    scratch = _scratch(nw * (nb + nb // 2 + 1), kind, bk.device)
    _launch("weighted_sum", kind, bk.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), nw, nb)
    return out


def horner_fold(S, c, kind):
    nw = S.shape[1]
    L3 = 3 * _L16[kind]
    _check(S, (L3, nw), "window sums")
    out = torch.empty((L3, 1), dtype=torch.int64, device=S.device)
    _launch("horner_fold", kind, S.data_ptr(), out.data_ptr(), nw, c)
    return out


def ladder(xs, ys, inf, sc, kind):
    L, n = xs.shape
    _check(xs, (_L16[kind], n), "xs")
    _check(ys, (_L16[kind], n), "ys")
    _check(sc, (sc.shape[0], n), "scalars")
    if not (inf.is_cuda and inf.dtype == torch.bool and inf.is_contiguous()
            and tuple(inf.shape) == (n,)):
        raise ValueError(f"inf: want a contiguous bool CUDA tensor of shape "
                         f"({n},), got {inf.dtype} {tuple(inf.shape)} on "
                         f"{inf.device}")
    out = torch.empty((3 * L, n), dtype=torch.int64, device=xs.device)
    _launch("ladder", kind, xs.data_ptr(), ys.data_ptr(), inf.data_ptr(),
            sc.data_ptr(), out.data_ptr(), n, sc.shape[0])
    return out


def reduce(pts, kind):
    L3, n = pts.shape
    _check(pts, (3 * _L16[kind], n), "points")
    out = torch.empty((L3, 1), dtype=torch.int64, device=pts.device)
    scratch = _scratch(REDUCE_LANES, kind, pts.device)
    _launch("reduce", kind, pts.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n)
    return out
