"""Build and bind the CUDA kernels (csrc/msm_kernels.cu, csrc/microbench.cu).

On first use, nvcc compiles a library's sources in this checkout into a
shared library with a plain C interface under ``gnark_tpu_torch/_build/``
(the file name carries a hash of the sources, so an edit rebuilds), and
ctypes loads it.  The two libraries are separate translation units, so
that the short microbenchmark build does not wait for the MSM kernels';
``build_all`` runs both compilers at once.  No torch headers are
compiled in.  Every launcher returns ``cudaGetLastError()``; a nonzero
code raises.

``launches`` counts kernel launches by name (``leaf_prefix_g1``, ...,
``microbench_mul_u32``, ...); only the wrappers here add to it, where they
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
# library -> the sources its hash covers; the last one is compiled
_SOURCES = {
    "msm": ("field.cuh", "ec_complete.cuh", "msm_kernels.cu"),
    "microbench": ("field.cuh", "microbench.cu"),
}

WINDOW_KERNELS = ("leaf_prefix", "lane_offsets", "weighted_sum", "horner_fold")
KERNELS = WINDOW_KERNELS + ("ladder", "reduce")
REDUCE_LANES = 256       # msm_kernels.cu's reduce_kernel
LEAF_GROUP = {"g1": 4, "g2": 4}   # and G1/G2::LEAF_GROUP: threads a leaf chain
# and G1/G2::WSUM_GROUP, WSUM_THREADS, WSUM_CLUSTER: threads a
# weighted-sum operation, threads a block, blocks a window
WSUM_GROUP = {"g1": 4, "g2": 8}
WSUM_THREADS = {"g1": 256, "g2": 256}
WSUM_CLUSTER = {"g1": 4, "g2": 4}
LADDER_CHUNKS = 16       # and its ladder_kernel: chunks a scalar,
LADDER_WINDOW = 4        # bits a window
KINDS = ("g1", "g2")
_L16 = {"g1": 16, "g2": 32}     # 16-bit limb planes of one coordinate
# microbench.cu's enum Op, in order; then the two kernels of their own
MICROBENCH_U32_OPS = ("mul_u32", "mul16_u32", "add_u32", "mad_wide_u32",
                      "mad_lo_hi_u32")
MICROBENCH_OPS = MICROBENCH_U32_OPS + ("fma_f32", "montmul_bn254")

launches = {f"{k}_{kind}": 0 for k in KERNELS for kind in KINDS}
launches.update({f"microbench_{op}": 0 for op in MICROBENCH_OPS})
build_info = {}          # library -> seconds, command, ptxas report, path
_libs = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _load(name):
    """Build (once per source version) and load one kernel library."""
    if name in _libs:
        return _libs[name]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the kernels need a GPU")
    h = hashlib.sha256()
    for src in _SOURCES[name]:
        with open(os.path.join(_CSRC, src), "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD, f"libgnark_{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        build_info[name] = dict(seconds=0.0, command="(cached)", ptxas="",
                                path=out)
    else:
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, _SOURCES[name][-1])]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        build_info[name] = dict(seconds=time.perf_counter() - t0,
                                command=" ".join(cmd),
                                ptxas=res.stdout + res.stderr, path=out)
    lib = ctypes.CDLL(out)
    _BIND[name](lib)
    _libs[name] = lib
    return lib


def build_all():
    """Build and load every library: one nvcc for each, all started
    together, each in a thread that waits for its own."""
    with ThreadPoolExecutor(len(_SOURCES)) as pool:
        list(pool.map(_load, _SOURCES))


def load():
    """The MSM kernel library."""
    return _load("msm")


def _bind_msm(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for kind in KINDS:
        for name, args in (
                ("leaf_prefix", [vp, vp, vp, ci, ci, ci, vp]),
                ("lane_offsets", [vp, vp, vp, ci, ci, vp]),
                ("weighted_sum", [vp, vp, vp, ci, ci, vp]),
                ("horner_fold", [vp, vp, ci, ci, vp]),
                ("ladder", [vp, vp, vp, vp, vp, ci, ci, vp]),
                ("reduce", [vp, vp, vp, ci, ci, vp]),
                ("point_bytes", [])):
            fn = getattr(lib, f"gnark_msm_{name}_{kind}")
            fn.argtypes = args
            fn.restype = ci


def _bind_microbench(lib):
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for name, args in (("steps", []),
                       ("u32", [ci, vp, vp, vp, cl, vp]),
                       ("fma_f32", [vp, vp, vp, cl, vp]),
                       ("montmul", [vp, vp, vp, cl, ci, ci, vp])):
        fn = getattr(lib, f"gnark_microbench_{name}")
        fn.argtypes = args
        fn.restype = ci


_BIND = {"msm": _bind_msm, "microbench": _bind_microbench}


def kind_of(GC) -> str:
    """'g1' or 'g2' for the BN254 groups the kernels are built for."""
    from gnark_tpu_torch.curves import BN254
    F, p = GC.F, BN254.fp.modulus
    if hasattr(F, "base"):
        if F.base.spec.modulus == p and F.beta == BN254.fp2_beta \
                and tuple(GC.b) == tuple(BN254.b2):
            return "g2"
    elif F.spec.modulus == p and GC.b == BN254.b:
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
    # a window's buckets folded in place, its levels' trees, and W
    scratch = _scratch(nw * (nb + nb // 2), kind, bk.device)
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
    """[3L, K, n]: column (j, i) = chunk j of scalar i times point i."""
    L, n = xs.shape
    _check(xs, (_L16[kind], n), "xs")
    _check(ys, (_L16[kind], n), "ys")
    _check(sc, (sc.shape[0], n), "scalars")
    if not (inf.is_cuda and inf.dtype == torch.bool and inf.is_contiguous()
            and tuple(inf.shape) == (n,)):
        raise ValueError(f"inf: want a contiguous bool CUDA tensor of shape "
                         f"({n},), got {inf.dtype} {tuple(inf.shape)} on "
                         f"{inf.device}")
    out = torch.empty((3 * L, LADDER_CHUNKS, n), dtype=torch.int64,
                      device=xs.device)
    _launch("ladder", kind, xs.data_ptr(), ys.data_ptr(), inf.data_ptr(),
            sc.data_ptr(), out.data_ptr(), n, sc.shape[0])
    return out


def reduce(pts, kind):
    """[3L, K, n] -> [3L, K]: the sum of each chunk's points."""
    L3, K, n = pts.shape
    _check(pts, (3 * _L16[kind], K, n), "points")
    out = torch.empty((L3, K), dtype=torch.int64, device=pts.device)
    scratch = _scratch(K * REDUCE_LANES, kind, pts.device)
    _launch("reduce", kind, pts.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, K)
    return out


def microbench_steps() -> int:
    """Steps per chain of the 32-bit and float ops (microbench.cu's STEPS)."""
    return _load("microbench").gnark_microbench_steps()


def microbench(op, x, y, steps=None, chains=4):
    """One launch of the chain kernel for ``op`` over every element of x
    against y (see csrc/microbench.cu).  ``steps`` is montmul_bn254's
    products per chain, ``chains`` its chains an element (4 or 1); the
    other ops run microbench_steps() on four chains."""
    if op not in MICROBENCH_OPS:
        raise ValueError(f"unknown microbenchmark op {op!r}")
    want = torch.float32 if op == "fma_f32" else torch.int64
    for name, t in (("x", x), ("y", y)):
        if not (t.is_cuda and t.dtype == want and t.is_contiguous()
                and t.shape == x.shape):
            raise ValueError(
                f"{name}: want a contiguous {want} CUDA tensor of shape "
                f"{tuple(x.shape)}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, contiguous={t.is_contiguous()}")
    lib = _load("microbench")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), y.data_ptr(), out.data_ptr())
    if op == "montmul_bn254":
        if x.ndim != 2 or x.shape[0] != _L16["g1"] or not steps or steps < 1:
            raise ValueError(f"montmul_bn254: want [16, n] limb planes and "
                             f"steps >= 1, got {tuple(x.shape)}, {steps}")
        if chains not in (1, 4):
            raise ValueError(f"montmul_bn254: 4 chains or 1, not {chains}")
        rc = lib.gnark_microbench_montmul(*ptrs, x.shape[1], steps, chains,
                                          stream)
    elif steps is not None or chains != 4:
        raise ValueError(f"{op}: steps and chains are fixed at build time")
    elif op == "fma_f32":
        rc = lib.gnark_microbench_fma_f32(*ptrs, x.numel(), stream)
    else:
        rc = lib.gnark_microbench_u32(MICROBENCH_U32_OPS.index(op), *ptrs,
                                      x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"microbench_{op}: launch failed, cudaError {rc}")
    launches[f"microbench_{op}"] += 1
    return out
