"""Build and bind the CUDA kernels (csrc/msm_kernels.cu,
csrc/msm_{g1,g2}_bls24315.cu, csrc/microbench.cu).

On first use, nvcc compiles a library's sources in this checkout into a
shared library with a plain C interface under ``gnark_tpu_torch/_build/``
(the file name carries a hash of the sources, so an edit rebuilds), and
ctypes loads it.  The four libraries are separate translation units:
BN254's MSM kernels (kinds ``g1``, ``g2``), BLS24-315's G1 (kind
``g1_bls24315``, over its fp), its G2 (``g2_bls24315``, over fp4) and the
microbenchmark; ``build_all`` runs the four compilers at once.  No torch
headers are compiled in.  Every launcher returns ``cudaGetLastError()``; a nonzero
code raises.

``launches`` counts kernel launches by name (``leaf_prefix_g1``, ...,
``ladder_g2_bls24315``, ``microbench_mul_u32``, ...); only the wrappers
here add to it, where they launch.
"""

from __future__ import annotations

import ctypes
import functools
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
    "msm_g1_bls24315": ("field.cuh", "ec_complete.cuh", "msm_kernels.cu",
                        "msm_g1_bls24315.cu"),
    "msm_g2_bls24315": ("field.cuh", "ec_complete.cuh", "msm_kernels.cu",
                        "msm_g2_bls24315.cu"),
    "microbench": ("field.cuh", "microbench.cu"),
}

WINDOW_KERNELS = ("leaf_prefix", "lane_offsets", "weighted_sum", "horner_fold")
KERNELS = WINDOW_KERNELS + ("ladder", "reduce")
REDUCE_LANES = 256       # msm_kernels.cu's reduce_kernel
# the kinds (msm_kernels.cu's curve structs G1, G2, G1Bls24, G2Bls24) and
# the library each is built into
LIBRARY = {"g1": "msm", "g2": "msm", "g1_bls24315": "msm_g1_bls24315",
           "g2_bls24315": "msm_g2_bls24315"}
KINDS = tuple(LIBRARY)
_L16 = {"g1": 16, "g2": 32,     # 16-bit limb planes of one coordinate
        "g1_bls24315": 20, "g2_bls24315": 80}
# a kind's shape as its library reports it (msm_kernels.cu's
# GNARK_MSM_SHAPE, in this order): the base field's 32-bit words, the
# coordinate field's degree over it, an F-product's base products in the
# fold (Prod<F>::S), whether b3 * a is a product (B3_PRODUCT), the curve
# struct's LEAF_GROUP (threads a leaf chain), WSUM_GROUP, WSUM_THREADS,
# WSUM_CLUSTER (threads a weighted-sum operation, threads a block, blocks
# a window), LANES_GROUP, LANES_THREADS, LANES_CLUSTER (the same for a
# lane-offsets addition), LADDER_POINTS (points a ladder block), a
# Point<F>'s bytes, the leaf's threads a block, whether the leaf, the
# ladder, the fold, the weighted sum and the reduction are the sliced
# kernels (fp4: a point's coefficients over the group), the shipped
# ladder's threads a chain, threads a block and blocks an SM, the fold's
# threads, and the reduction's threads an accumulator, threads a block
# and blocks a chunk (LadderShape: 1, 16 LADDER_POINTS, LADDER_BLOCKS, one
# warp, and 1, REDUCE_LANES, 1 for the template kernels)
SHAPE = ("words", "degree", "prod_s", "b3_product", "leaf_group",
         "wsum_group", "wsum_threads", "wsum_cluster", "lanes_group",
         "lanes_threads", "lanes_cluster", "ladder_points", "point_bytes",
         "leaf_threads", "leaf_sliced", "ladder_group", "ladder_threads",
         "ladder_blocks", "fold_group", "reduce_group", "reduce_threads",
         "reduce_cluster")
LADDER_CHUNKS = 16       # msm_kernels.cu's ladder_kernel: chunks a
LADDER_WINDOW = 4        # scalar, bits a window
# microbench.cu's enum Op, in order; then the two kernels of their own
MICROBENCH_U32_OPS = ("mul_u32", "mul16_u32", "add_u32", "mad_wide_u32",
                      "mad_lo_hi_u32")
MICROBENCH_OPS = MICROBENCH_U32_OPS + ("fma_f32", "montmul_bn254",
                                       "montmul_bls24315")
# the Montgomery products' kinds: their 16-bit limb planes, their launcher
MONTMUL = {"montmul_bn254": (16, "montmul"),
           "montmul_bls24315": (20, "montmul_bls24315")}

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


def load(kind="g1"):
    """The MSM kernel library of a kind."""
    return _load(LIBRARY[kind])


def _bind_msm(lib, library):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for kind in (k for k, v in LIBRARY.items() if v == library):
        for name, args in (
                ("leaf_prefix", [vp, vp, vp, ci, ci, ci, vp]),
                ("lane_offsets", [vp, vp, vp, ci, ci, vp]),
                ("weighted_sum", [vp, vp, vp, ci, ci, vp]),
                ("horner_fold", [vp, vp, ci, ci, vp]),
                ("ladder", [vp, vp, vp, vp, vp, ci, ci, vp]),
                ("reduce", [vp, vp, vp, ci, ci, vp])):
            fn = getattr(lib, f"gnark_msm_{name}_{kind}")
            fn.argtypes = args
            fn.restype = ci


def _bind_microbench(lib):
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for name, args in (("steps", []),
                       ("u32", [ci, vp, vp, vp, cl, vp]),
                       ("fma_f32", [vp, vp, vp, cl, vp]),
                       ("montmul", [vp, vp, vp, cl, ci, ci, vp]),
                       ("montmul_bls24315", [vp, vp, vp, cl, ci, ci, vp])):
        fn = getattr(lib, f"gnark_microbench_{name}")
        fn.argtypes = args
        fn.restype = ci


_BIND = {"microbench": _bind_microbench,
         **{lib: functools.partial(_bind_msm, library=lib)
            for lib in set(LIBRARY.values())}}


def kind_of(GC) -> str:
    """The kernels' kind of a group: 'g1' or 'g2' for BN254's, 'g1_bls24315'
    or 'g2_bls24315' for BLS24-315's; raises for any other group."""
    from gnark_tpu_torch.curves import BLS24_315, BN254
    F = GC.F
    for curve, suffix in ((BN254, ""), (BLS24_315, "_bls24315")):
        p = curve.fp.modulus
        if not hasattr(F, "base"):
            if F.spec.modulus == p and GC.b == curve.b:
                return "g1" + suffix
        elif F.base.spec.modulus == p and tuple(GC.b) == tuple(curve.b2) \
                and getattr(F, "beta", None) == (curve.fp2_beta or None) \
                and getattr(F, "c", None) == (curve.g2_tower_c or None):
            return "g2" + suffix
    raise NotImplementedError("the MSM kernels are built for BN254 and "
                              "BLS24-315 G1/G2 only")


def _check(t: torch.Tensor, shape, name):
    if not (t.is_cuda and t.dtype == torch.int64 and t.is_contiguous()):
        raise ValueError(f"{name}: want a contiguous int64 CUDA tensor, got "
                         f"{t.dtype} on {t.device}, contiguous="
                         f"{t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _launch(name, kind, *args):
    lib = load(kind)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"gnark_msm_{name}_{kind}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_{kind}: launch failed, cudaError {rc}")
    launches[f"{name}_{kind}"] += 1


def read_shape(fn) -> dict:
    """{SHAPE name: value} from a library's gnark_msm_shape_<kind>."""
    out = (ctypes.c_int * len(SHAPE))()
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    fn(out)
    return dict(zip(SHAPE, out))


@functools.cache
def shape(kind) -> dict:
    """A kind's shape (SHAPE), read from its library once."""
    return read_shape(getattr(load(kind), f"gnark_msm_shape_{kind}"))


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
    nbytes = points * shape(kind)["point_bytes"]
    return torch.empty((nbytes + 3) // 4, dtype=torch.int32, device=device)


def lane_offsets(tot, kind):
    _, nw, R = tot.shape
    _check(tot, (3 * _L16[kind], nw, R), "totals")
    if R < 1 or R & (R - 1):
        raise ValueError(f"lane count {R} is not a power of two")
    out = torch.empty_like(tot)
    scratch = _scratch(nw * R, kind, tot.device)    # scanned in place
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
    against y (see csrc/microbench.cu).  ``steps`` is a Montgomery
    product's (montmul_bn254, montmul_bls24315) products per chain,
    ``chains`` its chains an element (4 or 1); the other ops run
    microbench_steps() on four chains."""
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
    if op in MONTMUL:
        planes, fn = MONTMUL[op]
        if x.ndim != 2 or x.shape[0] != planes or not steps or steps < 1:
            raise ValueError(f"{op}: want [{planes}, n] limb planes and "
                             f"steps >= 1, got {tuple(x.shape)}, {steps}")
        if chains not in (1, 4):
            raise ValueError(f"{op}: 4 chains or 1, not {chains}")
        rc = getattr(lib, f"gnark_microbench_{fn}")(*ptrs, x.shape[1], steps,
                                                    chains, stream)
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
