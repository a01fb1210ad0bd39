"""Build and bind the CUDA kernels (csrc/msm_kernels.cu,
csrc/msm_{g1,g2}_bls24315.cu, csrc/ntt_kernels.cu, csrc/microbench.cu).

On first use, nvcc compiles a library's sources in this checkout into a
shared library with a plain C interface under ``gnark_tpu_torch/_build/``
(the file name carries a hash of the sources, so an edit rebuilds), and
ctypes loads it.  The five libraries are separate translation units:
BN254's MSM kernels (kinds ``g1``, ``g2``), BLS24-315's G1 (kind
``g1_bls24315``, over its fp), its G2 (``g2_bls24315``, over fp4), the
quotient's NTT passes and pointwise step over the six scalar fields
(kinds ``fr_bn254`` ... ``fr_bw6_633``, ``FR_KINDS``) and the
microbenchmark; ``build_all`` runs the five compilers at once.  No torch
headers are compiled in.  Every MSM and microbenchmark launcher returns
``cudaGetLastError()``, a nonzero code raising; the NTT library's return
the number of kernels they launched (a transform's passes from one
call, ``ntt_plan``), or minus the error, which raises.

``launches`` counts kernel launches by name (``leaf_prefix_g1``, ...,
``ladder_g2_bls24315``, ``fixed_base_g1``, ``ntt_fr_bn254``,
``fr_pointwise_fr_bw6_761``, ``microbench_mul_u32``, ...); only the
wrappers here add to it, where they launch.
"""

from __future__ import annotations

import collections
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
    "ntt": ("field.cuh", "ntt_kernels.cu"),
    "microbench": ("field.cuh", "microbench.cu"),
}

WINDOW_KERNELS = ("leaf_prefix", "lane_offsets", "buckets", "weighted_sum",
                  "horner_fold")
# the MSM's kernels, and the fixed-base scan of setup's key points
MSM_KERNELS = WINDOW_KERNELS + ("ladder", "reduce")
KERNELS = MSM_KERNELS + ("fixed_base",)
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
# warp, and 1, REDUCE_LANES, 1 for the template kernels), and the bucket
# step's threads an addition, threads a block and buckets a block
# (BUCKETS_GROUP, BUCKETS_THREADS, buckets_run); the fixed-base scan runs
# on the leaf's leaf_group and leaf_threads
SHAPE = ("words", "degree", "prod_s", "b3_product", "leaf_group",
         "wsum_group", "wsum_threads", "wsum_cluster", "lanes_group",
         "lanes_threads", "lanes_cluster", "ladder_points", "point_bytes",
         "leaf_threads", "leaf_sliced", "ladder_group", "ladder_threads",
         "ladder_blocks", "fold_group", "reduce_group", "reduce_threads",
         "reduce_cluster", "buckets_group", "buckets_threads",
         "buckets_run")
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

# ntt_kernels.cu's kinds, the scalar field fr of each curve, and their
# 16-bit limb planes; BW6-761's fr is BLS12-377's fp, BW6-633's
# BLS24-315's fp
FR_KINDS = {"fr_bn254": 16, "fr_bls12_381": 16, "fr_bls12_377": 16,
            "fr_bls24_315": 16, "fr_bw6_761": 24, "fr_bw6_633": 20}
NTT_KERNELS = ("ntt", "fr_pointwise")

launches = {f"{k}_{kind}": 0 for k in KERNELS for kind in KINDS}
launches.update({f"{k}_{kind}": 0 for k in NTT_KERNELS for kind in FR_KINDS})
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
                ("buckets", [vp, vp, vp, vp, ci, ci, ci, ci, vp]),
                ("weighted_sum", [vp, vp, vp, ci, ci, vp]),
                ("horner_fold", [vp, vp, ci, ci, vp]),
                ("ladder", [vp, vp, vp, vp, vp, ci, ci, vp]),
                ("reduce", [vp, vp, vp, ci, ci, vp]),
                ("fixed_base", [vp, vp, vp, ci, ci, ci, ci, vp])):
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


def _bind_ntt(lib):
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for kind in FR_KINDS:
        for name, args in (
                ("ntt", [vp, vp, vp, cl, vp, cl, ci, vp, cl, ci, cl, ci,
                         vp]),
                ("ntt_plan", [cl, ci, vp]),
                ("fr_pointwise", [vp, vp, vp, vp, cl, ci, vp, cl, vp])):
            fn = getattr(lib, f"gnark_{name}_{kind}")
            fn.argtypes = args
            fn.restype = ci


_BIND = {"microbench": _bind_microbench, "ntt": _bind_ntt,
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


def fr_kind(spec) -> str:
    """The NTT kernels' kind of a scalar field (a FieldSpec): ``fr_<curve>``
    for the fr of each of the six curves; raises for any other field."""
    from gnark_tpu_torch.curves import ALL_CURVES
    for name, curve in ALL_CURVES.items():
        kind = f"fr_{name}"
        if kind in FR_KINDS and curve.fr.modulus == spec.modulus \
                and spec.L == FR_KINDS[kind]:
            return kind
    raise NotImplementedError(f"the NTT kernels are built for the six "
                              f"curves' scalar fields, not {spec.name}")


def _check(t: torch.Tensor, shape, name, dtype=torch.int64):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"{name}: want a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}, contiguous="
                         f"{t.is_contiguous()}")


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


def buckets(rows, offs, d_sorted, C, R, nb, kind):
    """[3L, nw, nb]: bucket b of each window, from the leaf rows [nw, C R,
    3L], the lane offsets [3L, nw, R] and the sorted digits [nw, C R]
    (msm_kernels.cu's buckets_kernel: one launch)."""
    nw = rows.shape[0]
    L3 = 3 * _L16[kind]
    _check(rows, (nw, C * R, L3), "rows")
    _check(offs, (L3, nw, R), "offsets")
    _check(d_sorted, (nw, C * R), "sorted digits")
    out = torch.empty((L3, nw, nb), dtype=torch.int64, device=rows.device)
    _launch("buckets", kind, rows.data_ptr(), offs.data_ptr(),
            d_sorted.data_ptr(), out.data_ptr(), nw, C, R, nb)
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
    """[3L, 1] = sum_w 2^(cw) S_w in the Jacobian form (X Z, Y Z^2, Z)."""
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


def entry_words(L16) -> int:
    """32-bit words of one fixed-base table entry over a coordinate field
    of L16 16-bit limbs: x's words, y's words and the infinity flag,
    padded to whole 16-byte vectors (msm_kernels.cu's fixed_base_entry)."""
    return (L16 + 4) // 4 * 4


def fixed_base(sc, table, c, kind):
    """[3L, n]: column j = sum over the windows w of table entry (w, digit
    w of scalar j), Jacobian (msm_kernels.cu's fixed_base_kernel, or
    fixed_base_sliced_kernel over fp4: one launch).  sc: [Ls, n]
    regular-form 16-bit scalar limbs; table: int32 [nwin, 2^c, entry
    words] (ops/fixed_base.py's point_major); c <= 16."""
    Ls, n = sc.shape
    nwin = table.shape[0]
    if not 1 <= c <= 16:
        raise ValueError(f"window width {c} is not in 1..16")
    words = entry_words(_L16[kind])
    _check(table, (nwin, 1 << c, words), "table", torch.int32)
    _check(sc, (Ls, n), "scalars")
    out = torch.empty((3 * _L16[kind], n), dtype=torch.int64,
                      device=sc.device)
    _launch("fixed_base", kind, sc.data_ptr(), table.data_ptr(),
            out.data_ptr(), n, Ls, c, nwin)
    return out


def _planes(t, shapes, name):
    if t is not None and tuple(t.shape) not in shapes:
        raise ValueError(f"{name}: want shape " + " or ".join(
            str(s) for s in shapes) + f", got {tuple(t.shape)}")
    return 0 if t is None else t.data_ptr()


NttPass = collections.namedtuple(
    "NttPass", "s0 m c tile_log smem_bytes blocks_per_sm")


def ntt_plan(kind, n, dit=False):
    """The passes that ``ntt_transform`` launches for an n-point transform
    of ``kind``, in their order, as the library plans them
    (csrc/ntt_kernels.cu's ntt_plan, gnark_ntt_plan_<kind>): each pass's
    first stage s0, its m stages over 2^c adjacent columns (c = 0: a
    contiguous pass), its tile 2^tile_log, its block's dynamic shared
    memory and the blocks an SM that CUDA's occupancy allows on the
    current device."""
    out = (ctypes.c_int * (6 * 64))()
    plan = getattr(_load("ntt"), f"gnark_ntt_plan_{kind}")
    count = plan(n, int(dit), out)
    if count < 0:
        raise RuntimeError(f"ntt_plan_{kind}: cudaError {-count}")
    return [NttPass(*out[6 * i:6 * i + 6]) for i in range(count)]


def ntt_args(x, y, tw, pre, post, dit):
    """The arguments of csrc/ntt_kernels.cu's ``gnark_ntt_<kind>`` but
    the stream, after the shape checks: x, y [L, n], tw [L, n / 2]; pre
    and post [L, n], [L, 1] (one value for every element) or None; a DIT
    transform if ``dit``, else DIF."""
    L, n = x.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"transform size {n} is not a power of two")
    _planes(y, [(L, n)], "y")
    _planes(tw, [(L, n // 2)], "twiddles")
    scales = []
    for name, t in (("pre", pre), ("post", post)):
        scales += [_planes(t, [(L, n), (L, 1)], name),
                   0 if t is None else t.shape[1],
                   int(t is not None and t.shape[1] == n)]
    return (x.data_ptr(), y.data_ptr(), tw.data_ptr(), n // 2, *scales, n,
            int(dit))


def _launch_fr(name, counter, kind, planes, args):
    """One call of ntt_kernels.cu's gnark_<name>_<kind> on the current
    stream, its launches counted as <counter>_<kind>; ``planes`` is its
    first tensor."""
    if planes.shape[0] != FR_KINDS[kind]:
        raise ValueError(f"want {FR_KINDS[kind]} limb planes for {kind}, "
                         f"got {planes.shape[0]}")
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(_load("ntt"), f"gnark_{name}_{kind}")(*args, stream)
    if rc < 0:
        raise RuntimeError(f"{counter}_{kind}: launch failed, cudaError "
                           f"{-rc}")
    launches[f"{counter}_{kind}"] += rc


def ntt_transform(x, tw, pre, post, dit, kind):
    """One transform of x (DIT if ``dit``, else DIF) into a new tensor, x
    left as it was: one C call that launches ntt_pass_kernel once a pass
    (``ntt_plan``), pre's scale on the first pass's load and post's on
    the last's store where given (ntt_args)."""
    for name, t in (("x", x), ("twiddles", tw), ("pre", pre),
                    ("post", post)):
        if t is not None:
            _check(t, t.shape, name)
    y = torch.empty_like(x)
    _launch_fr("ntt", "ntt", kind, x, ntt_args(x, y, tw, pre, post, dit))
    return y


def fr_pointwise_args(a, b, c, d, out):
    """The arguments of ``gnark_fr_pointwise_<kind>`` but the stream: a,
    b, c, out [L, n]; d [L, n] or [L, 1] (one value for every element)."""
    L, n = a.shape
    for name, t in (("b", b), ("c", c), ("out", out)):
        _planes(t, [(L, n)], name)
    return (a.data_ptr(), b.data_ptr(), c.data_ptr(),
            _planes(d, [(L, n), (L, 1)], "d"), d.shape[1],
            int(d.shape[1] == n), out.data_ptr(), n)


def fr_pointwise(a, b, c, d, kind):
    """(a b - c) d elementwise: one launch of fr_pointwise_kernel."""
    for name, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        _check(t, t.shape, name)
    out = torch.empty_like(a)
    _launch_fr("fr_pointwise", "fr_pointwise", kind, a,
               fr_pointwise_args(a, b, c, d, out))
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
