"""A group kernel at several thread-group widths and block sizes, on one card.

    python -m gnark_tpu_torch.ops.leaf_groups
        [--kernel leaf_prefix|weighted_sum|lane_offsets|ladder|horner_fold|
                  reduce]
        [--kind g2_bls24315] [--csrc DIR] [--baseline DIR] [--out FILE]

Builds one library that instantiates the kernel of ``csrc/msm_kernels.cu``
(or that of ``--csrc``) at each trial shape and, with ``--baseline``, the
``msm_kernels.cu`` of another version of the kernels (a ``csrc``
directory), the two compilers side by side:

  * ``leaf_prefix`` (the default): ``leaf_prefix_kernel<Curve, G>`` for G1
    at G = 2, 4, 8 and G2 at G = 4, 8, 16, at the 2^16 plan's shapes (c =
    11, 24 windows, R = 512, C = 128; 1 point in 64 infinite, as in
    chip_smoke.py) for G1 and G2, and at a PLONK commitment's 2^16 + 3
    points (C = 129) for G1; with ``--kind g2_bls24315``, BLS24-315's fp4
    leaf ``leaf_sliced_kernel<G2Bls24, G, THREADS, BLOCKS>`` at each of
    SLICED_SHAPES (G = 2: two coefficients a lane; 4: one; 8: a
    coefficient on a lane pair, each lane half of its columns' rounds),
    at the 2^16 plan (c = 11, C = 128) and at 2^16 + 3 points (C = 129),
    its baseline the other version's ``msm_g2_bls24315.cu``;
  * ``weighted_sum``: ``weighted_sum_kernel<Curve, G, THREADS, CLUSTER>``
    for G1 at G = 2, 4, 8 and G2 at G = 4, 8, 16, each in blocks of 128,
    256 and 512 threads, the last two also in clusters of 2, 4 and 8
    blocks a window, on the 2^16 plan's buckets (24 windows of 1,024) for
    G1 and G2, made by the plain leaf, lane offsets and bucket steps on
    the card; with ``--kind g2_bls24315``, BLS24-315's fp4 weighted sum
    ``weighted_sum_sliced_kernel<G2Bls24, G, THREADS, CLUSTER>`` at each
    of WSUM_FP4_SHAPES on that plan's fp4 buckets;
  * ``lane_offsets``: ``lane_offsets_kernel<Curve, G, THREADS, CLUSTER>``
    for G1 at G = 2, 4, 8 and G2 at G = 4, 8, 16, each in blocks of 128
    and 256 threads, in clusters of 1, 2 and 4 blocks a window, on the
    2^16 plan's lane totals (24 windows of 512) for G1 and G2, made by
    the plain leaf on the card; with ``--kind g2_bls24315``, BLS24-315's
    fp4 lane offsets ``lane_offsets_sliced_kernel<G2Bls24, G, THREADS,
    CLUSTER>`` at each of LANES_FP4_SHAPES on that plan's fp4 lane totals;
  * ``ladder --kind g2_bls24315``: BLS24-315's fp4 ladder
    ``ladder_sliced_kernel<G2Bls24, G, THREADS, BLOCKS>`` at each of
    LADDER_SHAPES on 4,096 points (1 in 64 infinite, random scalars), as
    chip_smoke.py's phase 8 runs it;
  * ``horner_fold --kind g2_bls24315``: its fold
    ``horner_fold_sliced_kernel<G2Bls24, G>`` at G in FOLD_GROUPS on the
    2^16 plan's window sums (24 windows, c = 11, made by the plain leaf,
    lane offsets, bucket and weighted-sum steps on the card) and on the
    ladder's chunk sums of those 4,096 points (16, c = 16);
  * ``reduce --kind g2_bls24315``: its reduction
    ``reduce_sliced_kernel<G2Bls24, G, THREADS, CLUSTER>`` at each of
    REDUCE_SHAPES on the plain ladder's output at those 4,096 points (16
    chunks);
    ``--baseline`` for the fp4 kernels is the other version's
    ``msm_g2_bls24315.cu`` (its ``gnark_msm_<kernel>_g2_bls24315``).  The
    trial shapes build in translation units of their own, one a (G,
    threads) for the fp4 ladder, weighted sum, reduction and lane offsets,
    side by side, never in the shipped library.

Every shape (and the baseline) is held against the plain version on the
same CUDA tensors, bit for bit, and timed with CUDA events: 3 launches
after a warm-up, in two rounds, the second in the reverse order, so that
the baseline runs first and last.  Prints each kernel's ptxas line and
one line a shape and, with ``--out``, writes the numbers as JSON.  The
shapes that ship are ``G1/G2::LEAF_GROUP``, ``WSUM_GROUP``,
``WSUM_THREADS``, ``WSUM_CLUSTER`` and ``LANES_GROUP``, ``LANES_THREADS``,
``LANES_CLUSTER``, and ``G2Bls24::LEAF_GROUP``, ``LEAF_THREADS``,
``LEAF_BLOCKS``, ``LADDER_GROUP``, ``LADDER_THREADS``, ``LADDER_BLOCKS``,
``FOLD_GROUP``, ``WSUM_GROUP``, ``WSUM_THREADS``, ``WSUM_CLUSTER``,
``REDUCE_GROUP``, ``REDUCE_THREADS``, ``REDUCE_CLUSTER``, ``LANES_GROUP``,
``LANES_THREADS`` and ``LANES_CLUSTER``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gnark_tpu_torch.backend.groth16 import _Groups
from gnark_tpu_torch.curves import BLS24_315, BN254
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops

WIDTHS = {"g1": (2, 4, 8), "g2": (4, 8, 16)}
# the fp4 leaf's trial shapes: (G, threads a block, resident blocks an SM
# that its launch bounds ask for); the 2^16 plan's 49,152 threads at G = 4
# are 11.6 warps an SM
SLICED_SHAPES = [(2, 128, 2), (4, 128, 2), (4, 128, 3), (4, 128, 4),
                 (4, 64, 6), (8, 128, 2), (8, 128, 3), (8, 128, 4),
                 (8, 64, 6)]
# the fp4 ladder's trial shapes: (G, threads a block, resident blocks an
# SM that its launch bounds ask for: a register cap of 65,536 / (threads
# x blocks), at most 255); a block holds threads / G / 16 points (or half
# a point's chunks at G = 8 and 64 threads), 9.2 KB of table and 2.9 KB of
# slots a group, so G = 4 and 2 in 128 threads pass half an SM's shared
# memory.  One translation unit for each (G, threads), built side by side.
LADDER_SHAPES = [(8, 128, 2), (8, 128, 3), (8, 128, 4), (8, 64, 4),
                 (8, 64, 6), (8, 64, 8), (4, 64, 4), (4, 64, 6), (4, 128, 2),
                 (2, 64, 2)]
FOLD_GROUPS = (4, 8, 16)      # the fp4 fold's trial widths
# the fp4 weighted sum's and reduction's trial shapes: (G, threads a block,
# blocks a cluster).  A group's slots are 2.9 KB, so 32 groups a block
# (92 KB) leave two blocks an SM and 64 (184 KB) one; 512 threads cap a
# thread at 128 registers.  The 2^16 plan's first steps have 768
# operations a window; a chunk of the reduction has 256 accumulators (a
# cluster with fewer groups runs two on each).
WSUM_FP4_SHAPES = [(4, 128, 4), (4, 128, 8), (4, 64, 8), (8, 128, 4),
                   (8, 256, 4), (8, 256, 8), (16, 256, 4), (16, 256, 8),
                   (16, 512, 4)]
REDUCE_SHAPES = [(4, 128, 8), (4, 64, 8), (4, 256, 4), (8, 256, 8),
                 (8, 128, 8), (8, 512, 4), (16, 512, 8), (16, 256, 8)]
# the fp4 lane offsets' trial shapes, as the weighted sum's: R = 512's
# widest steps have 256 and 255 additions a window, its narrowest one
LANES_FP4_SHAPES = [(4, 128, 4), (4, 128, 8), (8, 128, 4), (8, 128, 8),
                    (8, 256, 4), (8, 256, 8), (16, 256, 4), (16, 256, 8)]
N_LADDER = 1 << 12
BLOCKS = (128, 256, 512)      # the weighted sum's threads a block
CLUSTERS = (1, 2, 4, 8)       # and its blocks a window, from 256 threads
WSUM_SHAPES = [(g, t, cl) for g in (2, 4, 8, 16) for t in BLOCKS
               for cl in (CLUSTERS if t >= 256 else (1,))]
LANES_SHAPES = [(g, t, cl) for g in (2, 4, 8, 16) for t in (128, 256)
                for cl in (1, 2, 4)]
N = 1 << 16
SEED = 7
REPS = 3

_LEAF_TU = """#include "msm_kernels.cu"
#define TRIAL(NAME, CURVE, G)                                               \\
  extern "C" int leaf_trial_##NAME##_##G(const void* sx, const void* sy,    \\
      void* rows, int nw, int C, int R, void* stream) {                     \\
    return launch_leaf_prefix<CURVE, G>(sx, sy, rows, nw, C, R, stream);    \\
  }
""" + "".join(f"TRIAL({k}, {k.upper()}, {g})\n"
              for k, ws in WIDTHS.items() for g in ws)

_SLICED_TU = """#define GNARK_MSM_BLS24315
#include "msm_kernels.cu"
#define TRIAL(G, T, B)                                                      \\
  extern "C" int leaf_trial_g2_bls24315_##G##_##T##_##B(const void* sx,     \\
      const void* sy, void* rows, int nw, int C, int R, void* stream) {     \\
    return launch_leaf_sliced<G2Bls24, G, T, B>(sx, sy, rows, nw, C, R,     \\
                                                stream);                    \\
  }
""" + "".join(f"TRIAL({g}, {t}, {b})\n" for g, t, b in SLICED_SHAPES)

_WSUM_TU = """#include "msm_kernels.cu"
#define TRIAL(NAME, CURVE, G, T, CL)                                        \\
  extern "C" int wsum_trial_##NAME##_##G##_##T##_##CL(const void* bk,       \\
      void* out, void* scratch, int nw, int nb, void* stream) {             \\
    return launch_weighted_sum<CURVE, G, T, CL>(bk, out, scratch, nw, nb,   \\
                                                stream);                    \\
  }
""" + "".join(f"TRIAL({k}, {k.upper()}, {g}, {t}, {cl})\n"
              for k, ws in WIDTHS.items() for g, t, cl in WSUM_SHAPES
              if g in ws)

_LANES_TU = """#include "msm_kernels.cu"
#define TRIAL(NAME, CURVE, G, T, CL)                                        \\
  extern "C" int lanes_trial_##NAME##_##G##_##T##_##CL(const void* tot,     \\
      void* out, void* scratch, int nw, int R, void* stream) {              \\
    return launch_lane_offsets<CURVE, G, T, CL>(tot, out, scratch, nw, R,   \\
                                                stream);                    \\
  }
""" + "".join(f"TRIAL({k}, {k.upper()}, {g}, {t}, {cl})\n"
              for k, ws in WIDTHS.items() for g, t, cl in LANES_SHAPES
              if g in ws)
_TU = {"leaf_prefix": _LEAF_TU, "weighted_sum": _WSUM_TU,
       "lane_offsets": _LANES_TU}
_FP4_HEAD = """#define GNARK_MSM_BLS24315
#include "msm_kernels.cu"
"""
_LADDER_TRIAL = """#define TRIAL(G, T, B)                                                      \\
  extern "C" int ladder_trial_g2_bls24315_##G##_##T##_##B(const void* xs,   \\
      const void* ys, const void* inf, const void* sc, void* out, int n,    \\
      int Ls, void* stream) {                                               \\
    return launch_ladder_sliced<G2Bls24, G, T, B>(xs, ys, inf, sc, out, n,  \\
                                                  Ls, stream);              \\
  }
"""
_FOLD_TRIAL = """#define TRIAL(G)                                                            \\
  extern "C" int fold_trial_g2_bls24315_##G(const void* S, void* out,       \\
      int nw, int c, void* stream) {                                        \\
    return launch_horner_fold_sliced<G2Bls24, G>(S, out, nw, c, stream);    \\
  }
"""
# the fp4 weighted sum's, reduction's and lane offsets' trials, each a
# launcher of an input, out, scratch and two ints: (trial name, launcher)
_GROUPS_TRIAL = """#define TRIAL(G, T, CL)                                                     \\
  extern "C" int {name}_trial_g2_bls24315_##G##_##T##_##CL(const void* a,   \\
      void* out, void* scratch, int x, int y, void* stream) {{              \\
    return launch_{launcher}_sliced<G2Bls24, G, T, CL>(a, out, scratch, x,  \\
                                                       y, stream);          \\
  }}
"""
_GROUPS_TRIALS = {"weighted_sum": ("wsum", "weighted_sum"),
                  "reduce": ("reduce", "reduce"),
                  "lane_offsets": ("lanes", "lane_offsets")}
_GROUPS_SHAPES = {"weighted_sum": WSUM_FP4_SHAPES, "reduce": REDUCE_SHAPES,
                  "lane_offsets": LANES_FP4_SHAPES}


def trial_units(kernel, kind=None):
    """{name: source} of the translation units a sweep builds: one, or
    for the fp4 ladder, weighted sum, reduction and lane offsets one for
    each (G, threads) of their shapes."""
    if kind and kernel in _GROUPS_TRIALS:
        name, launcher = _GROUPS_TRIALS[kernel]
        units = {}
        for g, t, cl in _GROUPS_SHAPES[kernel]:
            units.setdefault(f"trial_{g}_{t}", _FP4_HEAD + _GROUPS_TRIAL.format(
                name=name, launcher=launcher))
            units[f"trial_{g}_{t}"] += f"TRIAL({g}, {t}, {cl})\n"
        return units
    if kernel == "ladder":
        units = {}
        for g, t, b in LADDER_SHAPES:
            units.setdefault(f"trial_{g}_{t}", _FP4_HEAD + _LADDER_TRIAL)
            units[f"trial_{g}_{t}"] += f"TRIAL({g}, {t}, {b})\n"
        return units
    if kernel == "horner_fold":
        return {"trial": _FP4_HEAD + _FOLD_TRIAL + "".join(
            f"TRIAL({g})\n" for g in FOLD_GROUPS)}
    return {"trial": _SLICED_TU if kind else _TU[kernel]}


def _build(name, source, include):
    """nvcc of one translation unit into _build/; returns (library path,
    ptxas report)."""
    os.makedirs(_cuda._BUILD, exist_ok=True)
    out = os.path.join(_cuda._BUILD, f"lib{name}_{os.getpid()}.so")
    cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", f"-I{include}", "-o", out, source]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stdout}\n{res.stderr}")
    print(f"[leaf_groups] nvcc {name} {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out, res.stdout + res.stderr


def kernel_registers(report, kernel="leaf_prefix"):
    """'G1 G=4' ('G1 G=4 T=256 CL=4' for the weighted sum and the lane
    offsets, 'G2Bls24 G=4 T=128 B=3' for the fp4 leaf, 'G1' for a kernel
    without a width) -> the stack and register lines of each
    instantiation of ``{kernel}_kernel``."""
    out, name, props = {}, None, ""
    labels = (("G", "T", "B") if kernel in ("leaf_sliced", "ladder_sliced")
              else ("G", "T", "CL"))
    for line in report.splitlines():
        m = re.search(rf"Function properties for _Z\d+{kernel}_kernelI\d+"
                      r"(G[12](?:Bls24)?)((?:Li\d+E)*)E", line)
        if "Function properties for" in line:
            name = None
            if m:
                ints = re.findall(r"Li(\d+)E", m.group(2))
                name = " ".join([m.group(1)] + [
                    f"{k}={v}" for k, v in zip(labels, ints)])
            props = ""
        elif name and "stack frame" in line:
            props = line.strip() + "; "
        elif name and re.search(r"Used (\d+) registers", line):
            out[name] = props + line.strip()
            name = None
    return out


def _bind(lib, fn, ints, ptrs=3):
    """A launcher of ``ptrs`` pointers, ``ints`` ints and the stream;
    ``lib`` may be {name: library}, the one that has ``fn``."""
    if isinstance(lib, dict):
        lib = next(x for x in lib.values() if hasattr(x, fn))
    f = getattr(lib, fn)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [vp] * ptrs + [ci] * ints + [vp]
    f.restype = ci
    return f


def _group(kind):
    if kind == "g1":
        return (CurveOps(field_ops(BN254.fp), b=BN254.b), BN254.host_g1,
                BN254.g1_gen)
    if kind == "g2_bls24315":
        return (_Groups(BLS24_315).g2, BLS24_315.host_g2, BLS24_315.g2_gen)
    return (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
            BN254.host_g2, BN254.g2_gen)


def _inputs(kind, n, rng, device):
    """The 2^16 plan's (or n points') sorted leaf inputs: point i =
    2^(i mod 64) G, random scalars, 1 point in 64 infinite."""
    G, H, gen = _group(kind)
    r_mod = (BLS24_315 if kind.endswith("_bls24315") else BN254).fr.modulus
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    reps = -(-n // 64)
    xs = G.F.pack([p[0] for p in base], device).repeat(1, reps)[:, :n]
    ys = G.F.pack([p[1] for p in base], device).repeat(1, reps)[:, :n]
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    inf[::64] = True
    scalars = [int.from_bytes(rng.bytes(32), "little") % r_mod
               for _ in range(n)]
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(
        np.int64)).to(device)
    plan = M.MSM(G, n, BN254.fr.L)
    ptrows, dg, sg = plan._prep_window(xs.contiguous(), ys.contiguous(), inf,
                                       sc)
    sx, sy, d_sorted = plan._sort_gather(ptrows, dg, sg)
    return plan, sx, sy, d_sorted


def _time(launch):
    launch()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _checked(fn, *args):
    """A launch of fn(*args, stream) that raises on an error code."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = fn(*args, stream)
        if rc:
            raise RuntimeError(f"launch failed, cudaError {rc}")
    return launch


def leaf_cases(libs, rng, device, kind=None):
    """(label, case, want (a tensor, or a function of the shape), {shape:
    fn(out) -> launch}, warps an SM of a shape or None) for each leaf
    case: BN254's, or with kind="g2_bls24315" the fp4 leaf's."""
    runs = (((kind, N), (kind, N + 3)) if kind
            else (("g1", N), ("g2", N), ("g1", N + 3)))
    for kind, n in runs:
        plan, sx, sy, _ = _inputs(kind, n, rng, device)
        want = M.leaf_prefix_plain(sx, sy, plan.GC)
        nw, C, _, R = sx.shape
        if kind == "g2_bls24315":
            fns = {f"G={g} T={t} B={b}": _bind(
                _trials(libs), f"leaf_trial_{kind}_{g}_{t}_{b}", 3)
                for g, t, b in SLICED_SHAPES}
        else:
            fns = {f"G={g}": _bind(_trials(libs), f"leaf_trial_{kind}_{g}", 3)
                   for g in WIDTHS[kind]}
        if "baseline" in libs:
            fns = {"baseline": _bind(libs["baseline"],
                                     f"gnark_msm_leaf_prefix_{kind}", 3),
                   **fns}
        variants = {v: (lambda out, f=f: _checked(
            f, sx.data_ptr(), sy.data_ptr(), out.data_ptr(), nw, C, R))
            for v, f in fns.items()}

        def warps(v, sms):
            # the baseline's threads a chain are its own source's affair
            return nw * R * int(v[2:].split()[0]) / 32 / sms \
                if v.startswith("G=") else None
        yield (f"{kind} n={n} C={plan.C}",
               {"kind": kind, "n": n, "C": plan.C, "R": plan.R, "nw": nw},
               want, variants, warps)


def wsum_cases(libs, rng, device):
    """The same for the weighted sum, on the 2^16 plan's buckets."""
    for kind in ("g1", "g2"):
        plan, sx, sy, d_sorted = _inputs(kind, N, rng, device)
        GC = plan.GC
        rows = M.leaf_prefix_plain(sx, sy, GC)
        offs = M.lane_offsets_plain(plan.lane_totals(rows), GC)
        bk = plan._buckets(rows, offs, d_sorted)
        want = M.weighted_sum_plain(bk, GC)
        _, nw, nb = bk.shape
        # the most either version takes: nb + nb/2 + 1 points a window
        scratch = torch.empty(nw * (nb + nb // 2 + 1) * 3 * _cuda._L16[kind]
                              // 2, dtype=torch.int32, device=device)
        fns = {f"G={g} T={t} CL={cl}": _bind(
            _trials(libs), f"wsum_trial_{kind}_{g}_{t}_{cl}", 2)
            for g, t, cl in WSUM_SHAPES if g in WIDTHS[kind]}
        if "baseline" in libs:
            fns = {"baseline": _bind(libs["baseline"],
                                     f"gnark_msm_weighted_sum_{kind}", 2),
                   **fns}
        variants = {v: (lambda out, f=f: _checked(
            f, bk.data_ptr(), out.data_ptr(), scratch.data_ptr(), nw, nb))
            for v, f in fns.items()}

        def warps(v, sms):
            if "T=" not in v:
                return None
            t, cl = (int(x) for x in re.findall(r"[TL]=(\d+)", v))
            return nw * t * cl / 32 / sms
        yield (f"{kind} nw={nw} nb={nb}", {"kind": kind, "nw": nw, "nb": nb},
               want, variants, warps)


def _trials(libs):
    return {k: v for k, v in libs.items() if k != "baseline"}


def _ladder_inputs(rng, device, n=None):
    """n (N_LADDER) fp4 points 2^(i mod 64) G, 1 in 64 infinite, random
    scalars."""
    n = n or N_LADDER
    kind = "g2_bls24315"
    G, H, gen = _group(kind)
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = H.double(P)
    reps = -(-n // 64)
    xs = G.F.pack([p[0] for p in base], device).repeat(1, reps)[:, :n]
    ys = G.F.pack([p[1] for p in base], device).repeat(1, reps)[:, :n]
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    inf[::64] = True
    r_mod = BLS24_315.fr.modulus
    sc = torch.from_numpy(ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % r_mod for _ in range(n)],
        BN254.fr.L).astype(np.int64)).to(device)
    return (xs.contiguous(), ys.contiguous(), inf, sc), M.complete_ops(G)


def ladder_cases(libs, rng, device):
    """The same for the fp4 ladder at LADDER_SHAPES, on 4,096 points."""
    kind = "g2_bls24315"
    (xs, ys, inf, sc), GC = _ladder_inputs(rng, device)
    want = M.ladder_plain(xs, ys, inf, sc, GC)
    n, Ls = xs.shape[1], sc.shape[0]
    fns = {f"G={g} T={t} B={b}": _bind(
        _trials(libs), f"ladder_trial_{kind}_{g}_{t}_{b}", 2, ptrs=5)
        for g, t, b in LADDER_SHAPES}
    if "baseline" in libs:
        fns = {"baseline": _bind(libs["baseline"], f"gnark_msm_ladder_{kind}",
                                 2, ptrs=5), **fns}
    variants = {v: (lambda out, f=f: _checked(
        f, xs.data_ptr(), ys.data_ptr(), inf.data_ptr(), sc.data_ptr(),
        out.data_ptr(), n, Ls)) for v, f in fns.items()}

    def warps(v, sms):
        if "T=" not in v:
            return None
        g, t = (int(x) for x in re.findall(r"[GT]=(\d+)", v))
        return -(-n * M.LADDER_CHUNKS * g // t) * t / 32 / sms
    yield (f"{kind} n={n}", {"kind": kind, "n": n}, want, variants, warps)


def fold_cases(libs, rng, device):
    """The same for the fp4 Horner fold at FOLD_GROUPS: on the 2^16
    plan's window sums, and on the chunk sums of the ladder's 4,096
    points (nw = 16, c = 16)."""
    kind = "g2_bls24315"
    plan, sx, sy, d_sorted = _inputs(kind, N, rng, device)
    GC = plan.GC
    rows = M.leaf_prefix_plain(sx, sy, GC)
    offs = M.lane_offsets_plain(plan.lane_totals(rows), GC)
    S = M.weighted_sum_plain(plan._buckets(rows, offs, d_sorted), GC)
    lad, _ = _ladder_inputs(rng, device)
    T = M.reduce_plain(M.ladder_plain(*lad, GC), GC)
    for label, sums, c in ((f"plan n={N} nw={S.shape[1]} c={plan.c}", S,
                            plan.c),
                           (f"chunks nw={T.shape[1]} c=16", T, 16)):
        sums = sums.contiguous()
        want = M.horner_fold_plain(sums, c, GC)
        fns = {f"G={g}": _bind(_trials(libs), f"fold_trial_{kind}_{g}", 2,
                               ptrs=2) for g in FOLD_GROUPS}
        if "baseline" in libs:
            fns = {"baseline": _bind(libs["baseline"],
                                     f"gnark_msm_horner_fold_{kind}", 2,
                                     ptrs=2), **fns}
        variants = {v: (lambda out, f=f, sums=sums, c=c: _checked(
            f, sums.data_ptr(), out.data_ptr(), sums.shape[1], c))
            for v, f in fns.items()}
        yield (f"{kind} {label}", {"kind": kind, "nw": sums.shape[1],
                                   "c": c}, want, variants,
               lambda v, sms: None)


def _groups_variants(libs, kernel, shapes, args, baseline):
    """{shape label: fn(out) -> launch} of the fp4 weighted sum's,
    reduction's or lane offsets' trials (and the baseline) on args =
    (input, its two ints, scratch, clusters a launch: nw or K), and
    warps(label, SMs): a launch's clusters x CL blocks x T threads, in
    warps an SM."""
    a, x, y, scratch, clusters = args
    name = _GROUPS_TRIALS[kernel][0]
    fns = {f"G={g} T={t} CL={cl}": _bind(
        _trials(libs), f"{name}_trial_g2_bls24315_{g}_{t}_{cl}", 2)
        for g, t, cl in shapes}
    if "baseline" in libs:
        fns = {"baseline": _bind(libs["baseline"], baseline, 2), **fns}
    variants = {v: (lambda out, f=f: _checked(
        f, a.data_ptr(), out.data_ptr(), scratch.data_ptr(), x, y))
        for v, f in fns.items()}

    def warps(v, sms):
        if "T=" not in v:
            return None
        t, cl = (int(z) for z in re.findall(r"[TL]=(\d+)", v))
        return clusters * t * cl / 32 / sms
    return variants, warps


def wsum_fp4_cases(libs, rng, device):
    """The fp4 weighted sum at WSUM_FP4_SHAPES, on the 2^16 plan's
    buckets (24 windows of 1,024), made by the plain leaf, lane offsets
    and bucket steps on the card."""
    kind = "g2_bls24315"
    plan, sx, sy, d_sorted = _inputs(kind, N, rng, device)
    GC = plan.GC
    rows = M.leaf_prefix_plain(sx, sy, GC)
    offs = M.lane_offsets_plain(plan.lane_totals(rows), GC)
    bk = plan._buckets(rows, offs, d_sorted)
    want = M.weighted_sum_plain(bk, GC)
    _, nw, nb = bk.shape
    scratch = torch.empty(nw * (nb + nb // 2) * 3 * _cuda._L16[kind] // 2,
                          dtype=torch.int32, device=device)
    variants, warps = _groups_variants(
        libs, "weighted_sum", WSUM_FP4_SHAPES, (bk, nw, nb, scratch, nw),
        f"gnark_msm_weighted_sum_{kind}")
    yield (f"{kind} nw={nw} nb={nb}", {"kind": kind, "nw": nw, "nb": nb},
           want, variants, warps)


def reduce_cases(libs, rng, device):
    """The fp4 reduction at REDUCE_SHAPES, on the plain ladder's output at
    N_LADDER points (16 chunks), as chip_smoke.py's phase 8 runs it."""
    kind = "g2_bls24315"
    lad, GC = _ladder_inputs(rng, device)
    pts = M.ladder_plain(*lad, GC)
    want = M.reduce_plain(pts, GC)
    _, K, n = pts.shape
    scratch = torch.empty(K * _cuda.REDUCE_LANES * 3 * _cuda._L16[kind] // 2,
                          dtype=torch.int32, device=device)
    variants, warps = _groups_variants(
        libs, "reduce", REDUCE_SHAPES, (pts, n, K, scratch, K),
        f"gnark_msm_reduce_{kind}")
    yield (f"{kind} n={n} K={K}", {"kind": kind, "n": n, "K": K}, want,
           variants, warps)


def lanes_fp4_cases(libs, rng, device):
    """The fp4 lane offsets at LANES_FP4_SHAPES, on the 2^16 plan's lane
    totals (24 windows of 512), made by the plain leaf on the card; the
    baseline (the template's Brent-Kung scan) is held against the same
    plain version."""
    kind = "g2_bls24315"
    plan, sx, sy, _ = _inputs(kind, N, rng, device)
    tot = plan.lane_totals(M.leaf_prefix_plain(sx, sy, plan.GC))
    want = M.lane_offsets_plain(tot, plan.GC)
    _, nw, R = tot.shape
    scratch = torch.empty(nw * R * 3 * _cuda._L16[kind] // 2,
                          dtype=torch.int32, device=device)
    variants, warps = _groups_variants(
        libs, "lane_offsets", LANES_FP4_SHAPES, (tot, nw, R, scratch, nw),
        f"gnark_msm_lane_offsets_{kind}")
    yield (f"{kind} nw={nw} R={R}", {"kind": kind, "nw": nw, "R": R}, want,
           variants, warps)


def hillis_steele_plain(tot, GC):
    """The lane offsets by the Hillis-Steele scan of the kernel before the
    Brent-Kung one (and of gnark_tpu's): the same points, other
    representatives, so the baseline's yardstick.  Step s adds lane r - s
    to lane r, the identity (0 : 1 : 0) rolled in below s."""
    L, R = GC.F.L, tot.shape[-1]
    P = M.split_points(tot, L)
    ident = GC.inf(tot.shape[1:], tot.device)
    s = 1
    while s < R:
        P = GC.add(P, tuple(torch.cat([i[..., :s], a[..., :R - s]], -1)
                            for i, a in zip(ident, P)))
        s *= 2
    return torch.cat([torch.cat([i[..., :1], a[..., :R - 1]], -1)
                      for i, a in zip(ident, P)])


def lanes_cases(libs, rng, device):
    """The same for the lane offsets, on the 2^16 plan's lane totals; the
    baseline is held against hillis_steele_plain."""
    for kind in ("g1", "g2"):
        plan, sx, sy, _ = _inputs(kind, N, rng, device)
        tot = plan.lane_totals(M.leaf_prefix_plain(sx, sy, plan.GC))
        new = M.lane_offsets_plain(tot, plan.GC)
        old = hillis_steele_plain(tot, plan.GC)

        def want(v, new=new, old=old):
            return old if v == "baseline" else new
        _, nw, R = tot.shape
        # the most either version takes: the parent's two buffers
        scratch = torch.empty(2 * nw * R * 3 * _cuda._L16[kind] // 2,
                              dtype=torch.int32, device=device)
        fns = {f"G={g} T={t} CL={cl}": _bind(
            _trials(libs), f"lanes_trial_{kind}_{g}_{t}_{cl}", 2)
            for g, t, cl in LANES_SHAPES if g in WIDTHS[kind]}
        if "baseline" in libs:
            fns = {"baseline": _bind(libs["baseline"],
                                     f"gnark_msm_lane_offsets_{kind}", 2),
                   **fns}
        variants = {v: (lambda out, f=f: _checked(
            f, tot.data_ptr(), out.data_ptr(), scratch.data_ptr(), nw, R))
            for v, f in fns.items()}

        def warps(v, sms):
            if "T=" not in v:
                return None
            t, cl = (int(x) for x in re.findall(r"[TL]=(\d+)", v))
            return nw * t * cl / 32 / sms
        yield (f"{kind} nw={nw} R={R}", {"kind": kind, "nw": nw, "R": R},
               want, variants, warps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(_TU) + ("ladder", "horner_fold",
                                                      "reduce"),
                    default="leaf_prefix")
    ap.add_argument("--csrc", default=_cuda._CSRC, help="the csrc "
                    "directory whose kernel runs at each shape")
    ap.add_argument("--baseline", help="a csrc directory whose "
                    "msm_kernels.cu is timed beside the shapes")
    ap.add_argument("--kind", choices=("g2_bls24315",), help="sweep this "
                    "kind's leaf (SLICED_SHAPES), weighted sum "
                    "(WSUM_FP4_SHAPES) or lane offsets (LANES_FP4_SHAPES) "
                    "instead of BN254's; the ladder, the fold and the "
                    "reduction take it alone")
    ap.add_argument("--out", help="write the numbers here as JSON")
    args = ap.parse_args(argv)
    fp4 = args.kernel in ("ladder", "horner_fold", "reduce")
    if fp4 and not args.kind:
        ap.error(f"--kernel {args.kernel} sweeps --kind g2_bls24315")
    if not torch.cuda.is_available():
        raise SystemExit("leaf_groups needs a CUDA card")
    device = torch.device("cuda", 0)
    os.makedirs(_cuda._BUILD, exist_ok=True)
    jobs = {}
    for name, source in trial_units(args.kernel, args.kind).items():
        tu = os.path.join(_cuda._BUILD,
                          f"{args.kernel}_{name}_{os.getpid()}.cu")
        with open(tu, "w") as f:
            f.write(source)
        jobs[name] = (tu, os.path.abspath(args.csrc))
    if args.baseline:
        base = os.path.abspath(args.baseline)
        lib = "msm_g2_bls24315.cu" if args.kind else "msm_kernels.cu"
        jobs["baseline"] = (os.path.join(base, lib), base)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda j: _build(f"{args.kernel}_{j}", *jobs[j]), jobs)))
    libs = {k: ctypes.CDLL(path) for k, (path, _) in built.items()}
    kernels = ((f"{'leaf' if args.kernel == 'leaf_prefix' else args.kernel}"
                "_sliced", args.kernel) if args.kind else (args.kernel,))
    ptxas = {}
    for k, (_, report) in built.items():
        for kernel in kernels:
            for name, line in kernel_registers(report, kernel).items():
                ptxas[f"{k} {kernel} {name}"] = line
                print(f"[leaf_groups] ptxas {k} {kernel} {name}: {line}",
                      flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[leaf_groups] card: {card}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)
    result = {"card": card, "kernel": args.kernel, "kind": args.kind,
              "ptxas": ptxas, "cases": []}
    cases = {"leaf_prefix": leaf_cases, "weighted_sum": wsum_cases,
             "lane_offsets": lanes_cases, "ladder": ladder_cases,
             "horner_fold": fold_cases, "reduce": reduce_cases}[args.kernel]
    if args.kind and args.kernel == "leaf_prefix":
        cases = functools.partial(leaf_cases, kind=args.kind)
    if args.kind and args.kernel == "weighted_sum":
        cases = wsum_fp4_cases
    if args.kind and args.kernel == "lane_offsets":
        cases = lanes_fp4_cases
    for label, case, want, variants, warps in cases(libs, rng, device):
        times = {v: [] for v in variants}
        order = list(variants)
        for rnd in (order, order[::-1]):
            for v in rnd:
                expect = want(v) if callable(want) else want
                out = torch.empty_like(expect)
                times[v].append(_time(variants[v](out)))
                assert torch.equal(out, expect), f"{label} {v} != plain"
        case["ms"] = {}
        for v, ts in times.items():
            case["ms"][v] = sum(ts) / len(ts)
            w = warps(v, sms)
            print(f"[leaf_groups] {args.kernel} {label} {v}: bit-exact "
                  f"(tolerance 0), {case['ms'][v]:.3f} ms (rounds "
                  f"{', '.join(f'{t:.3f}' for t in ts)})"
                  + (f", {w:.2f} warps an SM" if w is not None else ""),
                  flush=True)
        result["cases"].append(case)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
