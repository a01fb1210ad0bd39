"""A group kernel at several thread-group widths and block sizes, on one card.

    python -m gnark_tpu_torch.ops.leaf_groups [--kernel leaf_prefix|weighted_sum]
                                              [--csrc DIR] [--baseline DIR]
                                              [--out FILE]

Builds one library that instantiates the kernel of ``csrc/msm_kernels.cu``
(or that of ``--csrc``) at each trial shape and, with ``--baseline``, the
``msm_kernels.cu`` of another version of the kernels (a ``csrc``
directory), the two compilers side by side:

  * ``leaf_prefix`` (the default): ``leaf_prefix_kernel<Curve, G>`` for G1
    at G = 2, 4, 8 and G2 at G = 4, 8, 16, at the 2^16 plan's shapes (c =
    11, 24 windows, R = 512, C = 128; 1 point in 64 infinite, as in
    chip_smoke.py) for G1 and G2, and at a PLONK commitment's 2^16 + 3
    points (C = 129) for G1;
  * ``weighted_sum``: ``weighted_sum_kernel<Curve, G, THREADS, CLUSTER>``
    for G1 at G = 2, 4, 8 and G2 at G = 4, 8, 16, each in blocks of 128,
    256 and 512 threads, the last two also in clusters of 2, 4 and 8
    blocks a window, on the 2^16 plan's buckets (24 windows of 1,024) for
    G1 and G2, made by the plain leaf, lane offsets and bucket steps on
    the card.

Every shape (and the baseline) is held against the plain version on the
same CUDA tensors, bit for bit, and timed with CUDA events: 3 launches
after a warm-up, in two rounds, the second in the reverse order, so that
the baseline runs first and last.  Prints each kernel's ptxas line and
one line a shape and, with ``--out``, writes the numbers as JSON.  The
shapes that ship are ``G1/G2::LEAF_GROUP`` and ``WSUM_GROUP``,
``WSUM_THREADS``, ``WSUM_CLUSTER``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M
from gnark_tpu_torch.ops.ec import CurveOps
from gnark_tpu_torch.ops.limbs import field_ops, ints_to_limbs
from gnark_tpu_torch.ops.towers import fp2_ops

WIDTHS = {"g1": (2, 4, 8), "g2": (4, 8, 16)}
BLOCKS = (128, 256, 512)      # the weighted sum's threads a block
CLUSTERS = (1, 2, 4, 8)       # and its blocks a window, from 256 threads
WSUM_SHAPES = [(g, t, cl) for g in (2, 4, 8, 16) for t in BLOCKS
               for cl in (CLUSTERS if t >= 256 else (1,))]
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
    """'G1 G=4' ('G1 G=4 T=256 CL=4' for the weighted sum, 'G1' for a kernel
    without a width) -> the stack and register lines of each instantiation
    of ``{kernel}_kernel``."""
    out, name, props = {}, None, ""
    for line in report.splitlines():
        m = re.search(rf"Function properties for _Z\d+{kernel}_kernelI2"
                      r"(G[12])((?:Li\d+E)*)E", line)
        if "Function properties for" in line:
            name = None
            if m:
                ints = re.findall(r"Li(\d+)E", m.group(2))
                name = " ".join([m.group(1)] + [
                    f"{k}={v}" for k, v in zip(("G", "T", "CL"), ints)])
            props = ""
        elif name and "stack frame" in line:
            props = line.strip() + "; "
        elif name and re.search(r"Used (\d+) registers", line):
            out[name] = props + line.strip()
            name = None
    return out


def _bind(lib, fn, ints):
    """A launcher of three pointers, ``ints`` ints and the stream."""
    f = getattr(lib, fn)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [vp] * 3 + [ci] * ints + [vp]
    f.restype = ci
    return f


def _group(kind):
    if kind == "g1":
        return (CurveOps(field_ops(BN254.fp), b=BN254.b), BN254.host_g1,
                BN254.g1_gen)
    return (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
            BN254.host_g2, BN254.g2_gen)


def _inputs(kind, n, rng, device):
    """The 2^16 plan's (or n points') sorted leaf inputs: point i =
    2^(i mod 64) G, random scalars, 1 point in 64 infinite."""
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
    scalars = [int.from_bytes(rng.bytes(32), "little") % BN254.fr.modulus
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


def leaf_cases(libs, rng, device):
    """(label, case, want, {shape: fn(out) -> launch}, warps an SM of a
    shape or None) for each leaf case."""
    for kind, n in (("g1", N), ("g2", N), ("g1", N + 3)):
        plan, sx, sy, _ = _inputs(kind, n, rng, device)
        want = M.leaf_prefix_plain(sx, sy, plan.GC)
        nw, C, _, R = sx.shape
        fns = {f"G={g}": _bind(libs["trial"], f"leaf_trial_{kind}_{g}", 3)
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
            return nw * R * int(v[2:]) / 32 / sms if v.startswith("G=") \
                else None
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
            libs["trial"], f"wsum_trial_{kind}_{g}_{t}_{cl}", 2)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("leaf_prefix", "weighted_sum"),
                    default="leaf_prefix")
    ap.add_argument("--csrc", default=_cuda._CSRC, help="the csrc "
                    "directory whose kernel runs at each shape")
    ap.add_argument("--baseline", help="a csrc directory whose "
                    "msm_kernels.cu is timed beside the shapes")
    ap.add_argument("--out", help="write the numbers here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("leaf_groups needs a CUDA card")
    device = torch.device("cuda", 0)
    leaf = args.kernel == "leaf_prefix"
    tu = os.path.join(_cuda._BUILD, f"{args.kernel}_trial_{os.getpid()}.cu")
    os.makedirs(_cuda._BUILD, exist_ok=True)
    with open(tu, "w") as f:
        f.write(_LEAF_TU if leaf else _WSUM_TU)
    jobs = {"trial": (tu, os.path.abspath(args.csrc))}
    if args.baseline:
        base = os.path.abspath(args.baseline)
        jobs["baseline"] = (os.path.join(base, "msm_kernels.cu"), base)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda j: _build(f"{args.kernel}_{j}", *jobs[j]), jobs)))
    libs = {k: ctypes.CDLL(path) for k, (path, _) in built.items()}
    for k, (_, report) in built.items():
        for name, line in kernel_registers(report, args.kernel).items():
            print(f"[leaf_groups] ptxas {k} {name}: {line}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[leaf_groups] card: {card}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)
    result = {"card": card, "kernel": args.kernel, "cases": []}
    cases = leaf_cases if leaf else wsum_cases
    for label, case, want, variants, warps in cases(libs, rng, device):
        times = {v: [] for v in variants}
        order = list(variants)
        for rnd in (order, order[::-1]):
            for v in rnd:
                out = torch.empty_like(want)
                times[v].append(_time(variants[v](out)))
                assert torch.equal(out, want), f"{label} {v} != plain"
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
