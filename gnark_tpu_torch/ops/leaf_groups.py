"""The leaf prefix kernel at several thread-group widths, on one card.

    python -m gnark_tpu_torch.ops.leaf_groups [--csrc DIR] [--baseline DIR]
                                              [--out FILE]

Builds one library that instantiates ``leaf_prefix_kernel<Curve, G>``
(csrc/msm_kernels.cu, or that of ``--csrc``) for G1 at G = 2, 4, 8 and
G2 at G = 4, 8, 16, and,
with ``--baseline``, the ``msm_kernels.cu`` of another version of the
kernels (a ``csrc`` directory), the two compilers side by side.  Then, at
the 2^16 plan's shapes (c = 11, 24 windows, R = 512, C = 128; 1 point in
64 infinite, as in chip_smoke.py) for G1 and G2, and at a PLONK
commitment's 2^16 + 3 points (C = 129) for G1, it holds every width (and
the baseline) against ``leaf_prefix_plain`` on the same CUDA tensors, bit
for bit, and times each with CUDA events: 3 launches after a warm-up, in
two rounds, the second in the reverse order, so that the baseline runs
first and last.  Prints one line a width and, with ``--out``, writes the
numbers as JSON.  The width that ships is ``G1/G2::LEAF_GROUP``.
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
N = 1 << 16
SEED = 7
REPS = 3

_TU = """#include "msm_kernels.cu"
#define TRIAL(NAME, CURVE, G)                                               \\
  extern "C" int leaf_trial_##NAME##_##G(const void* sx, const void* sy,    \\
      void* rows, int nw, int C, int R, void* stream) {                     \\
    return launch_leaf_prefix<CURVE, G>(sx, sy, rows, nw, C, R, stream);    \\
  }
""" + "".join(f"TRIAL({k}, {k.upper()}, {g})\n"
              for k, ws in WIDTHS.items() for g in ws)


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


def leaf_registers(report):
    """'G1 G=4' (or 'G1' for a kernel without a width) -> the ptxas line
    of each leaf_prefix_kernel instantiation."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for _Z\d+leaf_prefix_kernelI2"
                      r"(G[12])(?:Li(\d+)E)?E", line)
        if "Function properties for" in line:
            name = (f"{m.group(1)} G={m.group(2)}" if m and m.group(2)
                    else m.group(1) if m else None)
        elif name and (r := re.search(r"Used (\d+) registers", line)):
            out[name] = line.strip()
            name = None
    return out


def _bind(lib, fn):
    f = getattr(lib, fn)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [vp, vp, vp, ci, ci, ci, vp]
    f.restype = ci
    return f


def _inputs(kind, n, rng, device):
    """The 2^16 plan's (or n points') sorted leaf inputs: point i =
    2^(i mod 64) G, random scalars, 1 point in 64 infinite."""
    if kind == "g1":
        G, H, gen = (CurveOps(field_ops(BN254.fp), b=BN254.b),
                     BN254.host_g1, BN254.g1_gen)
    else:
        G, H, gen = (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
                     BN254.host_g2, BN254.g2_gen)
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
    sx, sy, _ = plan._sort_gather(*plan._prep_window(
        xs.contiguous(), ys.contiguous(), inf, sc))
    return plan, sx, sy


def _time(fn, sx, sy, rows, stream):
    nw, C, _, R = sx.shape

    def launch():
        rc = fn(sx.data_ptr(), sy.data_ptr(), rows.data_ptr(), nw, C, R,
                stream)
        if rc:
            raise RuntimeError(f"leaf launch failed, cudaError {rc}")

    launch()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=_cuda._CSRC, help="the csrc "
                    "directory whose leaf kernel runs at each width")
    ap.add_argument("--baseline", help="a csrc directory whose "
                    "msm_kernels.cu is timed beside the widths")
    ap.add_argument("--out", help="write the numbers here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("leaf_groups needs a CUDA card")
    device = torch.device("cuda", 0)
    tu = os.path.join(_cuda._BUILD, f"leaf_groups_{os.getpid()}.cu")
    os.makedirs(_cuda._BUILD, exist_ok=True)
    with open(tu, "w") as f:
        f.write(_TU)
    jobs = {"leaf_groups": (tu, os.path.abspath(args.csrc))}
    if args.baseline:
        base = os.path.abspath(args.baseline)
        jobs["leaf_baseline"] = (os.path.join(base, "msm_kernels.cu"), base)
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _build(j, *jobs[j]), jobs)))
    libs = {k: ctypes.CDLL(path) for k, (path, _) in built.items()}
    for k, (_, report) in built.items():
        for name, line in leaf_registers(report).items():
            print(f"[leaf_groups] ptxas {k} {name}: {line}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[leaf_groups] card: {card}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(SEED)
    result = {"card": card, "cases": []}
    for kind, n in (("g1", N), ("g2", N), ("g1", N + 3)):
        plan, sx, sy = _inputs(kind, n, rng, device)
        want = M.leaf_prefix_plain(sx, sy, plan.GC)
        variants = {f"G={g}": _bind(libs["leaf_groups"],
                                    f"leaf_trial_{kind}_{g}")
                    for g in WIDTHS[kind]}
        if "leaf_baseline" in libs:
            variants = {"baseline": _bind(libs["leaf_baseline"],
                                          f"gnark_msm_leaf_prefix_{kind}"),
                        **variants}
        times = {v: [] for v in variants}
        order = list(variants)
        for rnd in (order, order[::-1]):
            for v in rnd:
                rows = torch.empty_like(want)
                times[v].append(_time(variants[v], sx, sy, rows, stream))
                assert torch.equal(rows, want), f"{kind} n={n} {v} != plain"
        case = {"kind": kind, "n": n, "C": plan.C, "R": plan.R,
                "nw": plan.nwin, "ms": {}}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for v, ts in times.items():
            case["ms"][v] = sum(ts) / len(ts)
            # the baseline's threads a chain are its own source's affair
            warps = (f", {plan.nwin * plan.R * int(v[2:]) / 32 / sms:.1f} "
                     f"warps an SM" if v.startswith("G=") else "")
            print(f"[leaf_groups] {kind} n={n} C={plan.C} {v}: bit-exact "
                  f"(tolerance 0), {case['ms'][v]:.3f} ms (rounds "
                  f"{', '.join(f'{t:.3f}' for t in ts)}){warps}", flush=True)
        result["cases"].append(case)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
