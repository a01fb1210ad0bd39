"""BLS24-315 G2's fp4 product inlined or called, on one card.

    python -m gnark_tpu_torch.ops.inline_check [--sanitizer] [--out FILE]

Builds one small library of ``csrc/msm_kernels.cu``'s BLS24-315 G2 code
(the ladder and reduction kernels, and one-thread-an-element kernels of
the fp4 product, the complete addition and the doubling) in three builds,
the compilers side by side:

  * ``inlined``: as the MSM library ships, the fp4 product (``mul`` of
    ``FpK``, csrc/field.cuh) inlined at its call sites;
  * ``called``: the same source with ``GT_FPK_MUL`` a ``__noinline__``
    function;
  * ``called_O0``: ``called`` with ptxas at -O0.

Each build is held against the plain PyTorch versions on the same CUDA
tensors, bit for bit: the product, the addition and the doubling over
4,096 random elements and points (the identity, P + P and P + (-P) among
them), the ladder over 4,096 points (1 in 64 infinite, random scalars)
and over one block's 4 points, each launched twice to see that it gives
the same limbs each time, and the reduction of the plain ladder's output.
A ladder that disagrees is described by the (chunk, point) columns that
differ, their positions in a block, and whether the kernel's point there
is the plain version's point in other coordinates.  Prints each build's
ptxas lines and ``cuobjdump -res-usage``, one JSON line a build and, with
``--out``, writes them.  ``--sanitizer`` also runs each build's ladder
over 8 points under ``compute-sanitizer`` (memcheck, initcheck,
racecheck) and prints the end of its report.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import msm as M

KIND = "g2_bls24315"
N = 4096
SEED = 11
BUILDS = {
    "inlined": [],
    "called": ["-DGT_FPK_MUL=__host__ __device__ __noinline__"],
    "called_O0": ["-DGT_FPK_MUL=__host__ __device__ __noinline__",
                  "-Xptxas", "-O0"],
}

_TU = r"""#define GNARK_MSM_BLS24315
#include "msm_kernels.cu"
using Cv = G2Bls24;
using F = Cv::F;
using IO = FieldIO<F>;

__global__ void mul_kernel(const int64_t* a, const int64_t* b, int64_t* o,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store(mul(IO::load(a + i, n), IO::load(b + i, n)), o + i, n);
}
__global__ void padd_kernel(const int64_t* p, const int64_t* q, int64_t* o,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    store_point<Cv>(padd<Cv>(load_point<Cv>(p + i, n),
                             load_point<Cv>(q + i, n)), o + i, n);
}
__global__ void pdbl_kernel(const int64_t* p, int64_t* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store_point<Cv>(pdbl<Cv>(load_point<Cv>(p + i, n)), o + i, n);
}
extern "C" int check_mul(const void* a, const void* b, void* o, int n) {
  mul_kernel<<<(n + 63) / 64, 64>>>((const int64_t*)a, (const int64_t*)b,
                                    (int64_t*)o, n);
  return (int)cudaGetLastError();
}
extern "C" int check_padd(const void* p, const void* q, void* o, int n) {
  padd_kernel<<<(n + 63) / 64, 64>>>((const int64_t*)p, (const int64_t*)q,
                                     (int64_t*)o, n);
  return (int)cudaGetLastError();
}
extern "C" int check_pdbl(const void* p, void* o, int n) {
  pdbl_kernel<<<(n + 63) / 64, 64>>>((const int64_t*)p, (int64_t*)o, n);
  return (int)cudaGetLastError();
}
extern "C" int check_ladder(const void* xs, const void* ys, const void* inf,
                            const void* sc, void* out, int n, int Ls) {
  ladder_kernel<Cv><<<(n + Cv::LADDER_POINTS - 1) / Cv::LADDER_POINTS,
                      ladder_threads<Cv>()>>>(
      (const int64_t*)xs, (const int64_t*)ys, (const uint8_t*)inf,
      (const int64_t*)sc, (int64_t*)out, n, Ls);
  return (int)cudaGetLastError();
}
extern "C" int check_reduce(const void* pts, void* out, void* scratch, int n,
                            int K) {
  reduce_kernel<Cv><<<K, REDUCE_LANES>>>((const int64_t*)pts, (int64_t*)out,
                                         (Point<F>*)scratch, n, K);
  return (int)cudaGetLastError();
}
GNARK_MSM_SHAPE(g2_bls24315, G2Bls24)
"""


def _build(name, flags, out_dir):
    src = os.path.join(out_dir, "inline_check.cu")
    lib = os.path.join(out_dir, f"libinline_check_{name}.so")
    cmd = [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", *flags, f"-I{_cuda._CSRC}", "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{res.stdout}\n{res.stderr}")
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "stack frame" in ln]
    return lib, ptxas


def _res_usage(lib):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ["cuobjdump not found"]
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True)
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if ln.strip()]


def _bind(path):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, args in (("mul", [vp, vp, vp, ci]),
                       ("padd", [vp, vp, vp, ci]), ("pdbl", [vp, vp, ci]),
                       ("ladder", [vp, vp, vp, vp, vp, ci, ci]),
                       ("reduce", [vp, vp, vp, ci, ci])):
        fn = getattr(lib, f"check_{name}")
        fn.argtypes, fn.restype = args, ci
    return lib


def _shape(lib):
    return _cuda.read_shape(getattr(lib, f"gnark_msm_shape_{KIND}"))


def _call(fn, *args):
    rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: launch failed, cudaError {rc}")
    torch.cuda.synchronize()


def _group():
    from gnark_tpu_torch.backend.groth16 import _Groups
    from gnark_tpu_torch.curves import BLS24_315
    return _Groups(BLS24_315).g2, BLS24_315


def _inputs(device, seed=SEED, n=N):
    """Random fp4 elements and points (multiples of the generator, with the
    identity, P + P and P + (-P) among the pairs), the ladder's points
    (1 in 64 infinite) and scalars, all on ``device``."""
    from gnark_tpu_torch.ops.limbs import ints_to_limbs
    G, curve = _group()
    GC = M.complete_ops(G)
    rng = np.random.default_rng(seed)
    p, r = curve.fp.modulus, curve.fr.modulus

    def rand(k):
        return int.from_bytes(rng.bytes(k), "little")

    a = G.F.pack([tuple(rand(40) % p for _ in range(4)) for _ in range(n)],
                 device)
    b = G.F.pack([tuple(rand(40) % p for _ in range(4)) for _ in range(n)],
                 device)
    host, pts, P = curve.host_g2, [], curve.g2_gen
    for _ in range(64):
        pts.append(P)
        P = host.add(P, host.double(P))
    reps = n // 64
    xs = G.F.pack([q[0] for q in pts], device).repeat(1, reps)
    ys = G.F.pack([q[1] for q in pts], device).repeat(1, reps)
    one = G.F.ones(n, device)
    Pj = torch.cat([xs, ys, one])
    Qj = Pj.roll(1, -1).clone()
    L = G.F.L
    Qj[:, 1::8] = Pj[:, 1::8]                                 # P + P
    neg = torch.cat(GC.neg(M.split_points(Pj[:, 2::8].contiguous(), L)))
    Qj[:, 2::8] = neg                                         # P + (-P)
    Qj[:, 3::8] = torch.cat(GC.inf((n // 8,), device))        # P + O
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    inf[::64] = True
    sc = torch.from_numpy(ints_to_limbs([rand(32) % r for _ in range(n)],
                                        curve.fr.L).astype(np.int64))
    return GC, a, b, Pj, Qj.contiguous(), xs, ys, inf, sc.to(device)


def _same_point(GC, u, v):
    """Projective u and v ([3L] each) as the same point: X1 Z2 = X2 Z1
    and Y1 Z2 = Y2 Z1."""
    F, L = GC.F, GC.F.L
    X1, Y1, Z1 = (t[:, None] for t in M.split_points(u, L))
    X2, Y2, Z2 = (t[:, None] for t in M.split_points(v, L))
    return bool(torch.equal(F.mul(X1, Z2), F.mul(X2, Z1))
                and torch.equal(F.mul(Y1, Z2), F.mul(Y2, Z1)))


def _ladder_report(GC, lib, xs, ys, inf, sc):
    n, Ls = xs.shape[1], sc.shape[0]
    L3 = 3 * GC.F.L
    want = M.ladder_plain(xs, ys, inf, sc, GC)
    runs = []
    for _ in range(2):
        out = torch.empty((L3, M.LADDER_CHUNKS, n), dtype=torch.int64,
                          device=xs.device)
        _call(lib.check_ladder, xs, ys, inf.to(torch.uint8), sc, out, n, Ls)
        runs.append(out)
    bad = (runs[0] != want).any(0)                           # [K, n]
    cols = bad.nonzero().tolist()
    pts = int(bad.any(0).sum())
    block = _shape(lib)["ladder_points"]
    same = [_same_point(GC, runs[0][:, j, i], want[:, j, i])
            for j, i in cols[:8]]
    return want, {
        "n": n, "equal": not cols,
        "repeatable": bool(torch.equal(runs[0], runs[1])),
        "columns_differing": len(cols), "points_differing": pts,
        "chunks_differing": sorted({j for j, _ in cols}),
        "position_in_block": sorted({i % block for _, i in cols}),
        "infinite_among_them": int(inf[[i for _, i in cols]].sum())
        if cols else 0,
        "first_columns": cols[:8], "same_point_other_coordinates": same}


def check(path, device):
    """One build against the plain versions: {check: result}."""
    lib = _bind(path)
    GC, a, b, Pj, Qj, xs, ys, inf, sc = _inputs(device)
    F = GC.F
    out = {}
    got = torch.empty_like(a)
    _call(lib.check_mul, a, b, got, a.shape[1])
    out["mul"] = int((got != F.mul(a, b)).any(0).sum())
    got = torch.empty_like(Pj)
    _call(lib.check_padd, Pj, Qj, got, Pj.shape[1])
    L = F.L
    want = torch.cat(GC.add(M.split_points(Pj, L), M.split_points(Qj, L)))
    out["padd"] = int((got != want).any(0).sum())
    _call(lib.check_pdbl, Pj, got, Pj.shape[1])
    want = torch.cat(GC.double(M.split_points(Pj, L)))
    out["pdbl"] = int((got != want).any(0).sum())
    lad, out["ladder"] = _ladder_report(GC, lib, xs, ys, inf, sc)
    block = _shape(lib)["ladder_points"]
    _, out["ladder_one_block"] = _ladder_report(
        GC, lib, xs[:, 1:block + 1].contiguous(),
        ys[:, 1:block + 1].contiguous(), inf[1:block + 1].contiguous(),
        sc[:, 1:block + 1].contiguous())
    K = M.LADDER_CHUNKS
    red = torch.empty((3 * L, K), dtype=torch.int64, device=device)
    nbytes = K * _cuda.REDUCE_LANES * _shape(lib)["point_bytes"]
    scratch = torch.empty((nbytes + 3) // 4, dtype=torch.int32, device=device)
    _call(lib.check_reduce, lad, red, scratch, lad.shape[2], K)
    out["reduce_equal"] = bool(torch.equal(red, M.reduce_plain(lad, GC)))
    return out


def _child(path):
    """The ladder over 8 points, once, for compute-sanitizer."""
    lib = _bind(path)
    GC, _, _, _, _, xs, ys, inf, sc = _inputs("cuda", n=64)
    n = 8
    out = torch.empty((3 * GC.F.L, M.LADDER_CHUNKS, n), dtype=torch.int64,
                      device="cuda")
    _call(lib.check_ladder, xs[:, :n].contiguous(), ys[:, :n].contiguous(),
          inf[:n].to(torch.uint8).contiguous(), sc[:, :n].contiguous(),
          out, n, sc.shape[0])


def _sanitize(path):
    """Each compute-sanitizer tool over the ladder of 8 points: its exit
    code, its own lines (``=========``) and the end of the program's
    output; stops at the first run that prints no error summary (the tool
    did not run)."""
    tool = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        return {"error": "compute-sanitizer not found"}
    report = {}
    for t in ("memcheck", "initcheck", "racecheck"):
        cmd = [tool, "--tool", t, "--kernel-name", "kns=ladder_kernel",
               sys.executable, "-m", "gnark_tpu_torch.ops.inline_check",
               "--child", path]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=180)
            lines = (res.stdout + res.stderr).strip().splitlines()
            report[t] = {"rc": res.returncode,
                         "report": [ln for ln in lines
                                    if ln.startswith("=========")][:40],
                         "tail": lines[-3:]}
            if not any("ERROR SUMMARY" in ln for ln in lines):
                break
        except subprocess.TimeoutExpired:
            report[t] = {"rc": None, "report": ["timed out after 180 s"],
                         "tail": []}
            break
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sanitizer", action="store_true")
    ap.add_argument("--out", help="write the results here as JSON")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("inline_check: CUDA is not available")
    if args.child:
        _child(args.child)
        return
    out_dir = os.path.join(_cuda._BUILD, "inline_check")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "inline_check.cu"), "w") as f:
        f.write(_TU)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        built = dict(zip(BUILDS, pool.map(
            lambda kv: _build(kv[0], kv[1], out_dir), BUILDS.items())))
    results, sanitizer_runs = {}, True
    device = torch.device("cuda", 0)
    for name, (path, ptxas) in built.items():
        for line in ptxas:
            print(f"[ptxas {name}] {line}", flush=True)
        for line in _res_usage(path):
            print(f"[res-usage {name}] {line}", flush=True)
        r = {"build": name, **check(path, device)}
        if args.sanitizer and sanitizer_runs:
            r["sanitizer"] = _sanitize(path)
            sanitizer_runs = all(
                any("ERROR SUMMARY" in ln for ln in v["report"])
                for v in r["sanitizer"].values() if isinstance(v, dict))
        print(json.dumps(r), flush=True)
        results[name] = r
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
