"""Smoke run of gnark_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA MSM kernels from the sources in this checkout and drives
the port's main path once, at the size the repo has always measured:

  1. environment: the card's name and power limit, torch and CUDA versions,
     the native solver library, the nvcc build time;
  2. each of the six MSM kernels against its plain PyTorch version, for
     G1 (fp) and G2 (fp2), on the same CUDA tensors (bit for bit), with
     both times: the four windowed kernels at the 2^16 plan's shapes, the
     ladder and the reduction of its output at the 4096 points of the
     small proof below, and for G2 also at 2^16 points;
  3. MSMs against a host oracle (point i = 2^(i mod 64) G), G1 and G2: at
     2^16 the windowed plan, kernel path and plain path, in points/s; and
     the ladder against the windowed plan, kernel paths, at 4096 and 2^16
     points (``msm`` picks the ladder below 8192);
  4. Groth16, as a prover serving two requests: the 178-hash MiMC chain
     (58,741 constraints, MSMs of 2^16 points, windowed) and a 12-hash
     chain (3,961 constraints, MSMs of 4096 points, ladder).  Setup on the
     card, then prove each twice (cold and warm), verify each (and reject
     a wrong public input), with per-phase seconds.  Every kernel's launch
     count must rise during the proves, and no plain version may run on
     the card there.

``--profile`` adds a cProfile of one more warm 2^16 prove (host time by
function).

Every phase asserts.  Measurement lines come first, then one JSON line of
kernels, then the card's name and power limit, and last a JSON status line.
Exits nonzero, printing no result, when CUDA is not available.
"""

import json
import os
import random
import re
import subprocess
import sys
import time

import numpy as np

N_MSM = 1 << 16
N_LADDER = 1 << 12
# (hashes, constraints, MSM points) of the two requests
REQUESTS = {"mimc178": (178, 58741, N_MSM), "mimc12": (12, 3961, N_LADDER)}
SEED = 7
REPLACES = {
    "leaf_prefix": "gnark_tpu/ops/msm.py:496",
    "lane_offsets": "gnark_tpu/ops/msm.py:564",
    "weighted_sum": "gnark_tpu/ops/msm.py:623",
    "horner_fold": "gnark_tpu/ops/msm.py:725",
    "ladder": "gnark_tpu/ops/msm.py:319",
    "reduce": "gnark_tpu/ops/msm.py:124",
}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_summary(report):
    """One line per kernel (registers, stack and spills) from the output of
    ``nvcc -Xptxas -v``: an entry function's properties come right before
    its register count."""
    out, name, props = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+_kernel)I2(G[12])E",
                      line)
        if "Function properties for" in line:
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
            props = ""
        elif name and "stack frame" in line:
            props = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{name}: {m.group(1)} registers; {props}")
            name = None
    return out


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps runs (after one warm-up)."""
    import torch
    fn()
    if not torch.cuda.is_available():           # a rehearsal on the CPU
        return wall_ms(fn)[1]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def groups():
    from gnark_tpu.curves import BN254
    from gnark_tpu_torch.ops.ec import CurveOps
    from gnark_tpu_torch.ops.limbs import field_ops
    from gnark_tpu_torch.ops.towers import fp2_ops
    return {
        "g1": (CurveOps(field_ops(BN254.fp), b=BN254.b), BN254.host_g1,
               BN254.g1_gen),
        "g2": (CurveOps(fp2_ops(BN254.fp, BN254.fp2_beta), b=BN254.b2),
               BN254.host_g2, BN254.g2_gen),
    }


def oracle_inputs(G, host, gen, device, rng, n=None):
    """n (default N_MSM) points, point i = 2^(i mod 64) * gen, random
    full-width scalars, and the expected MSM as one host scalar
    multiplication."""
    import torch
    n = n or N_MSM
    from gnark_tpu.curves import BN254
    from gnark_tpu_torch.ops.limbs import ints_to_limbs
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = host.double(P)
    reps = n // 64
    xs = G.F.pack([p[0] for p in base], device).repeat(1, reps)
    ys = G.F.pack([p[1] for p in base], device).repeat(1, reps)
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    scalars = [int.from_bytes(rng.bytes(32), "little") % BN254.fr.modulus
               for _ in range(n)]
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(
        np.int64)).to(device)
    total = sum(s << (i % 64) for i, s in enumerate(scalars)) % \
        BN254.fr.modulus
    return xs, ys, inf, sc, host.scalar_mul(gen, total)


def phase_kernels(device):
    """Each kernel against its plain version on the same CUDA tensors:
    the windowed kernels at the shapes of the 2^16 plan, with infinity
    points (1 in 64), negative digits and the nearly empty top window; the
    ladder and its reduction at the small request's 4096 points and, for
    G2, at 2^16 points, with infinity points."""
    import torch
    from gnark_tpu_torch.ops import msm as M
    results = {}
    rng = np.random.default_rng(SEED)
    for kind, (G, host, gen) in groups().items():
        xs, ys, inf, sc, _ = oracle_inputs(G, host, gen, device, rng)
        inf[::64] = True
        plan = M.MSM(G, N_MSM, 16)
        log(f"[kernels {kind}] plan c={plan.c} nwin={plan.nwin} "
            f"nb={plan.nb} R={plan.R} C={plan.C}")
        GC = plan.GC
        ptrows, dg, sg = plan._prep_window(xs, ys, inf, sc)
        sx, sy, d_sorted = plan._sort_gather(ptrows, dg, sg)
        assert bool((sg != 0).any()), "no negative digit in the inputs"
        rows = M.leaf_prefix(sx, sy, GC)
        tot = plan.lane_totals(rows)
        offs = M.lane_offsets(tot, GC)
        bk = plan._buckets(rows, offs, d_sorted)
        S = M.weighted_sum(bk, GC)
        lx, ly, linf, lsc, _ = oracle_inputs(G, host, gen, device, rng,
                                             N_LADDER)
        linf[::64] = True
        lout = M.ladder(lx, ly, linf, lsc, G)
        sync()
        cases = {
            "leaf_prefix": ((sx, sy, GC), M.leaf_prefix, M.leaf_prefix_plain),
            "lane_offsets": ((tot, GC), M.lane_offsets, M.lane_offsets_plain),
            "weighted_sum": ((bk, GC), M.weighted_sum, M.weighted_sum_plain),
            "horner_fold": ((S, plan.c, GC), M.horner_fold,
                            M.horner_fold_plain),
            "ladder": ((lx, ly, linf, lsc, G), M.ladder, M.ladder_plain),
            "reduce": ((lout, G), M.reduce, M.reduce_plain),
        }
        for name, (args, kern, plain) in cases.items():
            results[f"{name}_{kind}"] = compare(kind, name, args, kern, plain)
        n_empty = int((bk.reshape(bk.shape[0], -1)[2 * G.F.L:] == 0)
                      .all(0).sum())
        log(f"[kernels {kind}] identity-class buckets: {n_empty}")
        assert n_empty > 0
    # the ladder and its reduction also at the shape that gnark_tpu's 2^16
    # prove gives its ladder kernel: the G2 MSM (gnark_tpu msm.py:156-169)
    G, host, gen = groups()["g2"]
    lx, ly, linf, lsc, _ = oracle_inputs(G, host, gen, device, rng)
    linf[::64] = True
    lout = M.ladder(lx, ly, linf, lsc, G)
    compare("g2", f"ladder n={N_MSM}", (lx, ly, linf, lsc, G), M.ladder,
            M.ladder_plain)
    compare("g2", f"reduce n={N_MSM}", (lout, G), M.reduce, M.reduce_plain)
    return results


def compare(kind, name, args, kern, plain):
    """One kernel against its plain version on the same tensors: asserts
    equal limbs and returns the error and both times."""
    import torch
    out_k = kern(*args)
    sync()
    out_p, plain_ms = wall_ms(lambda: plain(*args))
    err = int((out_k - out_p).abs().max())
    assert torch.equal(out_k, out_p), f"{name} {kind}: kernel != plain"
    ms = cuda_ms(lambda: kern(*args), 3)
    log(f"[kernels {kind}] {name}: bit-exact (tolerance 0), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"shape {tuple(out_k.shape)}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def msm_breakdown(plan, xs, ys, inf, sc):
    """Milliseconds of each step of one kernel-path MSM (synchronised
    between steps, so the sum exceeds an unsynchronised run)."""
    from gnark_tpu_torch.ops import msm as M
    steps = {}
    (ptrows, dg, sg), steps["recode"] = wall_ms(
        lambda: plan._prep_window(xs, ys, inf, sc))
    (sx, sy, ds), steps["sort_gather"] = wall_ms(
        lambda: plan._sort_gather(ptrows, dg, sg))
    rows, steps["leaf_prefix"] = wall_ms(lambda: M.leaf_prefix(sx, sy, plan.GC))
    offs, steps["lane_offsets"] = wall_ms(
        lambda: M.lane_offsets(plan.lane_totals(rows), plan.GC))
    bk, steps["buckets"] = wall_ms(lambda: plan._buckets(rows, offs, ds))
    S, steps["weighted_sum"] = wall_ms(lambda: M.weighted_sum(bk, plan.GC))
    P, steps["horner_fold"] = wall_ms(
        lambda: M.horner_fold(S, plan.c, plan.GC))
    _, steps["to_jacobian"] = wall_ms(
        lambda: plan.GC.to_jacobian(M.split_points(P, plan.G.F.L)))
    return steps


def phase_msm(device):
    """2^16 MSMs against the host oracle, kernel path and plain path; then
    the ladder against the windowed plan, kernel paths, at both sizes."""
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops.ec import points_to_host
    rng = np.random.default_rng(SEED + 1)
    for kind, (G, host, gen) in groups().items():
        xs, ys, inf, sc, want = oracle_inputs(G, host, gen, device, rng)
        plan = M.MSM(G, N_MSM, 16)
        plan(xs, ys, inf, sc)                       # warm-up
        times = []
        for _ in range(3):
            out, ms = wall_ms(lambda: plan(xs, ys, inf, sc))
            times.append(ms)
        assert points_to_host(G, out)[0] == want, f"MSM {kind} != oracle"
        out_p, plain_ms = wall_ms(lambda: plan.run(xs, ys, inf, sc, M.PLAIN))
        assert points_to_host(G, out_p)[0] == want, \
            f"plain MSM {kind} != oracle"
        best = min(times)
        steps = msm_breakdown(plan, xs, ys, inf, sc)
        log(f"[msm {kind}] steps (ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in steps.items()))
        log(f"[msm {kind}] n=2^16 oracle ok: kernel path {best:.1f} ms "
            f"({N_MSM / best * 1e3:.0f} points/s), plain path "
            f"{plain_ms:.1f} ms ({N_MSM / plain_ms * 1e3:.0f} points/s)")
    for kind, (G, host, gen) in groups().items():
        for n in (N_LADDER, N_MSM):
            xs, ys, inf, sc, want = oracle_inputs(G, host, gen, device, rng, n)
            plan = M.MSM(G, n, 16)
            ms = {}
            for route, fn in (("ladder", lambda: M.ladder_msm(
                    G, xs, ys, inf, sc)), ("windowed", lambda: plan(
                    xs, ys, inf, sc))):
                fn()                                 # warm-up
                out, ms[route] = min((wall_ms(fn) for _ in range(3)),
                                     key=lambda r: r[1])
                assert points_to_host(G, out)[0] == want, \
                    f"{route} MSM {kind} n={n} != oracle"
            log(f"[route {kind}] n={n} oracle ok: ladder {ms['ladder']:.1f} "
                f"ms, windowed {ms['windowed']:.1f} ms (kernel paths; msm "
                f"takes the {'ladder' if n < M.LADDER_MAX else 'windowed'})")


def mimc_chain(n_hashes):
    from gnark_tpu.curves import BN254
    from gnark_tpu.frontend.compile import compile_circuit
    from gnark_tpu.frontend.schema import Circuit, Public, Secret
    from gnark_tpu.std.mimc import MiMC, MiMCHost

    class MiMCChain(Circuit):
        pre = Secret()
        digest = Public()

        def define(self, api):
            acc = self.pre
            for _ in range(n_hashes):
                h = MiMC(api)
                h.write(acc)
                acc = h.sum()
            api.assert_is_equal(acc, self.digest)

    t0 = time.perf_counter()
    cs = compile_circuit(MiMCChain(), BN254)
    log(f"[groth16] compile {n_hashes} hashes {time.perf_counter() - t0:.2f} "
        f"s: {cs.nb_constraints} constraints, {cs.nb_wires} wires")
    pre = acc = 12345
    for _ in range(n_hashes):
        h = MiMCHost(BN254)
        h.write(acc)
        acc = h.sum()
    return cs, pre, acc


def phase_groth16(device, profile=False):
    """Setup for both requests, then the main path: each request proved
    cold and warm, with the launch counts taken over all four proves."""
    from gnark_tpu.curves import BN254
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    served = {}
    for name, (n_hashes, n_constraints, n_msm) in REQUESTS.items():
        cs, pre, digest = mimc_chain(n_hashes)
        assert cs.nb_constraints == n_constraints, cs.nb_constraints
        t0 = time.perf_counter()
        pk, vk = groth16.setup(cs, BN254, rng=random.Random(42),
                               device=device)
        sync()
        log(f"[groth16 {name}] setup on the card "
            f"{time.perf_counter() - t0:.2f} s (domain {pk.domain_n}, "
            f"n_pad {pk.n_pad})")
        assert pk.n_pad == n_msm, pk.n_pad
        served[name] = (cs, pk, vk, pre, digest)

    _cuda.reset_launches()
    for k in M.plain_on_cuda:
        M.plain_on_cuda[k] = 0
    proofs = {}
    for name, (cs, pk, vk, pre, digest) in served.items():
        for label in ("cold", "warm"):
            before = dict(_cuda.launches)
            timings = {}
            t0 = time.perf_counter()
            proofs[name] = groth16.prove(cs, pk, [digest, pre],
                                         rng=random.Random(7),
                                         timings=timings)
            total = time.perf_counter() - t0
            phases = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
            log(f"[groth16 {name}] prove {label} {total:.2f} s: {phases}")
            ran = {k: v - before[k] for k, v in _cuda.launches.items()
                   if v > before[k]}
            log(f"[groth16 {name}] launches in this prove: {ran}")
    launches = dict(_cuda.launches)
    assert all(v > 0 for v in launches.values()), launches
    assert not any(M.plain_on_cuda.values()), M.plain_on_cuda
    log(f"[groth16] launches during the four proves: {launches}")

    for name, (cs, pk, vk, pre, digest) in served.items():
        t0 = time.perf_counter()
        assert groth16.verify(proofs[name], vk, [digest]), \
            f"{name}: proof does not verify"
        assert not groth16.verify(proofs[name], vk, [digest + 1]), \
            f"{name}: proof verifies a wrong public input"
        log(f"[groth16 {name}] verify ok, wrong public input rejected "
            f"({time.perf_counter() - t0:.2f} s)")

    if profile:
        import cProfile
        import io
        import pstats
        cs, pk, vk, pre, digest = served["mimc178"]
        prof = cProfile.Profile()
        prof.enable()
        groth16.prove(cs, pk, [digest, pre], rng=random.Random(7))
        sync()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
        for line in out.getvalue().splitlines():
            if line.strip():
                log(f"[profile] {line.rstrip()}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gnark_tpu_torch  # noqa: F401  (sets GNARK_TPU_NO_COMPILE_CACHE)
    from gnark_tpu.native import solver_lib
    from gnark_tpu_torch.ops import _cuda

    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = card_line()
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    lib = solver_lib()
    assert lib is not None, "native solver library did not build"
    log(f"[env] native solver library: {lib._name}")
    t0 = time.perf_counter()
    _cuda.load()
    log(f"[env] nvcc build {_cuda.build_info['seconds']:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s): "
        f"{_cuda.build_info['command']}")
    for line in ptxas_summary(_cuda.build_info["ptxas"]):
        log(f"[ptxas] {line}")

    t0 = time.perf_counter()
    kern = phase_kernels(device)
    log(f"[phase] kernels vs plain {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_msm(device)
    log(f"[phase] msm oracle {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase_groth16(device, profile="--profile" in sys.argv[1:])
    log(f"[phase] groth16 {time.perf_counter() - t0:.1f} s")
    log(f"[phase] total {time.perf_counter() - t_all:.1f} s")

    entries = []
    for key, r in kern.items():
        name = key.rsplit("_", 1)[0]
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/msm_kernels.cu",
            "replaces": REPLACES[name], "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
