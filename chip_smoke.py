"""Smoke run of gnark_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--profile] [--trace] [--sass[=DIR]]

Builds the CUDA kernels (the MSM library and the microbenchmark, the two
compilers side by side) and the native host core from the sources in this
checkout, and drives the port's main paths once, at the sizes the repo has
always measured:

  1. environment: the card's name and power limit, torch and CUDA versions,
     the native solver library, the nvcc build times;
  2. the integer-multiply microbenchmark (ops/microbench.py): every op
     against its plain PyTorch version on the same CUDA tensors (integers
     bit for bit, fma_f32 within its stated tolerance), then its entry
     point, which prints operations per second for each op.  Each op's
     bound is its issue slots over the card's 32-bit integer issue peak
     (SMs x 64 lanes x the SM clock);
  3. each of the six MSM kernels against its plain PyTorch version, for
     G1 (fp) and G2 (fp2), on the same CUDA tensors (bit for bit), with
     both times and the bound (the least time the card could take: the
     32-bit multiplies of the fewest point operations that give the
     output for this run's inputs, over the same integer issue peak, or
     its bytes over the memory rate; beside it the same count over the
     mad.wide.u32 rate that the microbenchmark measured): the
     four windowed kernels at the 2^16 plan's shapes, the ladder and the
     reduction of its output at the 4096 points of the small proof below,
     for G2 also at 2^16 points (the ladder's plain version on 4096
     columns spread over all of them), and the G1 leaf also at the PLONK
     commitment's 2^16 + 3 points;
  4. MSMs against a host oracle (point i = 2^(i mod 64) G), G1 and G2: at
     2^16 the windowed plan, kernel path and plain path, in points/s; and
     the ladder against the windowed plan, kernel paths, at 4096 and 2^16
     points (``msm`` picks the ladder below 8192);
  5. Groth16, as a prover serving two requests: the 178-hash MiMC chain
     (58,741 constraints, MSMs of 2^16 points, windowed) and a 12-hash
     chain (3,961 constraints, MSMs of 4096 points, ladder).  Setup on the
     card, then prove each twice (cold and warm), verify each (and reject
     a wrong public input), with per-phase seconds;
  6. PLONK over KZG, a third request: a squaring chain of 2^16 - 4 gates
     (domain 2^16, quotient domain 2^18, SRS of 2^16 + 3 points).  Setup on
     the card, one cold and two warm proves with per-phase seconds, verify
     (and reject a wrong public input).

The launch counts are set to zero just before each of the three paths (2, 5
and 6) and read just after: every kernel of a path must have launched in
it, and no plain version may run on the card there.

``--profile`` adds a cProfile of one more warm 2^16 Groth16 prove (host
time by function).  ``--trace`` takes one more warm 2^16 Groth16 prove and
one more PLONK prove under ``torch.profiler`` and prints the share of the
wall time in which the card ran a kernel.  ``--sass`` disassembles both libraries with cuobjdump
and counts the multiply and add instructions per function; with ``=DIR``
it also writes the microbenchmark's listing into that directory.

Every phase asserts; a kernel that runs faster than its bound fails the run.  Measurement lines come first, then one JSON line of
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
N_SLICE = 1 << 12        # columns of the 2^16 G2 ladder held against plain
N_PLONK = 1 << 16        # the PLONK request's domain
# (hashes, constraints, MSM points) of the two requests
REQUESTS = {"mimc178": (178, 58741, N_MSM), "mimc12": (12, 3961, N_LADDER)}
SEED = 7
MICROBENCH_REPLACES = "scripts/dev_vpu_microbench.py:24"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FMA_PER_S = 67e12 / 2       # 67 TFLOP/s outside the tensor cores
INT32_LANES_PER_SM = 64         # Hopper white paper: INT32 units per SM
MULS_PER_PRODUCT = 136          # csrc/field.cuh: 2 N^2 + N at N = 8
# ptxas pairs two dependent adds of a chain into one three-input IADD3
# (--sass: 262 IADD3 for add_u32's 512 adds), so the adds need half as
# many issue slots as there are adds
ADDS_PER_IADD3 = 2
# base-field products of one point operation, (G1, G2): an fp2 product is
# three base products, and G2's b3 multiplication is a full fp2 product
POINT_PRODUCTS = {
    "padd": (12, 42), "padd_mixed": (11, 39), "pdbl": (8, 27),
    "jdbl": (7, 21), "jadd_mixed": (11, 33), "jadd": (16, 48),
}
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


def int32_peak_per_s():
    """The card's 32-bit integer issue rate: SMs x INT32 lanes x the
    highest SM clock that nvidia-smi reports."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def phase_microbench(device):
    """Every microbenchmark op against its plain version at the shapes its
    entry point uses, then the entry point itself with the launch counts
    taken over it.  Returns the kernels' entries, the measured rates and
    the 32-bit integer issue peak."""
    import torch
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import microbench as MB
    peak = int32_peak_per_s()
    log(f"[microbench] 32-bit integer issue peak {peak:.4g} operations/s "
        f"(SMs x {INT32_LANES_PER_SM} lanes x clocks.max.sm)")
    entries = {}
    for op in MB.OPS:
        montmul = op == "montmul_bn254"
        n = MB.N_MONTMUL if montmul else MB.N_U32
        steps = MB.MONTMUL_STEPS if montmul else MB.STEPS
        assert montmul or _cuda.microbench_steps() == MB.STEPS
        x, y = MB.inputs(op, n, device, SEED)
        out_k = MB.chain(op, x, y)
        sync()
        out_p, plain_ms = wall_ms(lambda: MB.chain_plain(op, x, y))
        if op == "fma_f32":
            err = float((out_k - out_p).abs().max())
            assert torch.allclose(out_k, out_p, rtol=MB.FMA_RTOL, atol=0), \
                f"microbench {op}: kernel != plain within {MB.FMA_RTOL}"
            verdict = (f"max abs err {err:.3g} (rtol {MB.FMA_RTOL}: one "
                       f"rounding a step against two)")
        else:
            err = int((out_k - out_p).abs().max())
            assert torch.equal(out_k, out_p), \
                f"microbench {op}: kernel != plain"
            verdict = "bit-exact (tolerance 0)"
        ms = MB.time_op(op, x, y)
        ops = n * 4 * steps * MB.OPS_PER_STEP[op]
        if montmul:
            ops *= MULS_PER_PRODUCT
        elif op == "add_u32":
            ops //= ADDS_PER_IADD3
        nbytes = 3 * x.numel() * x.element_size()
        b_ms, by = bound(ops, F32_FMA_PER_S if op == "fma_f32" else peak,
                         nbytes)
        assert ms >= b_ms, (f"microbench {op} beats its bound", ms, b_ms)
        log(f"[microbench] {op}: {verdict}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {by} "
            f"({ops} issue slots; {b_ms / ms:.1%} reached), n={n}")
        entries[f"microbench_{op}"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    # the main path: the entry point, with the counts taken over it
    _cuda.reset_launches()
    rates = MB.run(device, log=log)
    launches = dict(_cuda.launches)
    for name in entries:
        assert launches[name] > 0, (name, launches)
        entries[name]["launches"] = launches[name]
    log(f"[microbench] launches during its run: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return entries, rates, peak


def device_busy(label, fn):
    """One call of fn() under torch.profiler: the summed device time of
    its kernels (one stream, so they do not overlap) over its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    # the kernels' own rows only: an operator's row repeats the device
    # time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) * 1e-6
    assert busy > 0, "the trace shows no device time"
    rows.sort(key=lambda e: -e.self_device_time_total)
    log(f"[trace {label}] wall {wall:.3f} s under the profiler, device busy "
        f"{busy:.3f} s ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
        f"{sum(e.count for e in rows)} kernel launches; top kernels: "
        + ", ".join(
            f"{e.key[:48]} {e.self_device_time_total * 1e-3:.1f} ms x{e.count}"
            for e in rows[:6]))


def groups():
    from gnark_tpu_torch.curves import BN254
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
    from gnark_tpu_torch.curves import BN254
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


def kernel_work(name, kind, args):
    """(base-field products, bytes) of one call of an MSM kernel's wrapper
    on these inputs: the fewest point operations that give its output for
    this data (not those of the kernel's own algorithm) times their
    products, and every input and output tensor once."""
    import torch
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops.limbs import limbs_to_ints
    k = 0 if kind == "g1" else 1
    cost = {op: v[k] for op, v in POINT_PRODUCTS.items()}
    L3 = 3 * _cuda._L16[kind]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if name == "leaf_prefix":
        sx, sy = tensors
        live = ((sy[:, :, 0, :] >> 16) & 1) == 0          # [nw, C, R]
        nw, C, _, R = sx.shape
        # a lane's first live point starts its running sum: no addition
        adds = int(live.sum()) - int(live.any(1).sum())
        return adds * cost["padd_mixed"], nbytes + nw * C * R * L3 * 8
    if name == "lane_offsets":
        # an exclusive prefix over R lane totals: a serial scan's R - 1
        # additions a window (the kernel's log-step scan does R log2 R)
        _, nw, R = tensors[0].shape
        return nw * (R - 1) * cost["padd"], 2 * nbytes
    if name == "weighted_sum":
        # sum of (j + 1) B_j over a window's buckets that are not the
        # identity, by the cheaper of two ways: running sums from the
        # highest such bucket down (one addition to chain each further
        # bucket, one a step to accumulate), or double-and-add on each
        # bucket and a sum (what a nearly empty window wants)
        bk = tensors[0]
        _, nw, nb = bk.shape
        full = (bk[2 * L3 // 3:] != 0).any(0).cpu().numpy()     # Z != 0
        products = 0
        for w in range(nw):
            js = np.flatnonzero(full[w])
            if not len(js):
                continue
            chain = (len(js) - 1) + int(js[-1])
            running = chain * cost["padd"]
            each = sum((int(j + 1).bit_length() - 1) * cost["pdbl"]
                       + (bin(int(j + 1)).count("1") - 1) * cost["padd"]
                       for j in js) + (len(js) - 1) * cost["padd"]
            products += min(running, each)
        return products, nbytes + nw * L3 * 8
    if name == "horner_fold":
        nw, c = tensors[0].shape[1], args[1]
        return ((nw - 1) * (c * cost["pdbl"] + cost["padd"]),
                nbytes + L3 * 8)
    if name == "ladder":
        # its function is double-and-add point by point: one doubling a
        # bit below the top one, one addition a further set bit
        xs, ys, inf, sc = tensors
        live = torch.where(inf.unsqueeze(0), 0, sc)
        ints = [v for v in limbs_to_ints(live.cpu().numpy()) if v]
        dbls = sum(v.bit_length() - 1 for v in ints)
        adds = sum(bin(v).count("1") - 1 for v in ints)
        return (dbls * cost["jdbl"] + adds * cost["jadd_mixed"],
                nbytes + xs.shape[1] * L3 * 8)
    if name == "reduce":
        n = tensors[0].shape[1]
        return ((max(n - _cuda.REDUCE_LANES, 0) + _cuda.REDUCE_LANES - 1)
                * cost["jadd"], nbytes + L3 * 8)
    raise KeyError(name)


def share(x):
    """A share as a percentage to two significant digits."""
    return f"{100 * x:.2g} %"


def bound(ops, ops_per_s, nbytes):
    """The least time the card could take, in ms, and what sets it."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def msm_bounds(products, nbytes, rates):
    """An MSM kernel's two bounds, as entries of the kernels line.  The
    bound proper holds its 32-bit multiplies to the card's integer issue
    peak, one a lane a clock, as the microbenchmark's rows are held: no
    kernel can beat it.  The second holds them to the rate the
    microbenchmark measured for its mad.wide.u32 chain, carry adds
    included: what multiply-adds of field.cuh's form reach today."""
    peak, mad_per_s = rates
    muls = products * MULS_PER_PRODUCT
    b_ms, by = bound(muls, peak, nbytes)
    return {"bound_ms": b_ms, "bound_by": by,
            "bound_ms_at_mad_rate": bound(muls, mad_per_s, nbytes)[0]}


def phase_kernels(device, rates):
    """Each kernel against its plain version on the same CUDA tensors:
    the windowed kernels at the shapes of the 2^16 plan, with infinity
    points (1 in 64), negative digits and the nearly empty top window; the
    ladder and its reduction at the small request's 4096 points and, for
    G2, at 2^16 points, with infinity points; the G1 leaf also at the
    2^16 + 3 points of a PLONK commitment.  ``rates`` are the integer
    issue peak and the measured multiply-add rate (see msm_bounds)."""
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
            results[f"{name}_{kind}"] = compare(kind, name, args, kern, plain,
                                                rates)
        n_empty = int((bk.reshape(bk.shape[0], -1)[2 * G.F.L:] == 0)
                      .all(0).sum())
        log(f"[kernels {kind}] identity-class buckets: {n_empty}")
        assert n_empty > 0
    # the ladder and its reduction also at the shape that gnark_tpu's 2^16
    # prove gives its ladder kernel: the G2 MSM (gnark_tpu msm.py:156-169).
    # The ladder works point by point, so its plain version, which takes
    # half a minute at 2^16, is held against N_SLICE of the kernel's
    # columns, spread over the whole width: one in every run of
    # N_MSM / N_SLICE columns, at an offset that goes round, so that every
    # block of the launch and every lane of a warp is among them, the last
    # column too.  phase_msm holds the sum of all 2^16 columns against the
    # host oracle; the reduction is compared whole here.
    G, host, gen = groups()["g2"]
    lx, ly, linf, lsc, _ = oracle_inputs(G, host, gen, device, rng)
    linf[::64] = True
    lout = M.ladder(lx, ly, linf, lsc, G)
    step = N_MSM // N_SLICE
    cols = torch.arange(N_SLICE, device=device)
    cols = cols * step + cols % step
    assert int(cols[0]) == 0 and int(cols[-1]) == N_MSM - 1
    assert bool(linf[cols].any()), "no infinity point among the columns"
    part = tuple(t[..., cols].contiguous() for t in (lx, ly, linf, lsc))
    want, plain_ms = wall_ms(lambda: M.ladder_plain(*part, G))
    assert torch.equal(lout[:, cols], want), "ladder g2 2^16 != plain"
    ms = cuda_ms(lambda: M.ladder(lx, ly, linf, lsc, G), 3)
    b = msm_bounds(*kernel_work("ladder", "g2", (lx, ly, linf, lsc)), rates)
    assert ms >= b["bound_ms"], ("ladder g2 2^16 beats its bound", ms, b)
    log(f"[kernels g2] ladder n={N_MSM}: {N_SLICE} columns, one in every "
        f"{step} from 0 to {N_MSM - 1}, bit-exact (tolerance 0; all columns "
        f"summed against the host oracle in [route g2]), kernel {ms:.3f} ms "
        f"(bound {b['bound_ms']:.3f} ms by {b['bound_by']}, "
        f"{b['bound_ms_at_mad_rate']:.3f} ms at the measured mad.wide.u32 "
        f"rate), plain on {N_SLICE} columns {plain_ms:.1f} ms")
    compare("g2", f"reduce n={N_MSM}", (lout, G), M.reduce, M.reduce_plain,
            rates, work="reduce")
    # the G1 leaf at a PLONK commitment's shape: 2^16 + 3 points, C = 129
    G, host, gen = groups()["g1"]
    n = N_MSM + 3
    px, py, pinf, psc, _ = oracle_inputs(G, host, gen, device, rng, 1 << 17)
    plan = M.MSM(G, n, 16)
    assert plan.C == 129, plan.C
    sx, sy, _ = plan._sort_gather(*plan._prep_window(
        px[:, :n], py[:, :n], pinf[:n], psc[:, :n]))
    compare("g1", f"leaf_prefix n={n}", (sx, sy, plan.GC), M.leaf_prefix,
            M.leaf_prefix_plain, rates, work="leaf_prefix")
    return results


def compare(kind, name, args, kern, plain, rates, work=None):
    """One kernel against its plain version on the same tensors: asserts
    equal limbs and that the kernel does not beat its bound, and returns
    the error, both times and the bounds."""
    import torch
    out_k = kern(*args)
    sync()
    out_p, plain_ms = wall_ms(lambda: plain(*args))
    err = int((out_k - out_p).abs().max())
    assert torch.equal(out_k, out_p), f"{name} {kind}: kernel != plain"
    ms = cuda_ms(lambda: kern(*args), 3)
    products, nbytes = kernel_work(work or name, kind, args)
    b = msm_bounds(products, nbytes, rates)
    assert ms >= b["bound_ms"], (f"{name} {kind} beats its bound", ms, b)
    log(f"[kernels {kind}] {name}: bit-exact (tolerance 0), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b['bound_ms']:.4g} ms by {b['bound_by']} ({products} field "
        f"products, {nbytes} bytes; {share(b['bound_ms'] / ms)} of the bound "
        f"reached; {b['bound_ms_at_mad_rate']:.4g} ms, "
        f"{share(b['bound_ms_at_mad_rate'] / ms)}, at the measured "
        f"mad.wide.u32 rate), shape {tuple(out_k.shape)}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **b}


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
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.frontend.compile import compile_circuit
    from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret
    from gnark_tpu_torch.std.mimc import MiMC, MiMCHost

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


def phase_groth16(device, profile=False, trace=False):
    """Setup for both requests, then the main path: each request proved
    cold and warm, with the launch counts taken over all four proves."""
    from gnark_tpu_torch.curves import BN254
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
    launches = {k: v for k, v in _cuda.launches.items()
                if not k.startswith("microbench_")}
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

    if trace:
        cs, pk, vk, pre, digest = served["mimc178"]
        device_busy("groth16 mimc178", lambda: groth16.prove(
            cs, pk, [digest, pre], rng=random.Random(7)))
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


def square_chain(n_sq):
    """The circuit of scripts/dev_plonk_e2e.py: y = x^(2^n_sq), one
    multiplication gate per squaring."""
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.frontend.compile import compile_circuit
    from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret

    class SquareChain(Circuit):
        x = Secret()
        y = Public()

        def define(self, api):
            v = self.x
            for _ in range(n_sq):
                v = api.mul(v, v)
            api.assert_is_equal(v, self.y)

    t0 = time.perf_counter()
    cs = compile_circuit(SquareChain(), BN254, scheme="plonk")
    log(f"[plonk] compile {n_sq} squarings {time.perf_counter() - t0:.2f} s: "
        f"{cs.nb_constraints} gates")
    x0 = y = 3
    for _ in range(n_sq):
        y = y * y % BN254.fr.modulus
    return cs, x0, y


def phase_plonk(device, trace=False):
    """The third request: setup on the card, then the main path, one cold
    and two warm proves, with the launch counts taken over them."""
    from gnark_tpu_torch.backend import plonk
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    cs, x0, y = square_chain(N_PLONK - 4)
    t0 = time.perf_counter()
    pk, vk = plonk.setup(cs, BN254, rng=random.Random(42), device=device)
    sync()
    log(f"[plonk sq16] setup on the card {time.perf_counter() - t0:.2f} s "
        f"(domain {pk.n}, quotient domain {pk.x_E.shape[1]}, SRS of "
        f"{len(pk.srs.g1)} points)")
    assert pk.n == N_PLONK and pk.x_E.shape[1] == 4 * N_PLONK
    assert len(pk.srs.g1) == N_PLONK + 3 and pk.device == device

    _cuda.reset_launches()
    for k in M.plain_on_cuda:
        M.plain_on_cuda[k] = 0
    for label in ("cold", "warm", "warm2"):
        before = dict(_cuda.launches)
        timings = {}
        t0 = time.perf_counter()
        proof = plonk.prove(cs, pk, [y, x0], rng=random.Random(7),
                            timings=timings)
        total = time.perf_counter() - t0
        phases = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        log(f"[plonk sq16] prove {label} {total:.2f} s: {phases}")
        ran = {k: v - before[k] for k, v in _cuda.launches.items()
               if v > before[k]}
        log(f"[plonk sq16] launches in this prove: {ran}")
    launches = dict(_cuda.launches)
    # every commitment has 2^16 or more coefficients: the windowed plan
    for k in _cuda.WINDOW_KERNELS:
        assert launches[f"{k}_g1"] > 0, launches
    assert not any(M.plain_on_cuda.values()), M.plain_on_cuda
    log(f"[plonk] launches during the three proves: "
        f"{ {k: v for k, v in launches.items() if v} }")

    t0 = time.perf_counter()
    assert plonk.verify(proof, vk, [y]), "sq16: proof does not verify"
    assert not plonk.verify(proof, vk, [(y + 1) % BN254.fr.modulus]), \
        "sq16: proof verifies a wrong public input"
    log(f"[plonk sq16] verify ok, wrong public input rejected "
        f"({time.perf_counter() - t0:.2f} s)")
    if trace:
        device_busy("plonk sq16", lambda: plonk.prove(
            cs, pk, [y, x0], rng=random.Random(7)))
    return launches


def sass_report(out_dir=None):
    """Disassemble both libraries with cuobjdump, count the multiply and
    add instructions of each function, and keep the microbenchmark's
    listing in ``out_dir`` when one is given."""
    import shutil
    from gnark_tpu_torch.ops import _cuda
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[sass] cuobjdump not found")
        return
    pat = re.compile(r"\b(IMAD\.WIDE\.U32|IMAD\.HI\.U32|IMAD\.WIDE|IMAD\.X|"
                     r"IMAD\.MOV\.U32|IMAD\.SHL\.U32|IMAD\.IADD|IMAD|IADD3\.X|"
                     r"IADD3|LOP3\.LUT|FFMA)\b")
    for name, info in _cuda.build_info.items():
        text = subprocess.run([tool, "-sass", info["path"]],
                              capture_output=True, text=True,
                              check=True).stdout
        if out_dir and name == "microbench":    # the MSM library's runs
            os.makedirs(out_dir, exist_ok=True)     # to 100 MB
            with open(os.path.join(out_dir, f"sass_{name}.txt"), "w") as f:
                f.write(text)
        fn, counts = None, {}
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = {}
            elif fn and (m := pat.search(line)):
                counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
        for fn, c in counts.items():
            log(f"[sass {name}] {fn}: " + ", ".join(
                f"{k} {v}" for k, v in sorted(c.items())))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gnark_tpu_torch.native import solver_lib
    from gnark_tpu_torch.ops import _cuda

    args = sys.argv[1:]
    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = card_line()
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[env] native solver library: {solver_lib()._name}")
    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"[env] nvcc builds, side by side, {time.perf_counter() - t0:.1f} s")
    for name, info in _cuda.build_info.items():
        log(f"[env] nvcc {name} {info['seconds']:.1f} s: {info['command']}")
    for line in ptxas_summary(_cuda.build_info["msm"]["ptxas"]):
        log(f"[ptxas] {line}")
    for a in args:
        if a.split("=")[0] == "--sass":
            sass_report(a.partition("=")[2] or None)

    t0 = time.perf_counter()
    micro, rates, peak = phase_microbench(device)
    log(f"[phase] microbenchmark {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern = phase_kernels(device, (peak, rates["mad_wide_u32"]["ops_per_s"]))
    log(f"[phase] kernels vs plain {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_msm(device)
    log(f"[phase] msm oracle {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_groth16 = phase_groth16(device, profile="--profile" in args,
                              trace="--trace" in args)
    log(f"[phase] groth16 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_plonk = phase_plonk(device, trace="--trace" in args)
    log(f"[phase] plonk {time.perf_counter() - t0:.1f} s")
    log(f"[phase] total {time.perf_counter() - t_all:.1f} s")

    from gnark_tpu_torch.ops import msm as M
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
    assert not bad, f"loaded: {bad}"
    assert not any(M.plain_on_cuda.values()), M.plain_on_cuda

    entries = []
    for key, r in kern.items():
        name = key.rsplit("_", 1)[0]
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/msm_kernels.cu",
            "replaces": REPLACES[name],
            "launches": l_groth16[key] + l_plonk[key],
            "launches_groth16": l_groth16[key],
            "launches_plonk": l_plonk[key], **r})
    for key, r in micro.items():
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/microbench.cu",
            "replaces": MICROBENCH_REPLACES, **r})
    assert all(e["launches"] > 0 for e in entries), entries
    # a least time that a kernel beats counts more work than its function
    # needs
    beaten = [e["name"] for e in entries if e["ms"] < e["bound_ms"]]
    assert not beaten, f"kernels faster than their bounds: {beaten}"
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
