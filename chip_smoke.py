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
     both times, the warps a launch gives each SM, and the bound (the
     least time the card could take: the 32-bit multiplies of the fewest
     point operations that give the output for this run's inputs, over
     the same integer issue peak, or its bytes over the memory rate;
     beside it the same count over the mad.wide.u32 rate that the
     microbenchmark measured): the four windowed kernels at the 2^16
     plan's shapes, the ladder, the per-chunk reduction of its output and
     the fold of the chunk sums at the 4096 points of the small proof
     below, for G2 also at 2^16 points (the ladder's plain version on
     4096 points spread over all of them), and the G1 leaf also at the
     PLONK commitment's 2^16 + 3 points.  The Horner fold, a chain of
     point operations, the leaf prefix, a chain of mixed additions a
     thread group, and the weighted sum, a wavefront over the halving
     fold's dependency graph, also get their critical path: the levels of
     products on the longest dependent chain times the latency of one
     dependent product (the montmul_bn254 chain launched on one element,
     in one thread);
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
# the 32-bit halves those give: 2 N^2 full 64-bit products and N low halves
HALVES_PER_PRODUCT = 4 * 8 * 8 + 8
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
# levels of independent base products of the Horner fold kernel's
# doubling and addition, (G1, G2): G2's b3 product is a level of its own
FOLD_LEVELS = {"pdbl": (2, 3), "padd": (2, 3)}
# and their base products, level by level (fold_dbl, fold_add)
FOLD_PRODUCTS = {"pdbl": ((4, 4), (12, 3, 12)), "padd": ((6, 6), (18, 6, 18))}
# base products of each level of the leaf kernel's mixed addition, (G1,
# G2): 5 then 6; G2 15, its two b3 products (6), then 18.  A group of G
# lanes runs a level of m in ceil(m / G) rounds.
LEAF_LEVELS = ((5, 6), (15, 6, 18))
LATENCY_STEPS = 1024            # montmul products a chain, one element
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
        m = re.search(r"Function properties for _Z\d+(\w+_kernel)I2(G[12])"
                      r"((?:Li\d+E)*)E", line)
        if "Function properties for" in line:
            name = (f"{m.group(1)}<" + ", ".join(
                [m.group(2)] + re.findall(r"Li(\d+)E", m.group(3))) + ">"
                if m else None)
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
    # the latency of one dependent product: one montmul chain on one
    # element, in one thread (held against its plain version first)
    x1, y1 = MB.inputs("montmul_bn254", 1, device, SEED)
    one = MB.chain("montmul_bn254", x1, y1, LATENCY_STEPS, chains=1)
    sync()
    assert torch.equal(one, MB.chain_plain("montmul_bn254", x1, y1,
                                           LATENCY_STEPS, chains=1))
    lat_ms = cuda_ms(lambda: MB.chain("montmul_bn254", x1, y1, LATENCY_STEPS,
                                      chains=1), 5) / LATENCY_STEPS
    four_ms = cuda_ms(lambda: MB.chain("montmul_bn254", x1, y1,
                                       LATENCY_STEPS), 5) / LATENCY_STEPS
    log(f"[microbench] montmul_bn254 dependent latency {lat_ms * 1e6:.1f} ns "
        f"a product (one chain of {LATENCY_STEPS} on one element, one "
        f"thread, bit-exact); four chains in that thread "
        f"{four_ms * 1e6:.1f} ns a step")
    # the main path: the entry point, with the counts taken over it
    _cuda.reset_launches()
    rates = MB.run(device, log=log)
    launches = dict(_cuda.launches)
    for name in entries:
        assert launches[name] > 0, (name, launches)
        entries[name]["launches"] = launches[name]
    log(f"[microbench] launches during its run: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return entries, rates, peak, lat_ms


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
        # c doublings and an addition a window below the highest that is
        # not the identity
        return (fold_top(tensors[0]) * (args[1] * cost["pdbl"] + cost["padd"]),
                nbytes + L3 * 8)
    if name == "ladder":
        # its function: per point i and chunk j, d_ij P_i.  The fewer of
        # two counts a point: double-and-add on each chunk (a doubling a
        # bit below the top one, an addition a further set bit), or the
        # best signed-window (wNAF) recoding of its chunks over one shared
        # table of odd multiples; each operation at its cheapest formula
        xs, ys, inf, sc = tensors
        d = ladder_chunk_values(sc, inf)                        # [K, n]
        bits, ones = bit_lengths(d), popcounts(d)
        live = d > 0
        da = np.where(live, (bits - 1) * cost["jdbl"]
                      + (ones - 1) * cost["jadd_mixed"], 0).sum(0)
        best = da
        for w in range(2, 7):
            length, nnz = wnaf_counts(d, w)
            win = np.where(live, (length - 1) * cost["jdbl"]
                           + (nnz - 1) * cost["jadd_mixed"], 0).sum(0)
            table = cost["jdbl"] + ((1 << (w - 2)) - 1) * cost["jadd_mixed"]
            best = np.minimum(best, win + np.where((d > 1).any(0), table, 0))
        K, n = d.shape
        return int(best.sum()), nbytes + K * n * L3 * 8
    if name == "reduce":
        # each chunk's sum: one addition a further point that is not the
        # identity
        pts = tensors[0]
        live = (pts[2 * L3 // 3:] != 0).any(0).sum(1).cpu().numpy()    # [K]
        add = min(cost["padd"], cost["jadd"])
        return (int(np.maximum(live - 1, 0).sum()) * add,
                nbytes + pts.shape[1] * L3 * 8)
    raise KeyError(name)


def fold_top(S):
    """The highest window of S [3L, nw] that is not the identity (Z != 0),
    or 0 when none is: where the Horner fold starts."""
    live = np.flatnonzero((S[2 * S.shape[0] // 3:] != 0).any(0).cpu().numpy())
    return int(live[-1]) if len(live) else 0


def ladder_chunk_values(sc, inf):
    """int64[K, n]: chunk j of scalar i (0 for an infinity point), B = 16
    Ls / K bits."""
    from gnark_tpu_torch.ops import msm as M
    K = M.LADDER_CHUNKS
    B = M.chunk_bits(sc.shape[0])
    assert B <= 32, B
    limbs = np.where(inf.cpu().numpy()[None], 0, sc.cpu().numpy())
    bits = ((limbs[:, None, :] >> np.arange(16)[None, :, None]) & 1)
    bits = bits.reshape(K, B, -1)
    return (bits << np.arange(B)[None, :, None]).sum(1)


def bit_lengths(d):
    out = np.zeros_like(d)
    for b in range(64):
        out = np.where(d >> b, b + 1, out)
        if not (d >> b).any():
            break
    return out


def popcounts(d):
    out, k = np.zeros_like(d), d.copy()
    while k.any():
        out += k & 1
        k >>= 1
    return out


def wnaf_counts(d, w):
    """(digits up to the top nonzero one, nonzero digits) of each value's
    width-w NAF: odd digits in (-2^(w-1), 2^(w-1)), each followed by at
    least w - 1 zeros."""
    k = d.copy()
    length, nnz = np.zeros_like(d), np.zeros_like(d)
    pos = 0
    while k.any():
        mod = k & ((1 << w) - 1)
        digit = np.where(k & 1, np.where(mod >= 1 << (w - 1), mod - (1 << w),
                                         mod), 0)
        k = (k - digit) >> 1
        pos += 1
        nnz += digit != 0
        length = np.where(digit != 0, pos, length)
    return length, nnz


def warps_per_sm(name, kind, args):
    """Warps one launch of the kernel gives each SM, on average."""
    import torch
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops import _cuda
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if torch.cuda.is_available() else 132)    # 132: a CPU rehearsal
    t = [a for a in args if hasattr(a, "shape")]
    if name == "leaf_prefix":
        threads = t[0].shape[0] * t[0].shape[3] * _cuda.LEAF_GROUP[kind]
    elif name == "lane_offsets":
        threads = t[0].shape[1] * 256
    elif name == "weighted_sum":
        threads = (t[0].shape[1] * _cuda.WSUM_THREADS[kind]
                   * _cuda.WSUM_CLUSTER[kind])
    elif name == "horner_fold":
        threads = 32
    elif name == "ladder":
        threads = -(-t[0].shape[1] // 8) * 8 * M.LADDER_CHUNKS
    elif name == "reduce":
        threads = t[0].shape[1] * _cuda.REDUCE_LANES
    else:
        raise KeyError(name)
    return -(-threads // 32) / sms


def leaf_critical_path(kind, sy, latency_ms):
    """(mixed additions on the leaf's longest chain, its levels of
    products, the rounds of products lane 0 runs an addition at the
    group width, that chain in ms at the measured latency of one
    dependent product by levels and by rounds)."""
    from gnark_tpu_torch.ops import _cuda
    levels = LEAF_LEVELS[0 if kind == "g1" else 1]
    g = _cuda.LEAF_GROUP[kind]
    rounds = sum(-(-m // g) for m in levels)
    adds = int((((sy[:, :, 0, :] >> 16) & 1) == 0).sum(1).max())
    return (adds, len(levels), rounds, adds * len(levels) * latency_ms,
            adds * rounds * latency_ms)


def wsum_critical_path(kind, bk, latency_ms):
    """The weighted sum's critical path at nb = 2^K buckets: the 3K - 2
    operations of the halving fold's dependency graph (K >= 2; K - 1 tree
    levels, K - 1 doublings, K - 1 W additions and B + W), as (additions,
    doublings, their levels of products, that path in ms at the measured
    latency of one dependent product by levels, lane 0's rounds of
    products at the group width, that path by rounds)."""
    from gnark_tpu_torch.ops import _cuda
    k = 0 if kind == "g1" else 1
    K = bk.shape[-1].bit_length() - 1
    adds, dbls = 2 * K - 1, K - 1
    levels = adds * FOLD_LEVELS["padd"][k] + dbls * FOLD_LEVELS["pdbl"][k]
    g = _cuda.WSUM_GROUP[kind]
    rounds = (adds * sum(-(-m // g) for m in FOLD_PRODUCTS["padd"][k])
              + dbls * sum(-(-m // g) for m in FOLD_PRODUCTS["pdbl"][k]))
    return (adds, dbls, levels, levels * latency_ms, rounds,
            rounds * latency_ms)


def fold_critical_path(kind, S, c, latency_ms):
    """(products on the Horner fold's longest dependent chain, that chain
    in ms at the measured latency of one dependent product)."""
    k = 0 if kind == "g1" else 1
    chain = fold_top(S) * (c * FOLD_LEVELS["pdbl"][k] + FOLD_LEVELS["padd"][k])
    return chain, chain * latency_ms


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
    peak, mad_per_s = rates[:2]
    muls = products * MULS_PER_PRODUCT
    b_ms, by = bound(muls, peak, nbytes)
    return {"bound_ms": b_ms, "bound_by": by,
            "bound_ms_at_mad_rate": bound(muls, mad_per_s, nbytes)[0]}


def phase_kernels(device, rates):
    """Each kernel against its plain version on the same CUDA tensors:
    the windowed kernels at the shapes of the 2^16 plan, with infinity
    points (1 in 64), negative digits and the nearly empty top window; the
    ladder, its per-chunk reduction and the fold of the chunk sums at the
    small request's 4096 points and, for G2, at 2^16 points, with infinity
    points; the G1 leaf also at the 2^16 + 3 points of a PLONK commitment.
    ``rates`` are the integer issue peak, the measured multiply-add rate
    (see msm_bounds) and the latency of one dependent product in ms."""
    import torch
    from gnark_tpu_torch.ops import msm as M
    results = {}
    rng = np.random.default_rng(SEED)
    K = M.LADDER_CHUNKS
    B = M.chunk_bits(16)
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
        lout = M.ladder(lx, ly, linf, lsc, GC)
        sync()
        cases = {
            "leaf_prefix": ((sx, sy, GC), M.leaf_prefix, M.leaf_prefix_plain),
            "lane_offsets": ((tot, GC), M.lane_offsets, M.lane_offsets_plain),
            "weighted_sum": ((bk, GC), M.weighted_sum, M.weighted_sum_plain),
            "horner_fold": ((S, plan.c, GC), M.horner_fold,
                            M.horner_fold_plain),
            "ladder": ((lx, ly, linf, lsc, GC), M.ladder, M.ladder_plain),
            "reduce": ((lout, GC), M.reduce, M.reduce_plain),
        }
        for name, (args, kern, plain) in cases.items():
            results[f"{name}_{kind}"] = compare(kind, name, args, kern, plain,
                                                rates)
        # the fold of the ladder's chunk sums, as ladder_msm runs it
        T = M.reduce(lout, GC)
        r = compare(kind, f"horner_fold chunks nw={K} c={B}", (T, B, GC),
                    M.horner_fold, M.horner_fold_plain, rates,
                    work="horner_fold")
        lr = results[f"ladder_{kind}"]["ms"] + results[f"reduce_{kind}"]["ms"]
        log(f"[kernels {kind}] ladder MSM at n={N_LADDER}: ladder + reduce "
            f"{lr:.3f} ms, + fold {lr + r['ms']:.3f} ms")
        n_empty = int((bk.reshape(bk.shape[0], -1)[2 * G.F.L:] == 0)
                      .all(0).sum())
        log(f"[kernels {kind}] identity-class buckets: {n_empty}")
        assert n_empty > 0
    # the ladder and its reduction also at the shape that gnark_tpu's 2^16
    # prove gives its ladder kernel: the G2 MSM (gnark_tpu msm.py:156-169).
    # The ladder works point by point, so its plain version, which takes
    # long at 2^16, is held against N_SLICE of the kernel's points (all
    # their chunks), spread over the whole width: one in every run of
    # N_MSM / N_SLICE points, at an offset that goes round, so that every
    # block of the launch and every lane of a warp is among them, the last
    # point too.  phase_msm holds the sum of all 2^16 points against the
    # host oracle; the reduction is compared whole here.
    G, host, gen = groups()["g2"]
    GC = M.complete_ops(G)
    lx, ly, linf, lsc, _ = oracle_inputs(G, host, gen, device, rng)
    linf[::64] = True
    lout = M.ladder(lx, ly, linf, lsc, GC)
    step = N_MSM // N_SLICE
    cols = torch.arange(N_SLICE, device=device)
    cols = cols * step + cols % step
    assert int(cols[0]) == 0 and int(cols[-1]) == N_MSM - 1
    assert bool(linf[cols].any()), "no infinity point among the columns"
    part = tuple(t[..., cols].contiguous() for t in (lx, ly, linf, lsc))
    want, plain_ms = wall_ms(lambda: M.ladder_plain(*part, GC))
    assert torch.equal(lout[..., cols], want), "ladder g2 2^16 != plain"
    ms = cuda_ms(lambda: M.ladder(lx, ly, linf, lsc, GC), 3)
    b = msm_bounds(*kernel_work("ladder", "g2", (lx, ly, linf, lsc)), rates)
    assert ms >= b["bound_ms"], ("ladder g2 2^16 beats its bound", ms, b)
    log(f"[kernels g2] ladder n={N_MSM}: {N_SLICE} points, one in every "
        f"{step} from 0 to {N_MSM - 1}, bit-exact (tolerance 0; all points "
        f"summed against the host oracle in [route g2]), kernel {ms:.3f} ms "
        f"(bound {b['bound_ms']:.3f} ms by {b['bound_by']}, "
        f"{b['bound_ms_at_mad_rate']:.3f} ms at the measured mad.wide.u32 "
        f"rate), plain on {N_SLICE} points {plain_ms:.1f} ms, "
        f"{warps_per_sm('ladder', 'g2', (lx,)):.1f} warps an SM")
    compare("g2", f"reduce n={N_MSM}", (lout, GC), M.reduce, M.reduce_plain,
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
    the error, both times, the bounds and the warps a launch gives each
    SM (and the critical paths of the Horner fold, the leaf and the
    weighted sum)."""
    import torch
    from gnark_tpu_torch.ops import _cuda
    out_k = kern(*args)
    sync()
    out_p, plain_ms = wall_ms(lambda: plain(*args))
    err = int((out_k - out_p).abs().max())
    assert torch.equal(out_k, out_p), f"{name} {kind}: kernel != plain"
    ms = cuda_ms(lambda: kern(*args), 3)
    work = work or name
    products, nbytes = kernel_work(work, kind, args)
    b = msm_bounds(products, nbytes, rates)
    assert ms >= b["bound_ms"], (f"{name} {kind} beats its bound", ms, b)
    b["warps_per_sm"] = warps_per_sm(work, kind, args)
    extra = ""
    if work == "horner_fold":
        chain, b["critical_path_ms"] = fold_critical_path(
            kind, args[0], args[1], rates[2])
        extra = (f"; critical path {chain} dependent products x "
                 f"{rates[2] * 1e6:.1f} ns = {b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached)")
    elif work == "leaf_prefix":
        adds, lv, rounds, b["critical_path_ms"], by_rounds = \
            leaf_critical_path(kind, args[1], rates[2])
        extra = (f"; critical path {adds} mixed additions x {lv} levels x "
                 f"{rates[2] * 1e6:.1f} ns = {b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached), "
                 f"{rounds} rounds of products an addition on lane 0 at "
                 f"G = {_cuda.LEAF_GROUP[kind]}: {by_rounds:.4g} ms "
                 f"({share(by_rounds / ms)})")
    elif work == "weighted_sum":
        adds, dbls, lv, b["critical_path_ms"], rounds, by_rounds = \
            wsum_critical_path(kind, args[0], rates[2])
        extra = (f"; critical path {adds} additions + {dbls} doublings, "
                 f"{lv} levels of products x {rates[2] * 1e6:.1f} ns = "
                 f"{b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached), "
                 f"{rounds} rounds of products on lane 0 at G = "
                 f"{_cuda.WSUM_GROUP[kind]}: {by_rounds:.4g} ms "
                 f"({share(by_rounds / ms)}); {_cuda.WSUM_CLUSTER[kind]} "
                 f"block(s) of {_cuda.WSUM_THREADS[kind]} threads a window")
    log(f"[kernels {kind}] {name}: bit-exact (tolerance 0), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b['bound_ms']:.4g} ms by {b['bound_by']} ({products} field "
        f"products, {nbytes} bytes; {share(b['bound_ms'] / ms)} of the bound "
        f"reached; {b['bound_ms_at_mad_rate']:.4g} ms, "
        f"{share(b['bound_ms_at_mad_rate'] / ms)}, at the measured "
        f"mad.wide.u32 rate), {b['warps_per_sm']:.3g} warps an SM{extra}, "
        f"shape {tuple(out_k.shape)}")
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


ADD_TYPE = re.compile(r"^(IADD3|IADD|IMAD\.X|IMAD\.IADD|IADD32I|LEA)")
MUL_TYPE = re.compile(r"^IMAD(\.WIDE|\.HI|\.U32|$)")


def sass_report(out_dir=None):
    """Disassemble both libraries with cuobjdump, count the multiply and
    add instructions of each function, and keep the microbenchmark's
    listing in ``out_dir`` when one is given.  The montmul chain's loop
    body (the instructions between a backward branch and its label) is
    counted apart: its products are its chains x its unroll factor, and
    its add-type instructions over its products are the product's."""
    import shutil
    from gnark_tpu_torch.ops import _cuda
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[sass] cuobjdump not found")
        return
    op_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)")
    for name, info in _cuda.build_info.items():
        text = subprocess.run([tool, "-sass", info["path"]],
                              capture_output=True, text=True,
                              check=True).stdout
        if out_dir and name == "microbench":    # the MSM library's runs
            os.makedirs(out_dir, exist_ok=True)     # to 100 MB
            with open(os.path.join(out_dir, f"sass_{name}.txt"), "w") as f:
                f.write(text)
        fn, funcs = None, {}
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                funcs[fn] = []
            elif fn is not None:
                funcs[fn].append(line)
        for fn, lines in funcs.items():
            counts = {}
            for line in lines:
                m = op_re.search(line)
                if m and (ADD_TYPE.match(m.group(1))
                          or MUL_TYPE.match(m.group(1))
                          or m.group(1).startswith(("LOP3", "FFMA"))):
                    counts[m.group(1)] = counts.get(m.group(1), 0) + 1
            log(f"[sass {name}] {fn}: " + ", ".join(
                f"{k} {v}" for k, v in sorted(counts.items())))
            if "chain_montmul" in fn:
                montmul_loop(lines, op_re)


def montmul_loop(lines, op_re):
    """Count the montmul chain's loop body: the widest region between a
    backward branch and its target address."""
    addr = re.compile(r"/\*([0-9a-f]{4,})\*/")
    at, best = [], None
    for line in lines:
        m = addr.search(line)
        at.append(int(m.group(1), 16) if m else None)
        b = re.search(r"BRA\s+(0x[0-9a-f]+)", line)
        if m and b and int(b.group(1), 16) < at[-1]:
            span = (int(b.group(1), 16), at[-1])
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        log("[sass] montmul: no loop found")
        return
    ops = [m.group(1) for line, a in zip(lines, at)
           if a is not None and best[0] <= a <= best[1]
           and (m := op_re.search(line))]
    adds = sum(1 for o in ops if ADD_TYPE.match(o))
    muls = {o: ops.count(o) for o in set(ops) if MUL_TYPE.match(o)}
    # 32-bit halves: IMAD.WIDE gives both, IMAD the low, IMAD.HI the high
    n_mul = sum(v * (2 if ".WIDE" in o else 1) for o, v in muls.items())
    products = max(1, round(n_mul / HALVES_PER_PRODUCT))
    log(f"[sass] montmul loop body: {len(ops)} instructions, multiplies "
        f"{muls} ({n_mul} 32-bit halves), so {products} products; add-type "
        f"{adds}, {adds / products:.1f} a product")


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
    micro, rates, peak, lat_ms = phase_microbench(device)
    log(f"[phase] microbenchmark {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern = phase_kernels(device, (peak, rates["mad_wide_u32"]["ops_per_s"],
                                  lat_ms))
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
