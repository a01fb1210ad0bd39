"""Smoke run of gnark_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--profile] [--trace] [--sass[=DIR]]

Builds the CUDA kernels (BN254's MSM library, BLS24-315's G1 and G2
libraries, the quotient's NTT library and the microbenchmark, the five
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
  3. each of the seven MSM kernels against its plain PyTorch version, for
     G1 (fp) and G2 (fp2), on the same CUDA tensors (bit for bit), with
     both times, the warps a launch gives each SM, and the bound (the
     least time the card could take: the 32-bit multiplies of the fewest
     point operations that give the output for this run's inputs, over
     the same integer issue peak, or its bytes over the memory rate;
     beside it the same count over the mad.wide.u32 rate that the
     microbenchmark measured): the five windowed kernels at the 2^16
     plan's shapes (the bucket step's prefixes and bucket differences
     among them; the Horner fold in the Jacobian form the MSM returns),
     the ladder, the per-chunk
     reduction of its output and the fold of the chunk sums at the 4096
     points of the small proof
     below, for G2 also at 2^16 points (the ladder's plain version on
     4096 points spread over all of them), and the G1 leaf also at the
     PLONK commitment's 2^16 + 3 points.  Then the quotient's kernels
     (csrc/ntt_kernels.cu) over each of the six scalar fields: the pass
     kernel over whole transforms of all eight shapes (forward and
     inverse, DIF and DIT, plain and coset), one launch a pass over
     shared-memory tiles (``passes``: one where n fits a tile of 2^11
     elements, 2^10 for the BW6 fields, two above), and the pointwise
     step (a b - c) d, against the plain versions, bit for bit, p - 1, 0
     and 1 among the inputs, with both times and the bound by issue rate
     and by bytes (the planes, the scale tables and the twiddle entries
     the passes read, each once): BN254's fr at 2^16 (its transforms at
     2^12 too), the other five at 2^12 (and each at its paths' largest
     sizes after phase 13, as below).  The [ptxas] lines give each pass kernel's registers,
     spills and dynamic shared memory.  The Horner fold, a chain of
     point operations, the leaf prefix, a chain of mixed additions a
     thread group, the lane offsets, a Brent-Kung scan of 2K - 1 steps,
     and the weighted sum, a wavefront over the halving fold's dependency
     graph, and the reduction, also get their critical path: the levels of
     products on the longest dependent chain times the latency of one
     dependent product of the curve's base field (the montmul_bn254 or
     montmul_bls24315 chain launched on one element, in one thread).
     Then the fixed-base scan of setup's key batches and the KZG SRS
     (fixed_base_kernel; over fp4 fixed_base_sliced_kernel) against its
     plain version, bit for bit, each kind at c = 8 (N_FIXED_BASE
     columns), BN254's G1 and G2 at the 2^20 key's slice (SETUP_COLUMNS
     columns at setup's c = 8), each row's bound the mixed additions
     its digits need and its registers from ptxas, its five edge columns
     against the host's scalar multiplication, with the kernel's time a
     column and window and the host's a table entry;
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
     (and reject a wrong public input);
  7. the rollup (examples/rollup.py, EdDSA + Merkle, BASELINE config 5)
     at the reference's size: 16 accounts, one transfer a proof.  The four
     windowed kernels against their plain versions at the plan of its
     Groth16 MSMs (32,768 points: c = 10, 512 buckets, C = 64), G1 and G2;
     then the operator's transfer, RollupCircuit compiled under both
     schemes (27,988 constraints and 28,011 wires; 38,790 gates), setup on
     the card for each (domains 2^15 and 2^16), a cold and two warm
     Groth16 proves and a cold and a warm PLONK prove through the scheme
     dispatch, verify (and reject a wrong root_after), and a tampered
     transfer (amount + 1) refused by the solver before any launch;
  8. BLS24-315's kernels (msm_g1_bls24315.cu over its 10-word fp,
     msm_g2_bls24315.cu over fp4): each of the seven against its plain
     version, bit for bit, with its bound, the windowed five at the 2^16
     plan, the ladder, its reduction and the fold of the chunk sums at
     4096 points; G1's windowed five also at the plan of phase 10's
     commitments (2^14 + 3 points: c = 10, 512 buckets, C = 33); the fp4
     leaf, lane offsets, bucket step, weighted sum, ladder, reduction and
     both folds (leaf_sliced_kernel, lane_offsets_sliced_kernel,
     buckets_sliced_kernel, weighted_sum_sliced_kernel,
     ladder_sliced_kernel, reduce_sliced_kernel,
     horner_fold_sliced_kernel) launched twice each
     (the leaf on two seeds' inputs), against each other and the plain
     version; then G1's and G2's 2^16 MSM against the host oracle, with
     the milliseconds of each of its steps, as phase 4 prints BN254's;
  9. Groth16 over the other five curves, routed as gnark_tpu routes them:
     MiMC chains that fill a domain of 2^14 over BLS12-381 and BLS12-377
     (BASELINE config 4's curves, cut from 2^16 to make room for phases
     12 and 14) and of 2^16 over BLS24-315, a 12-hash chain over
     BLS24-315 (its ladder), and chains in a domain of 2^12 over BW6-761
     and BW6-633.  Setup on the card (the key points on the native core
     where fp has 24 or more 16-bit limbs), a cold and a warm prove each:
     the quotient's NTTs on the card for every curve, the MSMs on the
     native core for fp.L >= 24 and on BLS24-315's kernels; verify, and
     reject a wrong public input;
 10. PLONK over BLS12-381 (commitments on the native core) and BLS24-315
     (on its G1 kernels), a squaring chain in a domain of 2^14: setup on
     the card, a cold and a warm prove (every BLS24-315 commitment on the
     plan that phase 8 checks), verify, reject a wrong public input;
 11. serialization: the keys that phases 5, 6 and 9 served (the 2^16 MiMC
     Groth16 key and the 2^16 PLONK key over BN254, the 2^16 BLS24-315 and
     2^14 BLS12-381 Groth16 keys) written to files and read back onto the card
     (safe=False, then safe=True), each proving the in-memory key's proof
     bytes with its rng, cold and warm; proof and verifying key through
     bytes, verify, reject a wrong public input; each constraint system
     through cs_io, solved; examples/serialization_main.py on the card;
 12. one-layer recursion: cubic proofs made on the card over BLS12-377
     (native route) and BLS24-315 (its ladder, reduction and fold, G1 and
     fp4 G2), carried as bytes, satisfy the in-circuit Groth16 verifiers
     over BW6-761 (92,555 constraints) and BW6-633 (177,631), which refuse
     a wrong inner public input; each verifier's outer key (native route:
     BW6-761 at domain 2^17, BW6-633 at 2^18) proves once, launching its
     quotient's NTT kernels and no MSM kernel, verifies and rejects a
     wrong input; the two outer proves run
     side by side on two host threads while the main thread refuses the
     wrong inner inputs; the host memory after it.  The inner keys' setup
     and the verifiers' compiles run while nvcc builds the kernels
     (BLS24-315's inner setup, on the fixed-base kernel, once the builds
     are done), the two outer keys' setups, one after the other in one
     worker thread, beside phases 2-11 (phase 12 prints how long it
     waited for each): neither needs a kernel;
 13. the mesh prover (parallel/): phase 5's 2^16 MiMC key and system go
     through key_io and cs_io to two ranks spawned on the one card
     (gloo: two NCCL ranks on one device are refused, so the collectives
     stage through host memory, and no scaling figure can come of it).
     Each rank loads the built libraries, checks the sharded MSM (G1, G2;
     2^16 points, the windowed plan on 2^15 a rank, and 4,096, the
     ladder, reduction and fold on 2,048) against the oracle of phase 4
     and the unsharded msm, the four-step transforms and quotient at 2^16
     against the unsharded Domain and compute_h, times one all-to-all,
     then proves the chain on the mesh, cold and warm, with rng 7: each
     rank's proof is phase 5's bytes, verified and a wrong public input
     rejected.  A rank that fails, or has not joined within
     SHARDED_JOIN_S, fails the run.  Then the quotient's kernels at the
     sizes the paths gave them: every Domain.fft / ifft and pointwise
     step that phases 5-12 ran on the card is recorded by kind, shape and
     size (``watch_ntt``), and each kind's shapes are held against the
     plain versions, bit for bit, at the largest size a path ran them at
     where phase 3 did not (the BLS12 and BLS24-315 PLONK quotient
     domains of 2^16, BN254's of 2^18, the BW6 outer proves' 2^17 and
     2^18); at the end every shape and pointwise step the paths ran must
     have been held at its largest size (``check_ntt_held``);
 14. the 2^20 Groth16 prove (BASELINE configs 1 and 4's headline, on
     BN254), once the earlier phases' keys are released: the quotient's
     kernels at 2^20 (compute_h's three transform shapes and its
     pointwise step) against their plain versions, bit for bit; the five
     windowed
     kernels against their plain versions at the plan of its MSMs (2^21
     points: c = 14, 19 windows, 8,192 buckets, R = 512, C = 4,096), G1
     and G2, bit for bit (the leaf on two of the windows, its plain
     version run in 64-step segments seeded by the kernel's rows: one
     plain run is a 4,096-step torch loop; the bucket step inside each
     window chunk of a kernel-path run, where its rows live); G1's and
     G2's 2^21-point MSM on
     the chunked plan against the host oracle, with its steps, its window
     chunks and its peak memory; then the 2^20 - 2 squaring chain
     (1,048,575 constraints) through gnark_tpu_torch/scripts/
     dev_e2e_2e20.py: compile, setup on the card with its breakdown, the
     host witness, a cold and two warm proves with per-phase seconds,
     verify, reject y + 1, and the peak memory of the setup and of a
     prove.

The launch counts are set to zero just before each of the ten paths (2,
5, 6, 7, 9, 10, 11, 12, 13 and 14; in 13 in each rank, before each mesh
prove and again before each ShardedMSM check, the unsharded comparisons
left out) and read just after: every kernel of a path must have launched
in it (each request of 9-12 and each mesh prove of 13 exactly the MSM
kernels its route names, none on the native route; in 14 a prove's four
G1 MSMs and one G2 MSM each launch the Horner fold once and the other
windowed kernels, the bucket step among them, once a window chunk, the
ladder and reduction never),
every prove of 5-14 exactly its quotient's NTT launches (``ntt_launches``:
the passes of each of Groth16's seven transforms and one pointwise
step, PLONK's five transforms of n and seven of its quotient domain; a
mesh rank's seven local transforms and its pointwise step), and no
plain version may run on the card there; every setup on the card (in
5, 6, 7, 9, 10, 12's inner keys and 14) launches the fixed-base kernel
exactly as ``setup_launches`` says (a Groth16 key's four G1 and one G2
batch a SETUP_COLUMNS slice, a PLONK SRS one G1 launch, none on the
native route) and runs no plain scan on the card (``counted_setup``;
the ``fixed_base_<kind>`` rows' ``launches_<path>``); no single-card
Groth16 prove
of 5, 9 and 14 may run FieldOps.to_mont / from_mont on a CUDA tensor
(``watch_mont``: its quotient's conversions ride on the first and last
passes of its transforms), and 14 splits each prove's ``compute_h``
phase into the quotient call and the host work before it.  The kernels line's
``launches`` counts the paths' requests and proves; ``launches_sharded``
is phase 13's, split into its mesh proves' (``launches_sharded_prove``)
and its ShardedMSM checks' (``launches_sharded_msm``, the only ladder
shards of the phase); ``launches_2e20`` is phase 14's, and the rows
named ``<kernel>_<kind>_2e21`` are the kernels at the 2^21 plan,
``ntt_fr_bn254_2e20`` and ``fr_pointwise_fr_bn254_2e20`` the quotient's
at 2^20 (launched on the 2^20 path alone), the other
``<kernel>_<kind>_2e<k>`` rows the quotient's at the paths' largest
sizes; an NTT row's ``launches_<path>`` are its launches on each path.

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

import concurrent.futures
import contextlib
import gc
import io
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
N_CURVE_PLONK = 1 << 14  # PLONK over BLS12-381 and BLS24-315
N_BW6 = 1 << 12          # Groth16 over the BW6 curves
# the plan (c, windows, buckets, R, C) of every commitment of a BLS24-315
# PLONK prove at N_CURVE_PLONK: n + 2 and n + 3 coefficients
CURVE_PLONK_PLAN = (10, 26, 512, 512, 33)
# (hashes, constraints, MSM points) of the two requests
REQUESTS = {"mimc178": (178, 58741, N_MSM), "mimc12": (12, 3961, N_LADDER)}
SEED = 7
# the rollup (gnark_tpu_torch/examples/rollup.py): (constraints, wires) of
# its R1CS and its sparse R1CS, the domains of the two schemes, and the
# plan (c, windows, buckets, R, C) of every MSM of its Groth16 prove
ROLLUP_SIZES = {"groth16": (27988, 28011), "plonk": (38790, None)}
ROLLUP_DOMAINS = {"groth16": 1 << 15, "plonk": 1 << 16}
ROLLUP_PLAN = (10, 26, 512, 512, 64)
MICROBENCH_REPLACES = "scripts/dev_vpu_microbench.py:24"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FMA_PER_S = 67e12 / 2       # 67 TFLOP/s outside the tensor cores
INT32_LANES_PER_SM = 64         # Hopper white paper: INT32 units per SM
def muls_per_product(kind):
    """32-bit multiplies of one base-field product: 2 N^2 + N
    (csrc/field.cuh), N the base field's words as the kind's library
    reports them (8 for BN254's fp, 10 for BLS24-315's)."""
    from gnark_tpu_torch.ops import _cuda
    n = _cuda.shape(kind)["words"]
    return 2 * n * n + n


# the 32-bit halves of the microbenchmark's (BN254) product: 2 N^2 full
# 64-bit products and N low halves
HALVES_PER_PRODUCT = 4 * 8 * 8 + 8
# ptxas pairs two dependent adds of a chain into one three-input IADD3
# (--sass: 262 IADD3 for add_u32's 512 adds), so the adds need half as
# many issue slots as there are adds
ADDS_PER_IADD3 = 2
POINT_OPS = {  # (field products, b3 multiplications)
    "padd": (12, 2), "padd_mixed": (11, 2), "pdbl": (8, 1),
    "jdbl": (7, 0), "jadd_mixed": (11, 0), "jadd": (16, 0),
}


def point_products(kind):
    """{point operation: its base-field products} for a kind, the least
    count, for a bound: an F product over a degree-k extension as
    Karatsuba's 3^log2 k base products (fp2's 3, fp4's 9; the kernels run
    the schoolbook's 16 for fp4), and b3 * a, where it is a product
    (B3_PRODUCT), as the fewer of those and k base products a nonzero
    coefficient of b (BN254 G2's dense b3: 3; BLS24-315 G2's (0, 0, 0,
    3/13): 4); G1's b3 are additions."""
    from gnark_tpu_torch.ops import _cuda
    shape = _cuda.shape(kind)
    k = shape["degree"]
    per_product = 3 ** (k.bit_length() - 1)
    per_b3 = 0
    if shape["b3_product"]:
        b = groups((kind,))[kind][0].b
        nonzero = sum(1 for c in (b if k > 1 else (b,)) if c)
        per_b3 = min(per_product, k * nonzero)
    return {op: m * per_product + b3 * per_b3
            for op, (m, b3) in POINT_OPS.items()}


def fold_products(kind, op):
    """Base products of each level of the kernels' point operations as
    they run them (fold_dbl, fold_add; the leaf's mixed addition): an F
    product is Prod<F>::S base products (1, 3, 16), and where b3 is a
    product (G2) it is a level of its own.  A group of G lanes runs a
    level of m in ceil(m / G) rounds.  The fp4 leaf (leaf_sliced_kernel)
    runs an fp4 product as its K columns of K base products each, 16,
    and a b3 product as K columns of one (b3 has one nonzero
    coefficient)."""
    from gnark_tpu_torch.ops import _cuda
    shape = _cuda.shape(kind)
    s = shape["prod_s"]
    first, b3s, last = {"pdbl": (4, 1, 4), "padd": (6, 2, 6),
                        "leaf": (5, 2, 6)}[op]
    if op == "leaf" and shape["leaf_sliced"]:
        k = shape["degree"]
        return first * k * k, b3s * k, last * k * k
    return ((first * s, b3s * s, last * s) if shape["b3_product"]
            else (first * s, last * s))


LATENCY_STEPS = 1024            # montmul products a chain, one element
REPLACES = {
    "leaf_prefix": "gnark_tpu/ops/msm.py:496",
    "lane_offsets": "gnark_tpu/ops/msm.py:564",
    "buckets": "gnark_tpu/ops/msm.py:887",
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
        # _Z<len><name>_kernelI<len><struct>[L{i,b}<value>E...]E...
        m = re.search(r"Function properties for _Z\d+(\w+?_kernel)I(\d+)"
                      r"(\w+)", line)
        if "Function properties for" in line:
            name = None
            if m:
                k = int(m.group(2))
                rest = re.match(r"((?:L[ib]\d+E)*)E", m.group(3)[k:])
                name = f"{m.group(1)}<" + ", ".join(
                    [m.group(3)[:k]] + re.findall(r"L[ib](\d+)E",
                                                  rest.group(1))) + ">"
            props = ""
        elif name and "stack frame" in line:
            props = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{name}: {m.group(1)} registers; {props}")
            name = None
    return out


# ntt_kernels.cu's field struct of each kind
FR_STRUCTS = {"BN254Fr": "fr_bn254", "BLS12381Fr": "fr_bls12_381",
              "BLS12377Fr": "fr_bls12_377", "BLS24315Fr": "fr_bls24_315",
              "BLS12377Fp": "fr_bw6_761", "BLS24315Fp": "fr_bw6_633"}
def ntt_pass_smem(lines, plan=None):
    """For each pass kernel of ``ptxas_summary``'s lines: its kind, and
    at its kind's largest tile (a 2^20 transform's, ``plan`` = the
    library's _cuda.ntt_plan) the dynamic shared memory of a block, which
    ptxas does not see, and the blocks an SM that CUDA's occupancy allows
    (registers and shared memory together, 256 threads a block)."""
    if plan is None:
        from gnark_tpu_torch.ops import _cuda
        plan = _cuda.ntt_plan
    out = []
    for line in lines:
        m = re.match(r"ntt_pass_kernel<(\w+), (\d)>", line)
        if not m:
            continue
        kind = FR_STRUCTS[m.group(1)]
        top = max(plan(kind, 1 << 20, m.group(2) == "1"),
                  key=lambda p: p.tile_log)
        out.append(
            f"ntt_pass_kernel<{m.group(1)}, {m.group(2)}> ({kind}): tiles "
            f"of 2^{top.tile_log}, {top.smem_bytes} bytes of dynamic shared "
            f"memory a block, {top.blocks_per_sm} blocks an SM (CUDA's "
            f"occupancy)")
    return out


def host_memory():
    """This process's resident set (VmRSS of /proc/self/status) and its
    peak (getrusage's ru_maxrss), in GiB."""
    import resource
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return f"resident {rss / 2**20:.2f} GiB, peak {peak / 2**20:.2f} GiB"


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
        montmul = op in MB.MONTMUL_FIELDS
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
            ops *= MB.MONTMUL_FIELDS[op][1]   # the product's multiplies
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
    # the latency of one dependent product of each field: one montmul
    # chain on one element, in one thread (held against its plain version
    # first)
    lat = {}
    for op in MB.MONTMUL_FIELDS:
        x1, y1 = MB.inputs(op, 1, device, SEED)
        one = MB.chain(op, x1, y1, LATENCY_STEPS, chains=1)
        sync()
        assert torch.equal(one, MB.chain_plain(op, x1, y1, LATENCY_STEPS,
                                               chains=1))
        lat[op] = cuda_ms(lambda: MB.chain(op, x1, y1, LATENCY_STEPS,
                                           chains=1), 5) / LATENCY_STEPS
        four_ms = cuda_ms(lambda: MB.chain(op, x1, y1, LATENCY_STEPS),
                          5) / LATENCY_STEPS
        log(f"[microbench] {op} dependent latency {lat[op] * 1e6:.1f} ns "
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
    return entries, rates, peak, lat


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


BN254_KINDS = ("g1", "g2")
BLS24_KINDS = ("g1_bls24315", "g2_bls24315")


def groups(kinds=BN254_KINDS):
    """{kind: (curve ops, host curve, generator)}: the groups the kernels
    are built for, BN254's by default."""
    from gnark_tpu_torch.backend.groth16 import _Groups
    from gnark_tpu_torch.curves import BLS24_315, BN254
    out = {}
    for kind in kinds:
        curve = BLS24_315 if kind in BLS24_KINDS else BN254
        K = _Groups(curve)
        if kind.startswith("g1"):
            out[kind] = (K.g1, curve.host_g1, curve.g1_gen)
        else:
            out[kind] = (K.g2, curve.host_g2, curve.g2_gen)
    return out


def scalar_modulus(kind):
    from gnark_tpu_torch.curves import BLS24_315, BN254
    return (BLS24_315 if kind in BLS24_KINDS else BN254).fr.modulus


def oracle_inputs(G, host, gen, device, rng, n=None, r=None):
    """n (default N_MSM) points, point i = 2^(i mod 64) * gen, random
    full-width scalars below r (default BN254's scalar field), and the
    expected MSM as one host scalar multiplication."""
    import torch
    n = n or N_MSM
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.ops.limbs import ints_to_limbs
    r = r or BN254.fr.modulus
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = host.double(P)
    reps = -(-n // 64)
    xs = G.F.pack([p[0] for p in base], device).repeat(1, reps)[:, :n]
    ys = G.F.pack([p[1] for p in base], device).repeat(1, reps)[:, :n]
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(n)]
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(
        np.int64)).to(device)
    total = sum(s << (i % 64) for i, s in enumerate(scalars)) % r
    return xs, ys, inf, sc, host.scalar_mul(gen, total)


def kernel_work(name, kind, args):
    """(base-field products, bytes) of one call of an MSM kernel's wrapper
    on these inputs: the fewest point operations that give its output for
    this data (not those of the kernel's own algorithm) times their
    products, and every input and output tensor once."""
    import torch
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops.limbs import limbs_to_ints
    cost = point_products(kind)
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
        # additions a window (the kernel's Brent-Kung scan does 2R - 2 -
        # log2 R, in 2 log2 R - 1 steps)
        _, nw, R = tensors[0].shape
        return nw * (R - 1) * cost["padd"], 2 * nbytes
    if name == "buckets":
        # bucket b = PE(E_b+1) - PE(E_b), PE(E) = row[E] + offset[E // C]
        # (lane E // C; lane 0's offset is the identity), counted on this
        # run's boundaries E_b: an empty bucket (E_b+1 = E_b) needs
        # nothing; one whose boundaries lie in one lane is the difference
        # of two rows, one addition; one from E_b = -1 is PE(E_b+1), a row
        # in lane 0 and one addition above; one across lanes two at least
        # (from lane l to l + 1, row[E_b+1] plus lane l's total less
        # row[E_b]).  The bytes: each distinct row and lane offset at the
        # windows' boundaries, the digits a binary search a boundary
        # reads, and the buckets written
        rows, offs, d = tensors
        C, R, nb = args[3:6]
        nw, n = d.shape
        bvals = torch.arange(nb + 1, device=d.device).expand(
            nw, nb + 1).contiguous()
        ends = torch.searchsorted(d, bvals, right=True) - 1
        lo, hi = ends[:, :-1], ends[:, 1:]
        live = hi != lo
        one_lane = live & (lo >= 0) & (lo // C == hi // C)
        across = live & (lo >= 0) & (lo // C != hi // C)
        from_none = live & (lo < 0) & (hi >= C)
        adds = (int(one_lane.sum()) + 2 * int(across.sum())
                + int(from_none.sum()))
        first = torch.ones_like(ends[:, :1], dtype=torch.bool)
        new = torch.cat([first, hi != lo], 1)
        lanes = ends.clamp(min=0) // C
        new_lane = torch.cat([first, lanes[:, 1:] != lanes[:, :-1]], 1)
        nrows = int((new & (ends >= 0)).sum())
        nlanes = int(new_lane.sum())
        probes = min(n, (nb + 1) * n.bit_length())
        nbytes = (nrows + nlanes) * L3 * 8 + nw * probes * 8 \
            + nw * nb * L3 * 8
        return adds * cost["padd"], nbytes
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
        # not the identity, then the Jacobian form's X Z, Z^2 and Y Z^2
        k = _cuda.shape(kind)["degree"]
        jac = 3 * 3 ** (k.bit_length() - 1)
        return (fold_top(tensors[0]) * (args[1] * cost["pdbl"] + cost["padd"])
                + jac, nbytes + L3 * 8)
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
    if name == "fixed_base":
        # a column's sum: one mixed addition a further window whose entry
        # is not the identity (the first starts the sum), then the
        # Jacobian form's X Z, Z^2 and Y Z^2 where two or more were added
        # (one entry gives (x, y, 1)).  The bytes: the scalars, the
        # table's point-major copy and the output, each once
        from gnark_tpu_torch.ops.msm import window_digits
        table, sc = args
        d = window_digits(sc, table.c)[:table.nwin]
        w = torch.arange(table.nwin, device=sc.device)[:, None]
        live = (~table.tinf[w, d]).sum(0)                          # [n]
        k = _cuda.shape(kind)["degree"]
        jac = 3 * 3 ** (k.bit_length() - 1)
        products = (int((live - 1).clamp(min=0).sum()) * cost["padd_mixed"]
                    + int((live >= 2).sum()) * jac)
        return products, (sc.numel() * 8 + table.points.numel() * 4
                          + L3 * sc.shape[1] * 8)
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
        block = _cuda.shape(kind)["leaf_threads"]
        threads = -(-t[0].shape[0] * t[0].shape[3]
                    * _cuda.shape(kind)["leaf_group"] // block) * block
    elif name == "lane_offsets":
        threads = (t[0].shape[1] * _cuda.shape(kind)["lanes_threads"]
                   * _cuda.shape(kind)["lanes_cluster"])
    elif name == "buckets":
        shape = _cuda.shape(kind)
        threads = (t[2].shape[0] * -(-args[5] // shape["buckets_run"])
                   * shape["buckets_threads"])
    elif name == "weighted_sum":
        threads = (t[0].shape[1] * _cuda.shape(kind)["wsum_threads"]
                   * _cuda.shape(kind)["wsum_cluster"])
    elif name == "horner_fold":
        threads = _cuda.shape(kind)["fold_group"]
    elif name == "ladder":
        block = _cuda.shape(kind)["ladder_threads"]
        threads = -(-t[0].shape[1] * M.LADDER_CHUNKS
                    * _cuda.shape(kind)["ladder_group"] // block) * block
    elif name == "reduce":
        threads = (t[0].shape[1] * _cuda.shape(kind)["reduce_threads"]
                   * _cuda.shape(kind)["reduce_cluster"])
    elif name == "fixed_base":
        block = _cuda.shape(kind)["leaf_threads"]
        threads = -(-t[0].shape[1] * _cuda.shape(kind)["leaf_group"]
                    // block) * block
    else:
        raise KeyError(name)
    return -(-threads // 32) / sms


def leaf_critical_path(kind, sy, latency_ms):
    """(mixed additions on the leaf's longest chain, its levels of
    products, the rounds of products a lane runs an addition at the
    group width, that chain in ms at the measured latency of one
    dependent product by levels and by rounds).  A group of G lanes runs
    a level of m products in ceil(m / G) rounds; in the fp4 leaf a b3
    level's K columns run on min(G, K) lanes (at G = 2K a lane pair
    repeats them)."""
    from gnark_tpu_torch.ops import _cuda
    shape = _cuda.shape(kind)
    levels = fold_products(kind, "leaf")
    g = shape["leaf_group"]
    widths = [g] * len(levels)
    if shape["leaf_sliced"]:
        widths[1] = min(g, shape["degree"])
    rounds = sum(-(-m // w) for m, w in zip(levels, widths))
    adds = int((((sy[:, :, 0, :] >> 16) & 1) == 0).sum(1).max())
    return (adds, len(levels), rounds, adds * len(levels) * latency_ms,
            adds * rounds * latency_ms)


def lane_products(kind, op, g):
    """Base products one lane of a group of g runs in a point operation of
    the coefficient-sliced kernels (SlicedPoint, over degree k): a level
    of m products on LPC = g / min(g, k) copies of each coefficient, each
    lane its columns (k / min(g, k) of them, k base products each) of
    ceil(m / LPC) products; the b3 level one base product a column."""
    k = _shape(kind)["degree"]
    span = min(g, k)
    kpl, lpc = k // span, g // span
    first, b3s, last = {"pdbl": (4, 1, 4), "padd": (6, 2, 6)}[op]
    return (-(-first // lpc) + -(-last // lpc)) * kpl * k + b3s * kpl


def _shape(kind):
    from gnark_tpu_torch.ops import _cuda
    return _cuda.shape(kind)


def wsum_critical_path(kind, bk, latency_ms):
    """The weighted sum's critical path at nb = 2^K buckets: the 3K - 2
    operations of the halving fold's dependency graph (K >= 2; K - 1 tree
    levels, K - 1 doublings, K - 1 W additions and B + W), as (additions,
    doublings, their levels of products, that path in ms at the measured
    latency of one dependent product by levels, the rounds of products on
    lane 0 at the group width (the coefficient-sliced kernel: a lane's base
    products, lane_products), that path by rounds)."""
    K = bk.shape[-1].bit_length() - 1
    adds, dbls = 2 * K - 1, K - 1
    padd, pdbl = fold_products(kind, "padd"), fold_products(kind, "pdbl")
    levels = adds * len(padd) + dbls * len(pdbl)
    g = _shape(kind)["wsum_group"]
    if _shape(kind)["leaf_sliced"]:
        rounds = (adds * lane_products(kind, "padd", g)
                  + dbls * lane_products(kind, "pdbl", g))
    else:
        rounds = (adds * sum(-(-m // g) for m in padd)
                  + dbls * sum(-(-m // g) for m in pdbl))
    return (adds, dbls, levels, levels * latency_ms, rounds,
            rounds * latency_ms)


def reduce_critical_path(kind, pts, latency_ms):
    """The reduction's critical path over n points a chunk: a lane's
    ceil(n / 256) - 1 strided additions, then the 8 levels of the tree,
    as (additions, the dependent products of one, that path in ms at the
    measured latency of one dependent product, a lane's base products an
    addition, that path by them).  The coefficient-sliced kernel runs an
    addition as 3 levels of products, a lane's share of them
    lane_products; the template kernel all of its products on one
    thread."""
    from gnark_tpu_torch.ops import _cuda
    lanes = _cuda.REDUCE_LANES
    adds = -(-pts.shape[-1] // lanes) - 1 + lanes.bit_length() - 1
    padd = fold_products(kind, "padd")
    if _shape(kind)["leaf_sliced"]:
        levels = len(padd)
        per = lane_products(kind, "padd", _shape(kind)["reduce_group"])
    else:
        levels = per = sum(padd)
    return (adds, levels, adds * levels * latency_ms, per,
            adds * per * latency_ms)


def lanes_critical_path(kind, tot, latency_ms):
    """The lane offsets' critical path at R = 2^K lanes: the 2K - 1 steps
    of the Brent-Kung scan, one addition deep each, as (additions, their
    levels of products, that path in ms at the measured latency of one
    dependent product, lane 0's rounds of products at the group width (the
    coefficient-sliced kernel: a lane's base products, lane_products),
    that path by them)."""
    K = tot.shape[-1].bit_length() - 1
    adds = max(2 * K - 1, 0)
    padd = fold_products(kind, "padd")
    levels = adds * len(padd)
    g = _shape(kind)["lanes_group"]
    if _shape(kind)["leaf_sliced"]:
        rounds = adds * lane_products(kind, "padd", g)
    else:
        rounds = adds * sum(-(-m // g) for m in padd)
    return adds, levels, levels * latency_ms, rounds, rounds * latency_ms


def fold_critical_path(kind, S, c, latency_ms):
    """(products on the Horner fold's longest dependent chain, that chain
    in ms at the measured latency of one dependent product); the Jacobian
    form adds its two levels."""
    chain = fold_top(S) * (c * len(fold_products(kind, "pdbl"))
                           + len(fold_products(kind, "padd"))) + 2
    return chain, chain * latency_ms


def latency_ms(kind, rates):
    """The measured latency of one dependent product of the kind's base
    field (rates: the issue peak, the mad.wide.u32 rate, then BN254's and
    BLS24-315's latency in ms)."""
    return rates[3] if kind in BLS24_KINDS else rates[2]


def share(x):
    """A share as a percentage to two significant digits."""
    return f"{100 * x:.2g} %"


def bound(ops, ops_per_s, nbytes):
    """The least time the card could take, in ms, and what sets it."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def msm_bounds(products, nbytes, rates, kind):
    """An MSM kernel's two bounds, as entries of the kernels line.  The
    bound proper holds its 32-bit multiplies to the card's integer issue
    peak, one a lane a clock, as the microbenchmark's rows are held: no
    kernel can beat it.  The second holds them to the rate the
    microbenchmark measured for its mad.wide.u32 chain, carry adds
    included: what multiply-adds of field.cuh's form reach today."""
    peak, mad_per_s = rates[:2]
    muls = products * muls_per_product(kind)
    b_ms, by = bound(muls, peak, nbytes)
    return {"bound_ms": b_ms, "bound_by": by,
            "bound_ms_at_mad_rate": bound(muls, mad_per_s, nbytes)[0]}


def windowed_cases(kind, n, device, rng):
    """The five windowed kernels' inputs along the plan of an n-point MSM
    over oracle inputs (1 point in 64 infinite): (the plan, {name: (args,
    kernel, plain version)})."""
    from gnark_tpu_torch.ops import msm as M
    G, host, gen = groups((kind,))[kind]
    xs, ys, inf, sc, _ = oracle_inputs(G, host, gen, device, rng, n,
                                       scalar_modulus(kind))
    inf[::64] = True
    plan = M.MSM(G, n, 16)
    log(f"[kernels {kind}] plan at n={n}: c={plan.c} nwin={plan.nwin} "
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
    sync()
    return plan, {
        "leaf_prefix": ((sx, sy, GC), M.leaf_prefix, M.leaf_prefix_plain),
        "lane_offsets": ((tot, GC), M.lane_offsets, M.lane_offsets_plain),
        "buckets": ((rows, offs, d_sorted, plan.C, plan.R, plan.nb, GC),
                    M.buckets, M.buckets_plain),
        "weighted_sum": ((bk, GC), M.weighted_sum, M.weighted_sum_plain),
        "horner_fold": ((S, plan.c, GC), M.horner_fold,
                        M.horner_fold_jacobian_plain),
    }


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
        plan, cases = windowed_cases(kind, N_MSM, device, rng)
        GC, bk = plan.GC, cases["weighted_sum"][0][0]
        lx, ly, linf, lsc, _ = oracle_inputs(G, host, gen, device, rng,
                                             N_LADDER)
        linf[::64] = True
        lout = M.ladder(lx, ly, linf, lsc, GC)
        sync()
        cases["ladder"] = ((lx, ly, linf, lsc, GC), M.ladder, M.ladder_plain)
        cases["reduce"] = ((lout, GC), M.reduce, M.reduce_plain)
        for name, (args, kern, plain) in cases.items():
            results[f"{name}_{kind}"] = compare(kind, name, args, kern, plain,
                                                rates)
        # the fold of the ladder's chunk sums, as ladder_msm runs it
        T = M.reduce(lout, GC)
        r = compare(kind, f"horner_fold chunks nw={K} c={B}",
                    (T, B, GC), M.horner_fold, M.horner_fold_jacobian_plain,
                    rates, work="horner_fold")
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
    b = msm_bounds(*kernel_work("ladder", "g2", (lx, ly, linf, lsc)), rates,
                   "g2")
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


def compare(kind, name, args, kern, plain, rates, work=None, twice=False):
    """One kernel against its plain version on the same tensors: asserts
    equal limbs and that the kernel does not beat its bound, and returns
    the error, both times, the bounds and the warps a launch gives each
    SM (and the critical paths of the Horner fold, the leaf, the lane
    offsets and the weighted sum).  With ``twice``, a second launch must
    give the first one's limbs: a kernel that read a slot before its
    writer wrote it would differ between launches."""
    import torch
    from gnark_tpu_torch.ops import _cuda
    out_k = kern(*args)
    sync()
    out_p, plain_ms = wall_ms(lambda: plain(*args))
    err = int((out_k - out_p).abs().max())
    assert torch.equal(out_k, out_p), f"{name} {kind}: kernel != plain"
    if twice:
        again = kern(*args)
        sync()
        assert torch.equal(again, out_k), f"{name} {kind}: launches differ"
        log(f"[kernels {kind}] {name}: two launches bit-exact (tolerance 0) "
            f"against each other and the plain version")
    ms = cuda_ms(lambda: kern(*args), 3)
    work = work or name
    shape = _cuda.shape(kind)
    products, nbytes = kernel_work(work, kind, args)
    b = msm_bounds(products, nbytes, rates, kind)
    assert ms >= b["bound_ms"], (f"{name} {kind} beats its bound", ms, b)
    b["warps_per_sm"] = warps_per_sm(work, kind, args)
    extra = ""
    lat = latency_ms(kind, rates)
    sliced = shape["leaf_sliced"]
    tag = ", coefficient-sliced" if sliced else ""
    if work == "horner_fold":
        chain, b["critical_path_ms"] = fold_critical_path(
            kind, args[0], args[1], lat)
        extra = (f"; critical path {chain} dependent products x "
                 f"{lat * 1e6:.1f} ns = {b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached); "
                 f"{shape['fold_group']} threads{tag}; Jacobian form")
    elif work == "buckets":
        extra = (f"; two additions deep a bucket, each a round of levels "
                 f"on a group of {shape['buckets_group']} threads; "
                 f"{shape['buckets_run']} buckets a block of "
                 f"{shape['buckets_threads']} threads, its prefixes in "
                 f"shared memory{tag}")
    elif work == "ladder":
        extra = (f"; {shape['ladder_group']} thread(s) a (point, chunk) "
                 f"chain in blocks of {shape['ladder_threads']}{tag}")
    elif work == "fixed_base":
        table = args[0]
        extra = (f"; {table.nwin} windows of c = {table.c} a column, a "
                 f"chain of mixed additions on a group of "
                 f"{shape['leaf_group']} threads in blocks of "
                 f"{shape['leaf_threads']}{tag}; table "
                 f"{table.points.numel() * 4} bytes")
    elif work == "leaf_prefix":
        adds, lv, rounds, b["critical_path_ms"], by_rounds = \
            leaf_critical_path(kind, args[1], lat)
        extra = (f"; critical path {adds} mixed additions x {lv} levels x "
                 f"{lat * 1e6:.1f} ns = {b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached), "
                 f"{rounds} rounds of products an addition "
                 f"{'a lane' if sliced else 'on lane 0'} at "
                 f"G = {shape['leaf_group']}: {by_rounds:.4g} ms "
                 f"({share(by_rounds / ms)}); blocks of "
                 f"{shape['leaf_threads']} threads")
    elif work == "lane_offsets":
        adds, lv, b["critical_path_ms"], rounds, by_rounds = \
            lanes_critical_path(kind, args[0], lat)
        extra = (f"; critical path {adds} additions (the scan's steps), "
                 f"{lv} levels of products x {lat * 1e6:.1f} ns = "
                 f"{b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached), "
                 f"{rounds} {'base products a lane' if sliced else 'rounds of products on lane 0'}"
                 f" at G = {shape['lanes_group']}: {by_rounds:.4g} ms "
                 f"({share(by_rounds / ms)}); {shape['lanes_cluster']} "
                 f"block(s) of {shape['lanes_threads']} threads a "
                 f"window, the narrow steps on one{tag}")
    elif work == "weighted_sum":
        adds, dbls, lv, b["critical_path_ms"], rounds, by_rounds = \
            wsum_critical_path(kind, args[0], lat)
        extra = (f"; critical path {adds} additions + {dbls} doublings, "
                 f"{lv} levels of products x {lat * 1e6:.1f} ns = "
                 f"{b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached), "
                 f"{rounds} {'base products a lane' if sliced else 'rounds of products on lane 0'}"
                 f" at G = {shape['wsum_group']}: {by_rounds:.4g} ms "
                 f"({share(by_rounds / ms)}); {shape['wsum_cluster']} "
                 f"block(s) of {shape['wsum_threads']} threads a "
                 f"window{tag}")
    elif work == "reduce":
        adds, lv, b["critical_path_ms"], per, by_lane = \
            reduce_critical_path(kind, args[0], lat)
        extra = (f"; critical path {adds} additions x {lv} "
                 f"{'levels of products' if sliced else 'dependent products'}"
                 f" x {lat * 1e6:.1f} ns = {b['critical_path_ms']:.4g} ms "
                 f"({share(b['critical_path_ms'] / ms)} of it reached), "
                 f"{per} base products an addition a lane at G = "
                 f"{shape['reduce_group']}: {by_lane:.4g} ms "
                 f"({share(by_lane / ms)}); {shape['reduce_cluster']} "
                 f"block(s) of {shape['reduce_threads']} threads a "
                 f"chunk{tag}")
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


# ---- the fixed-base scan (msm_kernels.cu's fixed_base_kernel) ---------------

FIXED_BASE_REPLACES = "gnark_tpu/ops/fixed_base.py:56"
# columns of each kind's row at c = 8: BLS24-315's fp4 at 2^14, where its
# plain version would take about 25 s at 2^16
N_FIXED_BASE = {"g1": N_MSM, "g2": N_MSM, "g1_bls24315": N_MSM,
                "g2_bls24315": N_MSM // 4}
# each kind's kernel in its library's ptxas report
FIXED_BASE_PTXAS = {
    "g1": ("msm", "fixed_base_kernel<G1,"),
    "g2": ("msm", "fixed_base_kernel<G2,"),
    "g1_bls24315": ("msm_g1_bls24315", "fixed_base_kernel<G1Bls24,"),
    "g2_bls24315": ("msm_g2_bls24315", "fixed_base_sliced_kernel<G2Bls24,")}
# the paths whose setups run the scan (counted_setup)
SETUP_PATHS = ("groth16", "plonk", "rollup", "curves_groth16",
               "curves_plonk", "recursion", "2e20")
SETUP_LAUNCHES = {p: {} for p in SETUP_PATHS}


def setup_launches(curve, scheme, n_pad=None):
    """{fixed-base kernel: launches} of one setup over ``curve`` on the
    card: a Groth16 key's five batches (four G1, one G2) of
    SETUP_COLUMNS columns a launch, a PLONK SRS one G1 launch; none on
    the native route."""
    from gnark_tpu_torch.backend.groth16 import SETUP_COLUMNS, native_route
    if native_route(curve):
        return {}
    kinds = BN254_KINDS if curve.name == "bn254" else BLS24_KINDS
    if scheme == "plonk":
        return {f"fixed_base_{kinds[0]}": 1}
    slices = -(-n_pad // SETUP_COLUMNS)
    return {f"fixed_base_{kinds[0]}": 4 * slices,
            f"fixed_base_{kinds[1]}": slices}


@contextlib.contextmanager
def counted_setup(path, curve, scheme="groth16"):
    """Run a setup inside: its fixed-base launches are added to
    SETUP_LAUNCHES[path] and must be setup_launches' (a path sets the
    counts to zero for its proves after its setups).  Yields a dict that
    the caller fills with the key's n_pad (Groth16).  No plain version
    of the scan may run on the card inside."""
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    keys = [f"fixed_base_{kind}" for kind in _cuda.KINDS]
    before = {k: _cuda.launches[k] for k in keys}
    plain = M.plain_on_cuda["fixed_base"]
    key = {}
    yield key
    ran = {k: _cuda.launches[k] - before[k] for k in keys
           if _cuda.launches[k] > before[k]}
    want = setup_launches(curve, scheme, key.get("n_pad"))
    assert ran == want, (path, curve.name, scheme, ran, want)
    assert M.plain_on_cuda["fixed_base"] == plain, (path, curve.name)
    for k, v in ran.items():
        SETUP_LAUNCHES[path][k] = SETUP_LAUNCHES[path].get(k, 0) + v


def ptxas_registers(kind):
    """(registers, the ptxas line) of a kind's fixed-base kernel."""
    from gnark_tpu_torch.ops import _cuda
    lib, prefix = FIXED_BASE_PTXAS[kind]
    lines = [line for line in ptxas_summary(_cuda.build_info[lib]["ptxas"])
             if line.startswith(prefix)]
    assert len(lines) == 1, (kind, lines)
    return int(re.search(r": (\d+) registers", lines[0]).group(1)), lines[0]


def fixed_base_scalars(kind, n, c, device, rng):
    """[16, n] scalar limbs below the kind's r, drawn as 16-bit limbs (the
    top one below r's), the first five columns 0, 1, r - 1, 2^c - 1 and
    2^c; and those five as ints."""
    import torch
    from gnark_tpu_torch.ops.limbs import ints_to_limbs
    r = scalar_modulus(kind)
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] %= r >> 240
    edge = [0, 1, r - 1, (1 << c) - 1, 1 << c]
    limbs[:, :len(edge)] = ints_to_limbs(edge, 16)
    return torch.from_numpy(limbs).to(device), edge


def phase_fixed_base_kernels(device, rates):
    """The fixed-base scan (setup's key batches and the KZG SRS) against
    its plain version on the same CUDA tensors, bit for bit, each kind at
    c = 8 on N_FIXED_BASE columns, and BN254's G1 and G2 at the 2^20
    key's slice (SETUP_COLUMNS columns at its window width); each row's
    first five columns (0, 1, r - 1, 2^c - 1, 2^c) against the host
    curve's scalar multiplication.  Also the kernel's time a column and
    window and the host's a table entry, the two costs of the window
    width's model."""
    from gnark_tpu_torch.backend.groth16 import SETUP_COLUMNS
    from gnark_tpu_torch.ops import fixed_base as FB
    from gnark_tpu_torch.ops.ec import points_to_host
    results = {}
    rng = np.random.default_rng(SEED + 4)
    cases = [(kind, N_FIXED_BASE[kind], 8, "") for kind in
             BN254_KINDS + BLS24_KINDS]
    cases += [(kind, SETUP_COLUMNS, 8, "_2e21")
              for kind in BN254_KINDS]
    for kind, n, c, suffix in cases:
        G, host, gen = groups((kind,))[kind]
        t0 = time.perf_counter()
        table = FB.FixedBaseTable(G, host, gen, 256, device, c)
        sync()
        t_table = time.perf_counter() - t0
        sc, edge = fixed_base_scalars(kind, n, c, device, rng)
        r = compare(kind, f"fixed_base n={n} c={c}", (table, sc),
                    FB.fixed_base, FB.fixed_base_plain, rates,
                    work="fixed_base")
        out = FB.fixed_base(table, sc)
        got = points_to_host(G, tuple(t[:, :len(edge)] for t in
                                      FB.split_points(out, G.F.L)))
        assert got == [host.scalar_mul(gen, v) for v in edge], kind
        entries = table.nwin << c
        regs, line = ptxas_registers(kind)
        per_cw = r["ms"] * 1e6 / (n * table.nwin)
        per_entry = t_table * 1e6 / entries
        log(f"[fixed_base {kind}{suffix}] n={n} c={c}: the five edge "
            f"columns are the host's scalar multiples; kernel "
            f"{per_cw:.4g} ns a column and window, host table "
            f"{t_table:.3f} s for {entries} entries ({per_entry:.4g} us an "
            f"entry, {per_entry * 1e3 / per_cw:.4g} columns' windows); "
            f"[ptxas] {line}")
        results[f"fixed_base_{kind}{suffix}"] = {
            **r, "columns": n, "c": c, "windows": table.nwin,
            "registers": regs, "ns_per_column_window": per_cw,
            "table_s": t_table, "us_per_table_entry": per_entry}
        del table, sc, out
    return results


# ---- the quotient's kernels (csrc/ntt_kernels.cu) --------------------------

NTT_REPLACES = {"ntt": "gnark_tpu/ops/ntt.py:134",
                "fr_pointwise": "gnark_tpu/backend/groth16.py:543"}
N_NTT = 1 << 12       # the transforms over the other five fields, phase 3
# every transform shape (inverse, order, coset, regular_in, regular_out),
# compute_h's three first: the iFFT (DIF), the coset FFT (DIT), the coset
# iFFT (DIF); then prove's quotient, compute_h(regular=True): its iFFT
# takes regular planes in (R on the first pass's load), its coset iFFT
# gives them out (R^-1 on the last pass's store)
NTT_SHAPES = tuple(s + (False, False) for s in (
    (True, "DIF", False), (False, "DIT", True), (True, "DIF", True),
    (False, "DIF", False), (False, "DIF", True), (False, "DIT", False),
    (True, "DIT", False), (True, "DIT", True)))
QUOTIENT_SHAPES = ((True, "DIF", False, True, False), NTT_SHAPES[1],
                   (True, "DIF", True, False, True))
NTT_ROW_SHAPE = NTT_SHAPES[1]   # the kernels line's row: the coset FFT


def passes(n, kind):
    """A transform's launches: one a pass over shared-memory tiles (one
    where n fits a tile, two from twice the tile to 2^20 at N = 8 words
    and to 2^18 at 10 and 12), as the library plans them."""
    from gnark_tpu_torch.ops import _cuda
    return len(_cuda.ntt_plan(kind, n))


def ntt_launches(curve, scheme, n):
    """{NTT kernel: launches} of one prove over ``curve`` with domain n:
    Groth16's quotient runs seven transforms of n and one pointwise step;
    PLONK's prove five transforms of n (interp_lro, z, the public
    inputs) and seven of its quotient domain (coset_evals' six,
    interp_quotient)."""
    kind = f"fr_{curve.name}"
    if scheme == "groth16":
        return {f"ntt_{kind}": 7 * passes(n, kind), f"fr_pointwise_{kind}": 1}
    from gnark_tpu_torch.backend.plonk import _big_domain_size
    return {f"ntt_{kind}": 5 * passes(n, kind)
            + 7 * passes(_big_domain_size(n), kind)}


def ntt_part(ran):
    """The NTT kernels' entries of a launch count."""
    from gnark_tpu_torch.ops import _cuda
    return {k: v for k, v in ran.items()
            if k.split("_fr_")[0] in _cuda.NTT_KERNELS}


def check_ntt(ran, curve, scheme, n):
    want = ntt_launches(curve, scheme, n)
    assert ntt_part(ran) == want, (ran, want)


def check_route(ran, curve, n_msm, n, scheme="groth16"):
    """A prove's launches against its route: exactly the MSM kernels that
    expected_launches names (none on the native route), the bucket step
    as often as the weighted sum (once a window chunk), and the NTT
    kernels' exact counts."""
    msm_kernels = set(ran) - set(ntt_part(ran))
    assert msm_kernels == expected_launches(curve, n_msm, scheme), ran
    for k in msm_kernels:
        if k.startswith("buckets_"):
            assert ran[k] == ran["weighted_sum_" + k[8:]], ran
    check_ntt(ran, curve, scheme, n)


def reset_plain():
    """Set the counts of plain versions run on the card to 0: the MSM
    kernels' and the quotient's."""
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops import ntt as N
    for counts in (M.plain_on_cuda, N.plain_on_cuda):
        for k in counts:
            counts[k] = 0


def plain_runs():
    """The plain versions run on CUDA tensors since reset_plain."""
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops import ntt as N
    return {k: v for counts in (M.plain_on_cuda, N.plain_on_cuda)
            for k, v in counts.items() if v}


def fr_spec(kind):
    from gnark_tpu_torch.curves import ALL_CURVES
    return ALL_CURVES[kind[3:]].fr


def ntt_inputs(spec, n, device, rng):
    """n seeded elements as Montgomery planes on ``device``: p - 1, 0 and 1
    first, then uniform 16-bit limbs, the top one below p's."""
    import torch
    from gnark_tpu_torch.ops.limbs import field_ops
    F, L, p = field_ops(spec), spec.L, spec.modulus
    limbs = rng.integers(0, 1 << 16, (L, n), dtype=np.int64)
    limbs[-1] = rng.integers(0, p >> (16 * (L - 1)), n)
    x = F.to_mont(torch.from_numpy(limbs).to(device))
    x[:, :3] = F.pack([p - 1, 0, 1], device)
    return x


def fr_bounds(spec, products, nbytes, rates):
    """A quotient kernel's bounds, as msm_bounds gives an MSM kernel's: its
    products' 32-bit multiplies (2 N^2 + N, N = L / 2 words) over the
    integer issue peak, or its bytes over the memory rate; both times,
    and the multiplies at the measured mad.wide.u32 rate."""
    words = spec.L // 2
    muls = products * (2 * words * words + words)
    b_ms, by = bound(muls, rates[0], nbytes)
    return {"bound_ms": b_ms, "bound_by": by,
            "bound_ops_ms": muls / rates[0] * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms_at_mad_rate": bound(muls, rates[1], nbytes)[0]}


def compare_fr(label, spec, kern, plain, work, rates, reps):
    """A quotient kernel against its plain version on the same CUDA
    tensors: equal limbs, not faster than its bound; its row."""
    import torch
    out_k = kern()
    sync()
    out_p, plain_ms = wall_ms(plain)
    err = int((out_k - out_p).abs().max())
    assert torch.equal(out_k, out_p), f"{label}: kernel != plain"
    ms = cuda_ms(kern, reps)
    products, nbytes = work
    b = fr_bounds(spec, products, nbytes, rates)
    assert ms >= b["bound_ms"], (f"{label} beats its bound", ms, b)
    log(f"[kernels {label}: bit-exact (tolerance 0), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.1f} ms, bound {b['bound_ms']:.4g} ms by "
        f"{b['bound_by']} (issue {b['bound_ops_ms']:.4g} ms for {products} "
        f"products, bytes {b['bound_bytes_ms']:.4g} ms for {nbytes}; "
        f"{share(b['bound_ms'] / ms)} of the bound reached; "
        f"{b['bound_ms_at_mad_rate']:.4g} ms at the measured mad.wide.u32 "
        f"rate)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **b}


def twiddle_reads(n, kind):
    """The twiddle-table entries a transform's passes read (each counted
    once): a pass of m stages reads tw[i 2^(k - m)], i < 2^(m - 1), and a
    strided pass its columns' roots tw[j 2^s] for each stage s; no pass
    reads the rest of the [L, n / 2] table."""
    from gnark_tpu_torch.ops import _cuda
    k = n.bit_length() - 1
    read = set()
    for s0, m, c, *_ in _cuda.ntt_plan(kind, n):
        if m:
            read.update(range(0, n // 2, 1 << (k - m)))
        if c:
            lo = k - s0 - m
            for s in range(s0, s0 + m):
                read.update(range(0, 1 << (lo + s), 1 << s))
    return len(read)


def ntt_rows(kind, n, device, rates, rng, shapes=NTT_SHAPES, reps=20,
             pointwise=True):
    """One field's transforms at n in each of ``shapes`` and, if
    ``pointwise``, its pointwise step, each against its plain version:
    the rows ntt_<kind> (where ``shapes`` is not empty: the coset FFT's
    numbers where it is among them, else the first shape's; every
    shape's under ``shapes``) and fr_pointwise_<kind>.  What it held
    goes into NTT_HELD and PW_HELD."""
    from gnark_tpu_torch.ops import ntt as N
    spec = fr_spec(kind)
    dom = N.Domain(spec, n, device)
    x = ntt_inputs(spec, n, device, rng)
    by_shape, row = {}, None
    for shape in shapes:
        inverse, order, coset, regular_in, regular_out = shape
        tw, pre, post = dom.operands(*shape)
        name = (f"{'ifft' if inverse else 'fft'} {order}"
                f"{' coset' if coset else ''}"
                f"{' regular in' if regular_in else ''}"
                f"{' regular out' if regular_out else ''}")
        k = n.bit_length() - 1
        products = (n // 2) * k + sum(n for t in (pre, post) if t is not None)
        elems = 2 * n + twiddle_reads(n, kind) + sum(
            t.shape[1] for t in (pre, post) if t is not None)
        by_shape[name] = compare_fr(
            f"{kind}] ntt {name} n={n}, {passes(n, kind)} launches", spec,
            lambda: dom.transform_kernel(x, tw, pre, post, order),
            lambda: dom.transform_plain(x, tw, pre, post, order),
            (products, 8 * spec.L * elems), rates, reps)
        if row is None or shape == NTT_ROW_SHAPE:
            row = dict(by_shape[name], shape=name, n=n)
        NTT_HELD.setdefault((kind, shape), set()).add(n)
    rows = {}
    if row is not None:
        row["shapes"] = {k: {m: v[m] for m in ("ms", "plain_ms", "bound_ms")}
                         for k, v in by_shape.items()}
        rows[f"ntt_{kind}"] = row
    if not pointwise:
        return rows
    a, b, c = (ntt_inputs(spec, n, device, rng) for _ in range(3))
    q = spec.modulus
    d = dom.F.pack([pow(pow(dom.coset_gen, n, q) - 1, -1, q)], device)
    pw = compare_fr(f"{kind}] fr_pointwise n={n}", spec,
                    lambda: N.fr_pointwise(spec, a, b, c, d),
                    lambda: N.fr_pointwise_plain(dom.F, a, b, c, d),
                    (2 * n, 8 * spec.L * (4 * n + 1)), rates, reps)
    PW_HELD.setdefault(kind, set()).add(n)
    return dict(rows, **{f"fr_pointwise_{kind}": dict(pw, n=n)})


def phase_ntt_kernels(device, rates):
    """Phase 3's quotient kernels: each field's pass kernel over whole
    transforms of every shape, and its pointwise kernel, against the
    plain versions on the same CUDA tensors, bit for bit: BN254's fr at
    2^16 (the 2^16 requests' domain) and its transforms at N_NTT too (rows
    <kernel>_fr_bn254_2e12), the other five at N_NTT."""
    from gnark_tpu_torch.ops import _cuda
    rows = {}
    rng = np.random.default_rng(SEED + 19)
    for kind in _cuda.FR_KINDS:
        rows.update(ntt_rows(kind, N_MSM if kind == "fr_bn254" else N_NTT,
                             device, rates, rng))
    rows.update({f"{k}_2e{N_NTT.bit_length() - 1}": v for k, v in ntt_rows(
        "fr_bn254", N_NTT, device, rates, rng, pointwise=False).items()})
    return rows


# (kind, (inverse, order, coset, regular_in, regular_out)) -> the
# transform sizes that the main
# process's paths ran on CUDA tensors, and kind -> the pointwise step's
# (watch_ntt); the same, held against the plain version (ntt_rows).  The
# mesh ranks of phase 13 are not watched: their transforms are BN254's at
# 2^15 and 2^16, which phase 3 holds in all eight shapes.
NTT_SEEN, PW_SEEN, NTT_HELD, PW_HELD = {}, {}, {}, {}


def watch_ntt():
    """Wrap Domain.fft / ifft and the fr_pointwise that compute_h and the
    mesh quotient call so that each call on CUDA tensors records its kind,
    shape and size in NTT_SEEN / PW_SEEN.  Python's set.add and
    dict.setdefault are atomic, so the outer proves' host threads may
    record too."""
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import ntt as N
    from gnark_tpu_torch.parallel import sharded_ntt

    def watched(inverse, orig):
        def transform(self, x, order="DIF", coset=False, **forms):
            if x.is_cuda:
                NTT_SEEN.setdefault((_cuda.fr_kind(self.spec), (
                    inverse, order, coset, forms.get("regular_in", False),
                    forms.get("regular_out", False))), set()).add(self.n)
            return orig(self, x, order, coset, **forms)
        return transform

    N.Domain.fft = watched(False, N.Domain.fft)
    N.Domain.ifft = watched(True, N.Domain.ifft)
    pointwise = groth16.fr_pointwise

    def watched_pointwise(spec, a, b, c, d):
        if a.is_cuda:
            PW_SEEN.setdefault(_cuda.fr_kind(spec), set()).add(a.shape[1])
        return pointwise(spec, a, b, c, d)

    groth16.fr_pointwise = sharded_ntt.fr_pointwise = watched_pointwise


# FieldOps.to_mont / from_mont calls on CUDA tensors made by the main
# thread (watch_mont): a single-card Groth16 prove makes none, its
# quotient's conversions riding on its transforms' first and last passes
MONT_ON_CUDA = {"to_mont": 0, "from_mont": 0}


def watch_mont():
    """Count FieldOps.to_mont / from_mont calls on CUDA tensors from the
    main thread (the outer setups' worker thread is not counted)."""
    import threading
    from gnark_tpu_torch.ops.limbs import FieldOps

    def counted(name, orig):
        def conversion(self, a):
            if a.is_cuda and threading.current_thread() is \
                    threading.main_thread():
                MONT_ON_CUDA[name] += 1
            return orig(self, a)
        return conversion

    for name in MONT_ON_CUDA:
        setattr(FieldOps, name, counted(name, getattr(FieldOps, name)))


def check_no_mont(tag):
    """No to_mont / from_mont ran on CUDA tensors since the counts were
    last set to 0."""
    assert not any(MONT_ON_CUDA.values()), (tag, MONT_ON_CUDA)
    log(f"{tag} FieldOps.to_mont / from_mont calls on CUDA tensors: "
        f"{MONT_ON_CUDA}")


def reset_mont():
    for name in MONT_ON_CUDA:
        MONT_ON_CUDA[name] = 0


def ntt_not_held():
    """{(kind, n): (shapes, pointwise)}: the largest size at which the
    watched paths ran each kind's transform shape and its pointwise step,
    where no comparison has held them at that size yet."""
    todo = {}
    for (kind, shape), sizes in NTT_SEEN.items():
        n = max(sizes)
        if n not in NTT_HELD.get((kind, shape), ()):
            todo.setdefault((kind, n), ([], False))[0].append(shape)
    for kind, sizes in PW_SEEN.items():
        n = max(sizes)
        if n not in PW_HELD.get(kind, ()):
            shapes, _ = todo.get((kind, n), ([], False))
            todo[(kind, n)] = (shapes, True)
    return todo


def phase_ntt_path_domains(device, rates):
    """The quotient's kernels at the sizes the paths of phases 5-12 gave
    them: each kind's transform shapes at the largest domain the watched
    paths ran each over (the BLS12 and BLS24-315 PLONK quotient domains,
    the BW6 outer proves' 2^17 and 2^18, BN254's PLONK quotient domain),
    and its pointwise step at its largest Groth16 domain, wherever
    phase 3 did not already hold them there; each against its plain
    version, bit for bit.  Returns the rows, named <kernel>_<kind>_2e<k>."""
    rows = {}
    rng = np.random.default_rng(SEED + 23)
    todo = ntt_not_held()
    log("[kernels] the paths' largest transforms and pointwise steps not "
        "yet held: " + "; ".join(
            f"{kind} 2^{n.bit_length() - 1}: {len(shapes)} shape(s)"
            f"{', pointwise' if pw else ''}"
            for (kind, n), (shapes, pw) in sorted(todo.items())))
    for (kind, n), (shapes, pw) in sorted(todo.items()):
        got = ntt_rows(kind, n, device, rates, rng, tuple(shapes), reps=5,
                       pointwise=pw)
        rows.update({f"{k}_2e{n.bit_length() - 1}": v
                     for k, v in got.items()})
    return rows


def check_ntt_held():
    """Every transform shape and pointwise step that the watched paths
    ran is held against its plain version at the largest size they ran
    it at; every kind ran on them."""
    from gnark_tpu_torch.ops import _cuda
    assert not ntt_not_held(), ntt_not_held()
    largest = {}
    for (kind, _), sizes in NTT_SEEN.items():
        largest.setdefault(kind, set()).add(max(sizes).bit_length() - 1)
    assert set(largest) == set(_cuda.FR_KINDS), NTT_SEEN
    pointwise = {kind: max(sizes).bit_length() - 1
                 for kind, sizes in PW_SEEN.items()}
    log("[kernels] every transform shape and pointwise step that the "
        "paths ran is held bit for bit at the largest size they ran it "
        "at; log2 of those sizes, transforms / pointwise: " + "; ".join(
            f"{kind} {sorted(largest[kind])} / {pointwise.get(kind, '-')}"
            for kind in _cuda.FR_KINDS))


def msm_breakdown(plan, xs, ys, inf, sc):
    """Milliseconds of each step of one kernel-path MSM (synchronised
    between steps, so the sum exceeds an unsynchronised run), the steps of
    each window chunk summed over the chunks."""
    from gnark_tpu_torch.ops import msm as M
    steps = {}

    def timed(name, fn):
        out, ms = wall_ms(fn)
        steps[name] = steps.get(name, 0.0) + ms
        return out

    plan.run(xs, ys, inf, sc, M.WRAPPERS, step=timed)
    return steps


def msm_steps(kind, G, xs, ys, inf, sc, want):
    """An MSM of oracle inputs on the windowed plan against the host
    oracle, then its steps, printed as ``[msm <kind>] steps (ms)``."""
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops.ec import points_to_host
    plan = M.MSM(G, xs.shape[1], 16)
    out = plan(xs, ys, inf, sc)                 # also the warm-up
    assert points_to_host(G, out)[0] == want, f"MSM {kind} != oracle"
    steps = msm_breakdown(plan, xs, ys, inf, sc)
    log(f"[msm {kind}] steps (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in steps.items()))
    return plan


def phase_msm(device):
    """2^16 MSMs against the host oracle, kernel path and plain path; then
    the ladder against the windowed plan, kernel paths, at both sizes."""
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops.ec import points_to_host
    rng = np.random.default_rng(SEED + 1)
    for kind, (G, host, gen) in groups().items():
        xs, ys, inf, sc, want = oracle_inputs(G, host, gen, device, rng)
        plan = msm_steps(kind, G, xs, ys, inf, sc, want)
        times = []
        for _ in range(3):
            out, ms = wall_ms(lambda: plan(xs, ys, inf, sc))
            times.append(ms)
        assert points_to_host(G, out)[0] == want, f"MSM {kind} != oracle"
        out_p, plain_ms = wall_ms(lambda: plan.run(xs, ys, inf, sc, M.PLAIN))
        assert points_to_host(G, out_p)[0] == want, \
            f"plain MSM {kind} != oracle"
        best = min(times)
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


def mimc_chain(n_hashes, curve=None):
    """The MiMC chain of n_hashes hashes over ``curve`` (BN254 by default),
    compiled, with its preimage and digest."""
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

    curve = curve or BN254
    t0 = time.perf_counter()
    cs = compile_circuit(MiMCChain(), curve)
    log(f"[groth16] compile {n_hashes} hashes over {curve.name} "
        f"{time.perf_counter() - t0:.2f} s: {cs.nb_constraints} "
        f"constraints, {cs.nb_wires} wires")
    pre = acc = 12345
    for _ in range(n_hashes):
        h = MiMCHost(curve)
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
        parts = {}
        with counted_setup("groth16", BN254) as key:
            pk, vk = groth16.setup(cs, BN254, rng=random.Random(42),
                                   device=device, timings=parts)
            sync()
            key["n_pad"] = pk.n_pad
        log(f"[groth16 {name}] setup on the card "
            f"{time.perf_counter() - t0:.2f} s (domain {pk.domain_n}, "
            f"n_pad {pk.n_pad}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
        assert pk.n_pad == n_msm, pk.n_pad
        served[name] = (cs, pk, vk, pre, digest)

    _cuda.reset_launches()
    reset_plain()
    reset_mont()
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
            check_route(ran, BN254, pk.n_pad, pk.domain_n)
    launches = {f"{k}_{kind}": _cuda.launches[f"{k}_{kind}"]
                for k in _cuda.MSM_KERNELS for kind in BN254_KINDS}
    launches.update({f"{k}_fr_bn254": _cuda.launches[f"{k}_fr_bn254"]
                     for k in _cuda.NTT_KERNELS})
    assert all(v > 0 for v in launches.values()), launches
    assert not plain_runs(), plain_runs()
    log(f"[groth16] launches during the four proves: {launches}")
    check_no_mont("[groth16] the four proves:")

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
    return launches, {name: served[name] + (proofs[name],)
                      for name in served}


def square_chain(n_sq, curve=None):
    """The circuit of scripts/dev_plonk_e2e.py: y = x^(2^n_sq), one
    multiplication gate per squaring, over ``curve`` (BN254 by default)."""
    from gnark_tpu_torch.curves import BN254
    curve = curve or BN254
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
    cs = compile_circuit(SquareChain(), curve, scheme="plonk")
    log(f"[plonk] compile {n_sq} squarings over {curve.name} "
        f"{time.perf_counter() - t0:.2f} s: {cs.nb_constraints} gates")
    x0 = y = 3
    for _ in range(n_sq):
        y = y * y % curve.fr.modulus
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
    with counted_setup("plonk", BN254, "plonk"):
        pk, vk = plonk.setup(cs, BN254, rng=random.Random(42), device=device)
        sync()
    log(f"[plonk sq16] setup on the card {time.perf_counter() - t0:.2f} s "
        f"(domain {pk.n}, quotient domain {pk.x_E.shape[1]}, SRS of "
        f"{len(pk.srs.g1)} points)")
    assert pk.n == N_PLONK and pk.x_E.shape[1] == 4 * N_PLONK
    assert len(pk.srs.g1) == N_PLONK + 3 and pk.device == device

    _cuda.reset_launches()
    reset_plain()
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
        check_route(ran, BN254, len(pk.srs.g1), pk.n, "plonk")
    launches = dict(_cuda.launches)
    # every commitment has 2^16 or more coefficients: the windowed plan
    for k in _cuda.WINDOW_KERNELS:
        assert launches[f"{k}_g1"] > 0, launches
    assert not plain_runs(), plain_runs()
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
    return launches, (cs, pk, vk, x0, y, proof)


def phase_rollup_kernels(device, rates):
    """The four windowed kernels against their plain versions at the plan
    of every MSM of the rollup's Groth16 prove (n_pad = 32,768), G1 and
    G2, on the same CUDA tensors."""
    results = {}
    rng = np.random.default_rng(SEED + 2)
    for kind in groups():
        plan, cases = windowed_cases(kind, ROLLUP_DOMAINS["groth16"],
                                     device, rng)
        assert (plan.c, plan.nwin, plan.nb, plan.R, plan.C) == ROLLUP_PLAN
        for name, (args, kern, plain) in cases.items():
            results[f"{name}_{kind}"] = compare(
                kind, f"{name} c={plan.c} C={plan.C}", args, kern, plain,
                rates, work=name)
    return results


def phase_rollup(device):
    """The users' circuit, BASELINE config 5: the rollup's operator over
    16 accounts with seeded EdDSA keys makes one transfer; RollupCircuit
    compiles under both schemes; setup on the card for each; then the
    main path, through the scheme dispatch a user calls: a cold and two
    warm Groth16 proves and a cold and a warm PLONK prove, with the launch
    counts taken over them; each proof verifies and a wrong root_after is
    rejected; a tampered transfer (amount + 1) fails in the solve, with no
    launch."""
    import copy
    from gnark_tpu_torch import backend
    from gnark_tpu_torch.backend.solver import UnsatisfiedConstraintError
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.examples import rollup
    from gnark_tpu_torch.frontend import schema
    from gnark_tpu_torch.frontend.compile import compile_circuit
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    t0 = time.perf_counter()
    op = rollup.seeded_operator(BN254)
    t1 = time.perf_counter()
    w = op.transfer(0, 1, 100)
    log(f"[rollup] operator over {len(op.accounts)} accounts: EdDSA keys "
        f"{t1 - t0:.2f} s, one transfer (signed, 4 Merkle paths) "
        f"{time.perf_counter() - t1:.2f} s")
    values = schema.collect_values(w)
    public = schema.collect_values(w, "public")
    wrong = [public[0], public[1] + 1]                     # root_after + 1
    tampered = copy.copy(w)
    tampered.amount += 1
    served = {}
    for scheme, (n_constraints, n_wires) in ROLLUP_SIZES.items():
        t0 = time.perf_counter()
        cs = compile_circuit(rollup.RollupCircuit(), BN254, scheme=scheme)
        log(f"[{scheme} rollup] compile {time.perf_counter() - t0:.2f} s: "
            f"{cs.nb_constraints} constraints, {cs.nb_wires} wires")
        assert cs.nb_constraints == n_constraints, cs.nb_constraints
        assert n_wires is None or cs.nb_wires == n_wires, cs.nb_wires
        t0 = time.perf_counter()
        with counted_setup("rollup", BN254, scheme) as key:
            pk, vk = backend.setup(cs, BN254, rng=random.Random(42),
                                   device=device)
            sync()
            key["n_pad"] = getattr(pk, "n_pad", None)
        n = pk.domain_n if scheme == "groth16" else pk.n
        log(f"[{scheme} rollup] setup on the card "
            f"{time.perf_counter() - t0:.2f} s (domain {n}"
            + (f", n_pad {pk.n_pad})" if scheme == "groth16" else
               f", SRS of {len(pk.srs.g1)} points)"))
        assert n == ROLLUP_DOMAINS[scheme] and pk.device == device
        assert scheme == "plonk" or pk.n_pad == ROLLUP_DOMAINS[scheme]
        served[scheme] = (cs, pk, vk)

    _cuda.reset_launches()
    reset_plain()
    proofs = {}
    for scheme, labels in (("groth16", ("cold", "warm", "warm2")),
                           ("plonk", ("cold", "warm"))):
        cs, pk, vk = served[scheme]
        for label in labels:
            before = dict(_cuda.launches)
            timings = {}
            t0 = time.perf_counter()
            proofs[scheme] = backend.prove(cs, pk, values,
                                           rng=random.Random(7),
                                           timings=timings)
            total = time.perf_counter() - t0
            phases = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
            log(f"[{scheme} rollup] prove {label} {total:.2f} s: {phases}")
            ran = {k: v - before[k] for k, v in _cuda.launches.items()
                   if v > before[k]}
            log(f"[{scheme} rollup] launches in this prove: {ran}")
            # every MSM has 2^15 or 2^16 + 3 points: the windowed plan
            assert all(ran.get(f"{k}_g1") for k in _cuda.WINDOW_KERNELS), ran
            assert scheme == "plonk" or all(
                ran.get(f"{k}_g2") for k in _cuda.WINDOW_KERNELS), ran
            assert all(ran.get(f"buckets_{g}") == ran.get(f"weighted_sum_{g}")
                       for g in BN254_KINDS), ran
            check_ntt(ran, BN254, scheme, ROLLUP_DOMAINS[scheme])
    launches = dict(_cuda.launches)
    assert not plain_runs(), plain_runs()
    log(f"[rollup] launches during the five proves: "
        f"{ {k: v for k, v in launches.items() if v} }")

    for scheme, (cs, pk, vk) in served.items():
        t0 = time.perf_counter()
        assert backend.verify(proofs[scheme], vk, public), \
            f"rollup {scheme}: proof does not verify"
        assert not backend.verify(proofs[scheme], vk, wrong), \
            f"rollup {scheme}: proof verifies a wrong root_after"
        log(f"[{scheme} rollup] verify ok, wrong public input (root_after "
            f"+ 1) rejected ({time.perf_counter() - t0:.2f} s)")
        try:
            backend.prove(cs, pk, schema.collect_values(tampered),
                          rng=random.Random(7))
        except UnsatisfiedConstraintError as e:
            log(f"[{scheme} rollup] tampered transfer (amount + 1) fails in "
                f"the solve: {str(e)[:80]}")
        else:
            raise AssertionError(f"rollup {scheme}: tampered transfer proved")
    assert dict(_cuda.launches) == launches, "a tampered prove launched"
    assert not plain_runs(), plain_runs()
    return launches


def phase_bls24_kernels(device, rates):
    """BLS24-315's two kinds, G1 over its fp (N = 10) and G2 over fp4:
    each of the six kernels against its plain version on the same CUDA
    tensors, bit for bit, with its bound: the four windowed kernels at the
    2^16 plan, the ladder, its reduction and the fold of the chunk sums
    at 4096 points, infinity points among them; G1's four windowed
    kernels also at the plan of the PLONK commitments of phase 10
    (N_CURVE_PLONK + 3 points: c = 10, 512 buckets, C = 33).  The fp4
    kernels (leaf_sliced_kernel, lane_offsets_sliced_kernel,
    weighted_sum_sliced_kernel, ladder_sliced_kernel, reduce_sliced_kernel,
    horner_fold_sliced_kernel) are launched twice on their inputs (the
    leaf on the 2^16 plan's of two seeds), both launches against the plain
    version.  Then each kind's 2^16 MSM on the windowed plan against the
    host oracle, and its steps (msm_breakdown).  Returns (the results,
    those at the PLONK plan)."""
    from gnark_tpu_torch.ops import msm as M
    results, at_plonk = {}, {}
    rng = np.random.default_rng(SEED + 3)
    B = M.chunk_bits(16)
    for kind in BLS24_KINDS:
        G, host, gen = groups(BLS24_KINDS)[kind]
        plan, cases = windowed_cases(kind, N_MSM, device, rng)
        GC = plan.GC
        sliced = kind == "g2_bls24315"
        if sliced:
            args, kern, plain = windowed_cases(
                kind, N_MSM, device, np.random.default_rng(SEED + 5))[1][
                    "leaf_prefix"]
            compare(kind, "leaf_prefix seed 12", args, kern, plain, rates,
                    work="leaf_prefix", twice=True)
        lx, ly, linf, lsc, _ = oracle_inputs(G, host, gen, device, rng,
                                             N_LADDER, scalar_modulus(kind))
        linf[::64] = True
        lout = M.ladder(lx, ly, linf, lsc, GC)
        sync()
        cases["ladder"] = ((lx, ly, linf, lsc, GC), M.ladder, M.ladder_plain)
        cases["reduce"] = ((lout, GC), M.reduce, M.reduce_plain)
        for name, (args, kern, plain) in cases.items():
            results[f"{name}_{kind}"] = compare(
                kind, name, args, kern, plain, rates, twice=sliced)
        T = M.reduce(lout, GC)
        compare(kind, f"horner_fold chunks nw={M.LADDER_CHUNKS} c={B}",
                (T, B, GC), M.horner_fold, M.horner_fold_jacobian_plain,
                rates, work="horner_fold", twice=sliced)
    for kind in BLS24_KINDS:
        G, host, gen = groups(BLS24_KINDS)[kind]
        msm_steps(kind, G, *oracle_inputs(G, host, gen, device, rng, N_MSM,
                                          scalar_modulus(kind)))
    kind = BLS24_KINDS[0]
    plan, cases = windowed_cases(kind, N_CURVE_PLONK + 3, device, rng)
    assert (plan.c, plan.nwin, plan.nb, plan.R, plan.C) == CURVE_PLONK_PLAN
    for name, (args, kern, plain) in cases.items():
        at_plonk[f"{name}_{kind}"] = compare(
            kind, f"{name} c={plan.c} C={plan.C}", args, kern, plain, rates,
            work=name)
    return results, at_plonk


# Groth16 over the other curves: request -> (curve, MiMC hashes, MSM
# points).  The chains fill their domain about as BN254's 178 hashes fill
# 2^16 (BLS12-377's MiMC takes the inverse round: 62 constraints a hash,
# not 330); BLS12's at 2^14 (14,653 and 14,633 constraints; 2^16 took
# 176 and 947 hashes, 2^15 88 and 473), their native-route MSMs on one
# host thread the time that phases 12 (the BW6-633 outer proof) and 14
# need; BLS24-315's 12-hash chain is its small
# request (the ladder); the BW6 curves' at 2^12, their host MSMs over
# 761- and 633-bit fp setting the cut.
CURVE_GROTH16 = {
    "bls12_381 mimc": ("bls12_381", 44, N_MSM // 4),
    "bls12_377 mimc": ("bls12_377", 236, N_MSM // 4),
    "bls24_315 mimc": ("bls24_315", 180, N_MSM),
    "bls24_315 mimc12": ("bls24_315", 12, N_LADDER),
    "bw6_761 mimc": ("bw6_761", 9, N_BW6),
    "bw6_633 mimc": ("bw6_633", 10, N_BW6),
}
CURVE_PLONK = ("bls12_381", "bls24_315")


def expected_launches(curve, n_msm, scheme="groth16"):
    """The MSM kernels a prove over ``curve`` launches, as gnark_tpu routes
    it: none on the native route (fp.L >= 24); BN254's or BLS24-315's
    windowed kernels from 8192 points, their ladder, reduction and fold
    below (G1 alone under PLONK).  (Every route launches the quotient's
    kernels too: ntt_launches.)"""
    from gnark_tpu_torch.backend.groth16 import native_route
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    if native_route(curve):
        return set()
    names = (_cuda.WINDOW_KERNELS if n_msm >= M.LADDER_MAX
             else ("ladder", "reduce", "horner_fold"))
    kinds = BN254_KINDS if curve.name == "bn254" else BLS24_KINDS
    kinds = kinds if scheme == "groth16" else kinds[:1]
    return {f"{k}_{kind}" for k in names for kind in kinds}


def watch_compute_h(groth16, seen):
    """Wrap groth16.compute_h so that each call records whether its three
    inputs are CUDA tensors; returns the original."""
    orig = groth16.compute_h

    def watched(domain, a, b, c, **kw):
        seen.append(all(t.is_cuda for t in (a, b, c)))
        return orig(domain, a, b, c, **kw)

    groth16.compute_h = watched
    return orig


def phase_curves_groth16(device):
    """Groth16 over BLS12-381, BLS12-377, BLS24-315, BW6-761 and BW6-633,
    routed as gnark_tpu routes them: setup on the card (the key points on
    the native core for fp.L >= 24), then the main path, each request
    proved cold and warm with the launch counts taken over all of them;
    the quotient's NTTs on the card for every curve (compute_h's inputs
    are CUDA tensors), the MSMs on the native core for fp.L >= 24 and on
    BLS24-315's kernels; each proof verifies, a wrong public input fails."""
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.curves import ALL_CURVES
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    served = {}
    for name, (cname, n_hashes, n_msm) in CURVE_GROTH16.items():
        curve = ALL_CURVES[cname]
        cs, pre, digest = mimc_chain(n_hashes, curve)
        t0 = time.perf_counter()
        parts = {}
        with counted_setup("curves_groth16", curve) as key:
            pk, vk = groth16.setup(cs, curve, rng=random.Random(42),
                                   device=device, timings=parts)
            sync()
            key["n_pad"] = pk.n_pad
        route = ("native core" if groth16.native_route(curve)
                 else "the card's fixed-base kernel")
        log(f"[groth16 {name}] setup {time.perf_counter() - t0:.2f} s, key "
            f"points on {route} (domain {pk.domain_n}, n_pad {pk.n_pad}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
        assert pk.n_pad == n_msm and pk.device == device, pk.n_pad
        served[name] = (curve, cs, pk, vk, pre, digest, n_msm)

    seen = []
    orig = watch_compute_h(groth16, seen)
    _cuda.reset_launches()
    reset_plain()
    reset_mont()
    proofs = {}
    try:
        for name, (curve, cs, pk, vk, pre, digest, n_msm) in served.items():
            for label in ("cold", "warm"):
                before = dict(_cuda.launches)
                timings = {}
                t0 = time.perf_counter()
                proofs[name] = groth16.prove(cs, pk, [digest, pre],
                                             rng=random.Random(7),
                                             timings=timings)
                total = time.perf_counter() - t0
                log(f"[groth16 {name}] prove {label} {total:.2f} s: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
                ran = {k: v - before[k] for k, v in _cuda.launches.items()
                       if v > before[k]}
                log(f"[groth16 {name}] launches in this prove: {ran}")
                check_route(ran, curve, n_msm, pk.domain_n)
    finally:
        groth16.compute_h = orig
    assert len(seen) == 2 * len(served) and all(seen), seen
    assert not plain_runs(), plain_runs()
    launches = {k: v for k, v in _cuda.launches.items() if v}
    log(f"[groth16 curves] launches during the {2 * len(served)} proves: "
        f"{launches}; compute_h on CUDA tensors in each")
    check_no_mont(f"[groth16 curves] the {2 * len(served)} proves:")

    for name, (curve, cs, pk, vk, pre, digest, _) in served.items():
        t0 = time.perf_counter()
        assert groth16.verify(proofs[name], vk, [digest]), \
            f"{name}: proof does not verify"
        assert not groth16.verify(proofs[name], vk, [digest + 1]), \
            f"{name}: proof verifies a wrong public input"
        log(f"[groth16 {name}] verify ok, wrong public input rejected "
            f"({time.perf_counter() - t0:.2f} s)")
    return launches, {name: served[name] + (proofs[name],)
                      for name in served}


def phase_curves_plonk(device):
    """PLONK over BLS12-381 (commitments on the native core) and BLS24-315
    (on its G1 kernels): a squaring chain in a domain of N_CURVE_PLONK,
    setup on the card, then the main path, a cold and a warm prove each
    with the launch counts taken over them; verify, and reject a wrong
    public input."""
    from gnark_tpu_torch.backend import plonk
    from gnark_tpu_torch.curves import ALL_CURVES
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    served = {}
    for cname in CURVE_PLONK:
        curve = ALL_CURVES[cname]
        cs, x0, y = square_chain(N_CURVE_PLONK - 4, curve)
        t0 = time.perf_counter()
        with counted_setup("curves_plonk", curve, "plonk"):
            pk, vk = plonk.setup(cs, curve, rng=random.Random(42),
                                 device=device)
            sync()
        log(f"[plonk {cname}] setup on the card {time.perf_counter() - t0:.2f}"
            f" s (domain {pk.n}, SRS of {len(pk.srs.g1)} points)")
        assert pk.n == N_CURVE_PLONK and pk.device == device
        served[cname] = (curve, cs, pk, vk, x0, y)

    # the windowed plans the proves' commitments take: phase 8 holds the
    # kernels against their plain versions at CURVE_PLONK_PLAN
    plans, orig_plan = set(), M._plan

    def watched_plan(G, n, limbs):
        plan = orig_plan(G, n, limbs)
        plans.add((plan.c, plan.nwin, plan.nb, plan.R, plan.C))
        return plan

    _cuda.reset_launches()
    reset_plain()
    proofs = {}
    M._plan = watched_plan
    try:
        for cname, (curve, cs, pk, vk, x0, y) in served.items():
            for label in ("cold", "warm"):
                before = dict(_cuda.launches)
                timings = {}
                t0 = time.perf_counter()
                proofs[cname] = plonk.prove(cs, pk, [y, x0],
                                            rng=random.Random(7),
                                            timings=timings)
                total = time.perf_counter() - t0
                log(f"[plonk {cname}] prove {label} {total:.2f} s: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
                ran = {k: v - before[k] for k, v in _cuda.launches.items()
                       if v > before[k]}
                log(f"[plonk {cname}] launches in this prove: {ran}")
                check_route(ran, curve, len(pk.srs.g1), pk.n, "plonk")
    finally:
        M._plan = orig_plan
    log(f"[plonk curves] windowed plans (c, windows, buckets, R, C) of the "
        f"commitments: {sorted(plans)}")
    assert plans == {CURVE_PLONK_PLAN}, plans
    assert not plain_runs(), plain_runs()
    launches = {k: v for k, v in _cuda.launches.items() if v}
    log(f"[plonk curves] launches during the four proves: {launches}")
    for cname, (curve, cs, pk, vk, x0, y) in served.items():
        t0 = time.perf_counter()
        assert plonk.verify(proofs[cname], vk, [y]), f"{cname}: no verify"
        assert not plonk.verify(proofs[cname], vk,
                                [(y + 1) % curve.fr.modulus]), \
            f"{cname}: proof verifies a wrong public input"
        log(f"[plonk {cname}] verify ok, wrong public input rejected "
            f"({time.perf_counter() - t0:.2f} s)")
    return launches


# the keys phase 11 takes through files: (label, scheme, curve, the phase
# that served it, its request)
SERIALIZED = (
    ("groth16 mimc178", "groth16", "bn254", "groth16", "mimc178"),
    ("plonk sq16", "plonk", "bn254", "plonk", None),
    ("groth16 bls24_315 mimc", "groth16", "bls24_315", "curves",
     "bls24_315 mimc"),
    ("groth16 bls12_381 mimc", "groth16", "bls12_381", "curves",
     "bls12_381 mimc"),
)


def served_keys(groth16_served, plonk_served, curves_served):
    """The keys of SERIALIZED as (scheme, curve, cs, pk, vk, witness,
    public inputs, the in-memory key's proof with rng 7, MSM points)."""
    from gnark_tpu_torch.curves import ALL_CURVES
    out = {}
    for label, scheme, cname, source, request in SERIALIZED:
        curve = ALL_CURVES[cname]
        if source == "groth16":
            cs, pk, vk, pre, digest, proof = groth16_served[request]
            values, public, n = [digest, pre], [digest], pk.n_pad
        elif source == "plonk":
            cs, pk, vk, x0, y, proof = plonk_served
            values, public, n = [y, x0], [y], len(pk.srs.g1)
        else:
            _, cs, pk, vk, pre, digest, n, proof = curves_served[request]
            values, public = [digest, pre], [digest]
        out[label] = (scheme, curve, cs, pk, vk, values, public, proof, n)
    return out


def phase_serialization(device, keys):
    """The keys that phases 5, 6 and 9 served, through files: each written
    to a temporary directory and read back onto the card with safe=False
    and with safe=True; then the main path, a prove from each loaded key
    (cold, then warm from the other) with the in-memory key's rng, with the
    launch counts taken over them: the same proof bytes as the in-memory
    key's, the kernels its route names (none on the native route); the
    proof and the verifying key through bytes, verify, reject a wrong
    public input; the constraint system through cs_io, solved; last,
    examples/serialization_main.py on the card."""
    import tempfile

    from gnark_tpu_torch import backend
    from gnark_tpu_torch.backend import cs_io, key_io, serialize
    from gnark_tpu_torch.examples import serialization_main
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M

    loaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (scheme, curve, cs, pk, vk, values, public, proof,
                    n) in keys.items():
            path = os.path.join(tmp, label.replace(" ", "_") + ".npz")
            write = (key_io.groth16_pk_write if scheme == "groth16"
                     else key_io.plonk_pk_write)
            t0 = time.perf_counter()
            write(pk, path)
            t_write = time.perf_counter() - t0
            size = os.path.getsize(path)
            t_read = {}
            for safe in (False, True):
                t0 = time.perf_counter()
                if scheme == "groth16":
                    got = key_io.groth16_pk_read(path, safe=safe,
                                                 device=device)
                else:
                    got = key_io.plonk_pk_read(path, device=device)
                sync()
                t_read[safe] = time.perf_counter() - t0
                loaded[label, safe] = got
            assert loaded[label, False].device == device
            second = "safe=True" if scheme == "groth16" else "read again"
            log(f"[serialization {label}] key file {size / 2**20:.1f} MiB: "
                f"write {t_write:.2f} s, read onto the card {t_read[False]:.2f}"
                f" s ({second} {t_read[True]:.2f} s)")

    _cuda.reset_launches()
    reset_plain()
    proofs = {}
    for label, (scheme, curve, cs, pk, vk, values, public, proof,
                n) in keys.items():
        to_bytes = (serialize.proof_to_bytes if scheme == "groth16"
                    else serialize.plonk_proof_to_bytes)
        want = to_bytes(proof, curve)
        for run, safe in (("cold", False), ("warm", True)):
            before = dict(_cuda.launches)
            timings = {}
            t0 = time.perf_counter()
            proofs[label] = backend.prove(cs, loaded[label, safe], values,
                                          rng=random.Random(7),
                                          timings=timings)
            total = time.perf_counter() - t0
            assert to_bytes(proofs[label], curve) == want, \
                f"{label}: the loaded key proves another proof"
            ran = {k: v - before[k] for k, v in _cuda.launches.items()
                   if v > before[k]}
            key = loaded[label, safe]
            check_route(ran, curve, n, key.domain_n if scheme == "groth16"
                        else key.n, scheme)
            which = ("first" if not safe else
                     "safe=True" if scheme == "groth16" else "second")
            log(f"[serialization {label}] prove from the loaded key "
                f"({which}) {run} {total:.2f} s, the in-memory key's "
                f"proof bytes: " + ", ".join(f"{k} {v:.3f}"
                                             for k, v in timings.items()))
            log(f"[serialization {label}] launches in this prove: {ran}")
    assert not plain_runs(), plain_runs()
    launches = {k: v for k, v in _cuda.launches.items() if v}
    log(f"[serialization] launches during the {2 * len(keys)} proves: "
        f"{launches}")

    for label, (scheme, curve, cs, pk, vk, values, public, proof,
                n) in keys.items():
        t0 = time.perf_counter()
        if scheme == "groth16":
            pblob = serialize.proof_to_bytes(proofs[label], curve)
            vblob = serialize.vk_to_bytes(vk)
            proof2 = serialize.proof_from_bytes(pblob, curve)
            vk2 = serialize.vk_from_bytes(vblob, curve)
        else:
            pblob = serialize.plonk_proof_to_bytes(proofs[label], curve)
            vblob = key_io.plonk_vk_to_bytes(vk)
            proof2 = serialize.plonk_proof_from_bytes(pblob, curve)
            vk2 = key_io.plonk_vk_from_bytes(vblob, curve)
        t_bytes = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert backend.verify(proof2, vk2, public), f"{label}: no verify"
        t_verify = time.perf_counter() - t0
        wrong = [(public[0] + 1) % curve.fr.modulus] + public[1:]
        assert not backend.verify(proof2, vk2, wrong), \
            f"{label}: proof verifies a wrong public input"
        t0 = time.perf_counter()
        blob = cs_io.cs_to_bytes(cs)
        cs2 = cs_io.cs_from_bytes(blob)
        t_cs = time.perf_counter() - t0
        assert cs_io.cs_to_bytes(cs2) == blob
        t0 = time.perf_counter()
        backend.solve(cs2, values)
        t_solve = time.perf_counter() - t0
        log(f"[serialization {label}] proof {len(pblob)} B and vk "
            f"{len(vblob)} B through bytes {t_bytes:.2f} s, verify after "
            f"the reload {t_verify:.2f} s, wrong public input rejected; "
            f"constraint system {len(blob) / 2**20:.1f} MiB through cs_io "
            f"{t_cs:.2f} s, solved {t_solve:.2f} s")

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serialization_main.main(device=device)
    for line in out.getvalue().splitlines():
        log(f"[serialization example] {line}")
    log(f"[serialization] examples/serialization_main.py on the card "
        f"{time.perf_counter() - t0:.2f} s")
    return launches


# one-layer recursion: inner curve -> (outer curve, constraints of the
# in-circuit verifier, the outer key's domain)
RECURSION = {"bls12_377": ("bw6_761", 92555, 1 << 17),
             "bls24_315": ("bw6_633", 177631, 1 << 18)}


def recursion_circuit(vk):
    """The in-circuit Groth16 verifier of proofs of ``vk`` (BLS12-377 or
    BLS24-315) as a circuit over the outer curve (tests/test_recursion.py's
    RecursionCircuit and its BLS24-315 sibling): the inner public input
    public, the proof's coordinates secret."""
    from gnark_tpu_torch.frontend.schema import Circuit, Public, Secret
    from gnark_tpu_torch.std import groth16_bls12377, groth16_bls24315
    k = len(vk.beta_g2[0])
    verifier = groth16_bls12377 if k == 2 else groth16_bls24315

    class RecursionCircuit(Circuit):
        inner_y = Public()
        ar = Secret(shape=(2,))
        krs = Secret(shape=(2,))
        bs_x = Secret(shape=(k,))
        bs_y = Secret(shape=(k,))

        def define(self, api):
            verifier.verify_proof(api, vk, tuple(self.ar),
                                  (tuple(self.bs_x), tuple(self.bs_y)),
                                  tuple(self.krs), [self.inner_y])
    return RecursionCircuit


def recursion_witness(proof, y):
    """[public | secret] values of RecursionCircuit for ``proof``."""
    return [y, *proof.ar, *proof.krs, *proof.bs[0], *proof.bs[1]]


def prepare_recursion(device, ready):
    """The host side of phase 12, which runs while nvcc builds the
    kernels: for each inner curve the cubic circuit's key, set up on the
    card (BLS12-377 on the native route; BLS24-315 on the fixed-base
    kernel, once ``ready()`` has returned: the builds are done); its
    verifying key through bytes; the in-circuit verifier of that key
    compiled over the outer curve."""
    from gnark_tpu_torch.backend import groth16, serialize
    from gnark_tpu_torch.curves import ALL_CURVES
    from gnark_tpu_torch.examples.cubic import CubicCircuit
    from gnark_tpu_torch.frontend.compile import compile_circuit

    prepared = {}
    for inner, (outer, n_constraints, _) in RECURSION.items():
        curve, ocurve = ALL_CURVES[inner], ALL_CURVES[outer]
        tag = f"[recursion {inner} in {outer}]"
        cs_in = compile_circuit(CubicCircuit(), curve)
        if not groth16.native_route(curve):
            t0 = time.perf_counter()
            ready()
            log(f"{tag} waited {time.perf_counter() - t0:.2f} s for the "
                f"nvcc builds")
        t0 = time.perf_counter()
        with counted_setup("recursion", curve) as key:
            pk_in, vk_in = groth16.setup(cs_in, curve, rng=random.Random(9),
                                         device=device)
            sync()
            key["n_pad"] = pk_in.n_pad
        route = ("native core" if groth16.native_route(curve)
                 else "the card's fixed-base kernel")
        log(f"{tag} inner setup {time.perf_counter() - t0:.2f} s, key "
            f"points on {route} (domain {pk_in.domain_n}, n_pad "
            f"{pk_in.n_pad})")
        vblob = serialize.vk_to_bytes(vk_in)
        vk_c = serialize.vk_from_bytes(vblob, curve)
        t0 = time.perf_counter()
        cs = compile_circuit(recursion_circuit(vk_c)(), ocurve)
        log(f"{tag} verifier of the {len(vblob)}-byte inner vk compiled "
            f"{time.perf_counter() - t0:.2f} s: {cs.nb_constraints} "
            f"constraints, {cs.nb_wires} wires")
        assert cs.nb_constraints == n_constraints, cs.nb_constraints
        prepared[inner] = (cs_in, pk_in, vk_c, cs)
    return prepared


def recursion_outer_setup(device, prepared, inner):
    """The outer Groth16 key of ``inner``'s verifier, through the card's
    entry point (the native route: the QAP and the key points on the
    native core, single-threaded, out of the GIL; no kernel), with its
    seconds.  Both keys run in one worker thread beside phases 2-11."""
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.curves import ALL_CURVES
    ocurve = ALL_CURVES[RECURSION[inner][0]]
    assert groth16.native_route(ocurve)
    t0 = time.perf_counter()
    pk, vk = groth16.setup(prepared[inner][3], ocurve,
                           rng=random.Random(11), device=device)
    return pk, vk, time.perf_counter() - t0


def phase_recursion(device, prepared, outer_keys):
    """One-layer recursion on the card, the main path: each inner cubic
    proof made on the card (BLS12-377: the quotient's NTTs on the card,
    MSMs on the native core; BLS24-315: its ladder, reduction and Horner
    fold for G1 and fp4 G2), carried as bytes; the in-circuit verifier of
    phase 12's prepared system solved with it by the native solver; then
    the outer Groth16 keys (``outer_keys``: the background worker's
    futures of ``recursion_outer_setup``, on the native route, BW6-761 at
    domain 2^17, BW6-633 at 2^18) prove with rng 12, as the reference's
    tests, both at once on two host threads, each MSM on the native
    core's one thread, while this thread has the solver refuse each wrong
    inner public input.  The outer proves launch their quotients' NTT
    kernels, exactly ntt_launches, and no MSM kernel; each verifies, a
    wrong public input rejected.  The launch counts are taken over all of
    it."""
    from gnark_tpu_torch.backend import groth16, serialize, solver
    from gnark_tpu_torch.curves import ALL_CURVES
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M

    tags = {inner: f"[recursion {inner} in {outer}]"
            for inner, (outer, _, _) in RECURSION.items()}
    seen = []
    orig = watch_compute_h(groth16, seen)
    _cuda.reset_launches()
    reset_plain()
    witnesses, keys = {}, {}
    try:
        for inner, tag in tags.items():
            cs_in, pk_in, vk_c, cs = prepared[inner]
            curve = ALL_CURVES[inner]
            before = dict(_cuda.launches)
            timings = {}
            t0 = time.perf_counter()
            proof = groth16.prove(cs_in, pk_in, [35, 3],
                                  rng=random.Random(10), timings=timings)
            total = time.perf_counter() - t0
            ran = {k: v - before[k] for k, v in _cuda.launches.items()
                   if v > before[k]}
            log(f"{tag} inner prove on the card {total:.2f} s: "
                + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
            log(f"{tag} launches in the inner prove: {ran}")
            check_route(ran, curve, pk_in.n_pad, pk_in.domain_n)
            pblob = serialize.proof_to_bytes(proof, curve)
            proof_c = serialize.proof_from_bytes(pblob, curve)
            assert groth16.verify(proof_c, vk_c, [35])
            assert not groth16.verify(proof_c, vk_c, [36])

            w = witnesses[inner] = recursion_witness(proof_c, 35)
            t0 = time.perf_counter()
            solver.solve(cs, w)
            log(f"{tag} the {len(pblob)}-byte inner proof satisfies the "
                f"verifier: solve {time.perf_counter() - t0:.2f} s (native "
                f"solver)")

            t0 = time.perf_counter()
            pk, vk, t_setup = outer_keys[inner].result()
            log(f"{tag} outer setup {t_setup:.2f} s (beside phases 2-11; "
                f"phase 12 waited {time.perf_counter() - t0:.2f} s for "
                f"it), key points on the native core (domain "
                f"{pk.domain_n}, n_pad {pk.n_pad})")
            assert pk.device == device
            assert pk.domain_n == RECURSION[inner][2], pk.domain_n
            keys[inner] = pk, vk

        def outer_prove(inner):
            timings = {}
            t0 = time.perf_counter()
            proof = groth16.prove(prepared[inner][3], keys[inner][0],
                                  witnesses[inner], rng=random.Random(12),
                                  timings=timings)
            return proof, time.perf_counter() - t0, timings

        before = dict(_cuda.launches)
        t_outer = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(tags)) as pool:
            futures = {inner: pool.submit(outer_prove, inner)
                       for inner in tags}
            for inner, w in witnesses.items():
                t0 = time.perf_counter()
                assert not solver.is_solved(prepared[inner][3],
                                            [36] + w[1:]), \
                    f"{tags[inner]}: a wrong inner public input is accepted"
                log(f"{tags[inner]} inner public input 36 refused "
                    f"{time.perf_counter() - t0:.2f} s (beside the outer "
                    f"proves)")
            outs = {inner: f.result() for inner, f in futures.items()}
        log(f"[recursion] both outer proves and the refusals "
            f"{time.perf_counter() - t_outer:.2f} s")
        # the native route: each outer quotient's NTT kernels, exactly,
        # and no MSM kernel
        ran = {k: v - before[k] for k, v in _cuda.launches.items()
               if v > before[k]}
        want = {}
        for inner, (outer, _, domain) in RECURSION.items():
            assert keys[inner][0].domain_n == domain
            want.update(ntt_launches(ALL_CURVES[outer], "groth16", domain))
        assert ran == want, (ran, want)
        log(f"[recursion] launches in the two outer proves: {ran}")
        for inner, (oproof, total, timings) in outs.items():
            tag, vk = tags[inner], keys[inner][1]
            log(f"{tag} outer prove {total:.2f} s (beside the other): "
                + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
            t0 = time.perf_counter()
            assert groth16.verify(oproof, vk, [35]), f"{tag}: no verify"
            t_verify = time.perf_counter() - t0
            assert not groth16.verify(oproof, vk, [36]), \
                f"{tag}: the outer proof verifies a wrong public input"
            log(f"{tag} outer verify ok {t_verify:.2f} s, wrong public input "
                f"rejected")
    finally:
        groth16.compute_h = orig
    assert len(seen) == 4 and all(seen), seen
    assert not plain_runs(), plain_runs()
    launches = {k: v for k, v in _cuda.launches.items() if v}
    log(f"[recursion] launches: {launches}; compute_h on CUDA tensors in "
        f"each of the {len(seen)} proves")
    return launches


# phase 13: the mesh prover on two gloo ranks that share the card
SHARDED_RANKS = 2
SHARDED_SIZES = (N_MSM, N_LADDER)   # 2^15 a rank (windowed), 2,048 (ladder)
SHARDED_GROUP_S = 240               # a collective waits at most this long
SHARDED_JOIN_S = 420                # and the ranks together at most this


def sharded_prove_route():
    """A rank's launches in one mesh prove of the chain: each of the five
    MSMs (four G1, one G2) runs the windowed plan on the rank's 2^15
    points, and reduce folds the ranks' partials; the quotient's seven
    four-step transforms, each one local transform of the rank's N_MSM /
    SHARDED_RANKS columns (its passes from the library's plan), and its
    pointwise step on the rank's block."""
    route = {f"{k}_{kind}": 4 if kind == "g1" else 1
             for k in ("leaf_prefix", "lane_offsets", "buckets",
                       "weighted_sum", "horner_fold", "reduce")
             for kind in BN254_KINDS}
    route["ntt_fr_bn254"] = 7 * passes(N_MSM // SHARDED_RANKS, "fr_bn254")
    route["fr_pointwise_fr_bn254"] = 1
    return route


def sharded_rank(tmp, values, cfg):
    """One rank of phase 13 (spawned by parallel.ranks; every rank on the
    one card, or on the CPU in a rehearsal).  ``cfg``: the device, the MSM
    sizes and the transforms' size."""
    import datetime

    import torch
    import torch.distributed as dist

    from gnark_tpu_torch.backend import cs_io, groth16, key_io, serialize
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops.ec import points_to_host
    from gnark_tpu_torch.ops.limbs import field_ops
    from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm
    from gnark_tpu_torch.parallel import multihost
    from gnark_tpu_torch.parallel.sharded_msm import ShardedMSM
    from gnark_tpu_torch.parallel.sharded_ntt import ShardedDomain

    device = torch.device(cfg["device"])
    world = int(os.environ["WORLD_SIZE"])
    multihost.init_distributed(
        backend="gloo", timeout=datetime.timedelta(seconds=SHARDED_GROUP_S))
    mesh = multihost.init_mesh(ntt_axis="shard", backend="gloo")
    assert mesh.get_group("shard").size() == world
    if device.type == "cuda":
        for kind in BN254_KINDS:
            _cuda.load(kind)
        assert _cuda.build_info["msm"]["command"] == "(cached)", \
            "a rank rebuilt the kernels"
    out = {"rank": dist.get_rank(), "msm": {}, "ntt": {}, "prove": {}}
    reset_plain()

    # 1. the sharded MSM against the host oracle and the unsharded msm;
    # the counts are set to 0 after the unsharded comparison, so they hold
    # the ShardedMSM calls' launches alone
    msm_launches = dict.fromkeys(_cuda.launches, 0)
    rng = np.random.default_rng(SEED + 13)
    for kind, (G, host, gen) in groups().items():
        for n in cfg["sizes"]:
            xs, ys, inf, sc, want = oracle_inputs(G, host, gen, device, rng,
                                                  n)
            ref = M.msm(G, xs, ys, inf, sc)
            sync()
            plan = ShardedMSM(G, mesh, "shard", n, sc.shape[0])
            _cuda.reset_launches()
            plan(xs, ys, inf, sc)                   # warm-up
            got, ms = wall_ms(lambda: plan(xs, ys, inf, sc))
            for k, v in _cuda.launches.items():
                msm_launches[k] += v
            assert points_to_host(G, got)[0] == points_to_host(G, ref)[0] \
                == want, f"sharded MSM {kind} n={n} != oracle"
            out["msm"][f"{kind} {n}"] = ms
    out["launches_msm"] = {k: v for k, v in msm_launches.items() if v}

    # 2. the four-step transforms against the unsharded Domain
    spec, n = BN254.fr, cfg["ntt_n"]
    F = field_ops(spec)
    t0 = time.perf_counter()
    sd = ShardedDomain(spec, n, mesh, "shard", device)
    out["ntt"]["tables_s"] = time.perf_counter() - t0
    dom = Domain(spec, n, device)
    vals = np.random.default_rng(SEED + 14).integers(1, 1 << 62, (4, n))
    x, a, b, c = (F.pack([int(v) for v in row], device) for row in vals)
    brev = torch.from_numpy(bit_reverse_perm(n).astype(np.int64)).to(device)
    evals = dom.fft(x, "DIF")[:, brev]
    checks = {
        "fft": (lambda: sd.deinterleave(sd.gather(sd.fft(sd.block(x)))
                                        .cpu().numpy()), evals),
        "ifft": (lambda: sd.deinterleave(sd.gather(sd.ifft(sd.block(
            evals))).cpu().numpy()), x),
        "fft_from_strided": (lambda: sd.gather(sd.fft_from_strided(
            sd.ifft(sd.block(evals)))), evals),
        "compute_h": (lambda: sd.gather(sd.compute_h(
            sd.block(a), sd.block(b), sd.block(c)))[:, torch.from_numpy(
                sd.strided_to_brev_perm().astype(np.int64)).to(device)],
            groth16.compute_h(dom, a, b, c)),
    }
    for name, (fn, want) in checks.items():
        got, ms = wall_ms(fn)
        got = torch.as_tensor(got).to(device)
        assert torch.equal(got, want), f"sharded {name} != Domain"
        out["ntt"][name] = ms
    # the gloo staging alone: one all-to-all of this rank's block
    blk = sd.block(x).reshape(spec.L, world, -1)
    out["ntt"]["all_to_all"] = min(wall_ms(lambda: sd._transpose(blk))[1]
                                   for _ in range(5))

    # 3. the mesh prove of the 2^16 MiMC chain from phase 5's key; the
    # counts are set to 0 just before each prove and must show its route
    t0 = time.perf_counter()
    pk = key_io.groth16_pk_read(os.path.join(tmp, "pk.npz"), device=device)
    with open(os.path.join(tmp, "cs.bin"), "rb") as f:
        cs = cs_io.cs_from_bytes(f.read())
    out["load_s"] = time.perf_counter() - t0
    prove_launches = dict.fromkeys(_cuda.launches, 0)
    for label in ("cold", "warm"):
        timings = {}
        _cuda.reset_launches()
        t0 = time.perf_counter()
        proof = groth16.prove(cs, pk, values, rng=random.Random(7),
                              timings=timings, mesh=mesh, mesh_axis="shard")
        total = time.perf_counter() - t0
        ran = {k: v for k, v in _cuda.launches.items() if v}
        if device.type == "cuda":
            assert ran == sharded_prove_route(), \
                f"the {label} mesh prove launched {ran}, not its route"
        for k, v in ran.items():
            prove_launches[k] += v
        out["prove"][label] = dict(total=total, launches=ran, **timings)
    out["launches_prove"] = {k: v for k, v in prove_launches.items() if v}
    out["proof"] = serialize.proof_to_bytes(proof, BN254).hex()
    dist.barrier()
    assert not plain_runs(), plain_runs()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
    assert not bad, f"loaded: {bad}"
    return out


def phase_sharded(device, served):
    """The mesh prover, the main path of phase 13: the 2^16 MiMC key and
    system that phase 5 served go through key_io and cs_io into a
    temporary directory; two ranks spawned on this card (gloo, the
    collectives staged through host memory: two NCCL ranks on one device
    are refused) each check the sharded MSM (G1, G2 at 2^16 and 4,096
    points) against the oracle and the unsharded msm, the four-step
    transforms and quotient at 2^16 against the unsharded Domain and
    compute_h, then prove the chain on the mesh, cold and warm, with rng
    7: phase 5's proof bytes, verified here and a wrong public input
    rejected.  Each prove launches exactly sharded_prove_route() in each
    rank.  Returns the launches summed over the ranks: the mesh proves'
    and the ShardedMSM checks', apart (the unsharded comparisons left
    out)."""
    import tempfile

    from gnark_tpu_torch.backend import cs_io, groth16, key_io, serialize
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.parallel.ranks import start_ranks

    cs, pk, vk, pre, digest, proof = served["mimc178"]
    want = serialize.proof_to_bytes(proof, BN254)
    with tempfile.TemporaryDirectory() as tmp:
        key_io.groth16_pk_write(pk, os.path.join(tmp, "pk.npz"))
        with open(os.path.join(tmp, "cs.bin"), "wb") as f:
            f.write(cs_io.cs_to_bytes(cs))
        t0 = time.perf_counter()
        cfg = dict(device=str(device), sizes=SHARDED_SIZES, ntt_n=N_MSM)
        results = start_ranks(sharded_rank, SHARDED_RANKS,
                              (tmp, [digest, pre], cfg),
                              timeout=SHARDED_JOIN_S).join()
        t_ranks = time.perf_counter() - t0
    log(f"[sharded] {SHARDED_RANKS} gloo ranks on one card: spawned, ran "
        f"and joined in {t_ranks:.2f} s")
    for res in results:
        tag = f"[sharded rank {res['rank']}]"
        log(f"{tag} sharded MSM (ms) = oracle = unsharded msm: " + ", ".join(
            f"{k} {v:.1f}" for k, v in res["msm"].items()))
        log(f"{tag} launches in the ShardedMSM checks: {res['launches_msm']}")
        log(f"{tag} four-step NTT at n = {N_MSM} = unsharded Domain (ms): " +
            ", ".join(f"{k} {v:.1f}" for k, v in res["ntt"].items()
                      if k not in ("tables_s", "all_to_all")) +
            f"; tables {res['ntt']['tables_s']:.2f} s; one all-to-all of "
            f"the rank's block through gloo {res['ntt']['all_to_all']:.2f}"
            f" ms")
        log(f"{tag} key and system read in {res['load_s']:.2f} s")
        for label, t in res["prove"].items():
            ran = t.pop("launches")
            total = t.pop("total")
            log(f"{tag} mesh prove {label} {total:.2f} s: " + ", ".join(
                f"{k} {v:.3f}" for k, v in t.items()))
            log(f"{tag} launches in the {label} mesh prove (its route): "
                f"{ran}")
        assert bytes.fromhex(res["proof"]) == want, \
            f"{tag}: the mesh proof is not phase 5's proof"
    mesh_proof = serialize.proof_from_bytes(want, BN254)
    assert groth16.verify(mesh_proof, vk, [digest])
    assert not groth16.verify(mesh_proof, vk, [digest + 1])
    l_prove, l_msm = {}, {}
    for res in results:
        for total, part in ((l_prove, res["launches_prove"]),
                            (l_msm, res["launches_msm"])):
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
    need = {f"{k}_{kind}" for k in _cuda.MSM_KERNELS
            for kind in BN254_KINDS}
    assert need <= set(l_msm), (need, l_msm)
    log(f"[sharded] each rank's proof is phase 5's {len(want)} bytes; it "
        f"verifies, a wrong public input is rejected; launches in the "
        f"ranks' mesh proves: {l_prove}; in their ShardedMSM checks: "
        f"{l_msm}")
    return l_prove, l_msm


# phase 14: the 2^20 Groth16 prove (gnark_tpu_torch/scripts/dev_e2e_2e20.py)
# and the plan of its MSMs, 2^21 points: (c, windows, buckets, R, C)
E2E_LOG = 20
N_2E21 = 1 << 21
PLAN_2E21 = (14, 19, 8192, 512, 4096)
LEAF_WINDOWS_2E21 = 2   # windows the leaf is held on
LEAF_SEGMENT = 64       # steps a segment of the plain leaf there


def gb(nbytes):
    return f"{nbytes / 1e9:.2f} GB"


def oracle_inputs_limbs(G, host, gen, device, rng, n):
    """oracle_inputs' points and oracle at n points (a multiple of 64),
    the scalars drawn as 16-bit limbs (the top one below r's, so each
    scalar is below r) and the expected sum taken from the limbs' column
    sums: seconds where a Python int a scalar takes tens at 2^21."""
    import torch
    from gnark_tpu_torch.curves import BN254
    r = BN254.fr.modulus
    base, P = [], gen
    for _ in range(64):
        base.append(P)
        P = host.double(P)
    xs = G.F.pack([p[0] for p in base], device).repeat(1, n // 64)
    ys = G.F.pack([p[1] for p in base], device).repeat(1, n // 64)
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] %= r >> 240
    # sum_i s_i 2^(i mod 64) = sum_{k, j} 2^(16k + j) sum_{i = j mod 64}
    # limb k of s_i
    col = limbs.reshape(16, n // 64, 64).sum(1)
    total = sum(int(col[k, j]) << (16 * k + j)
                for k in range(16) for j in range(64)) % r
    sc = torch.from_numpy(limbs).to(device)
    return xs, ys, inf, sc, host.scalar_mul(gen, total)


def leaf_seeded(seg):
    """(kernel, plain) for the leaf at a long chain.  The kernel is the
    leaf's wrapper, keeping the rows of its last launch.  The plain
    version cuts every chain into segments of ``seg`` steps and runs them
    all at once through leaf_prefix_plain, segment k started from the row
    that launch gave after step k seg - 1 (segment 0 from the identity).
    ``compare`` launches the kernel just before it calls the plain
    version, so the seeds come from the launch that is compared: its rows
    equal the plain ones in every segment only if, by induction over the
    segments, they equal those of one plain run over the whole chain,
    each segment's seed being the last row of the segment before, itself
    held against the plain version.  (One plain run is a 4,096-step torch
    loop, 45-77 s on the card.)"""
    import torch
    from gnark_tpu_torch.ops import msm as M
    last = {}

    def kernel(sx, sy, GC):
        last["rows"] = M.leaf_prefix(sx, sy, GC)
        return last["rows"]

    def plain(sx, sy, GC):
        nw, C, L, R = sx.shape
        K = C // seg
        assert K * seg == C, (C, seg)
        rows = last["rows"]
        assert rows.shape == (nw, C * R, 3 * L), rows.shape
        seeds = rows.reshape(nw, C, R, 3 * L)[:, seg - 1::seg][:, :K - 1]
        ident = torch.cat(GC.inf((nw, 1, R), sx.device)).permute(1, 2, 3, 0)
        acc = torch.cat([ident, seeds], 1).permute(3, 0, 1, 2)
        out = M.leaf_prefix_plain(sx.reshape(nw * K, seg, L, R),
                                  sy.reshape(nw * K, seg, L, R), GC,
                                  acc=acc.reshape(3 * L, nw * K, R))
        return out.reshape(nw, C * R, 3 * L)
    return kernel, plain


def merged_rows(rows):
    """One kernels-line row of a kernel compared on several calls (the
    bucket step, a window chunk each): times and bounds summed, the error
    the largest."""
    out = dict(rows[0])
    for r in rows[1:]:
        for k in ("ms", "plain_ms", "bound_ms", "bound_ms_at_mad_rate"):
            out[k] += r[k]
        out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
    out["calls"] = len(rows)
    return out


def cases_2e21(kind, G, xs, ys, inf, sc, rates):
    """The five windowed kernels' inputs along the 2^21-point plan, chunk by
    chunk as MSM.run takes them (one kernel-path run, its steps kept): the
    leaf's sorted points of the first LEAF_WINDOWS_2E21 windows, and every
    window's lane totals, buckets and sums.  The bucket step is compared
    inside that run, on each window chunk while its leaf rows live (all
    19 windows' rows would not fit beside the chunk).  Returns (the plan,
    its chunks, {name: (args, kernel, plain)}, the bucket step's row)."""
    import torch
    from gnark_tpu_torch.ops import msm as M
    plan = M.MSM(G, N_2E21, 16)
    assert (plan.c, plan.nwin, plan.nb, plan.R, plan.C) == PLAN_2E21, \
        (plan.c, plan.nwin, plan.nb, plan.R, plan.C)
    chunks = plan.chunks(xs.device)
    GC = plan.GC
    kept = {name: [] for name in ("sort_gather", "leaf_prefix", "buckets",
                                  "weighted_sum")}
    compared = []

    def keep(name, fn):
        out = fn()
        if name == "recode":
            assert bool((out[2] != 0).any()), "no negative digit in the inputs"
        elif name == "sort_gather":
            if not kept[name]:
                kept[name].append(tuple(t[:LEAF_WINDOWS_2E21].clone()
                                        for t in out[:2]))
        elif name == "leaf_prefix":             # the lane offsets' input
            kept[name].append(plan.lane_totals(out))
        elif name in kept:
            kept[name].append(out)
        return out

    def buckets(*args):
        w0, w1 = chunks[len(compared)]
        compared.append(compare(
            kind, f"buckets 2^21 plan, windows {w0}-{w1 - 1}", args,
            M.buckets, M.buckets_plain, rates, work="buckets"))
        return M.buckets(*args)

    impl = M.WRAPPERS[:2] + (buckets,) + M.WRAPPERS[3:]
    plan.run(xs, ys, inf, sc, impl, step=keep)
    sync()
    tot, bk, S = (torch.cat(kept[k], 1).contiguous()
                  for k in ("leaf_prefix", "buckets", "weighted_sum"))
    log(f"[kernels {kind} 2^21] plan at n={N_2E21}: c={plan.c} "
        f"nwin={plan.nwin} nb={plan.nb} R={plan.R} C={plan.C}, window "
        f"chunks {chunks}")
    leaf, leaf_plain = leaf_seeded(LEAF_SEGMENT)
    return plan, chunks, {
        "leaf_prefix": (kept["sort_gather"][0] + (GC,), leaf, leaf_plain),
        "lane_offsets": ((tot, GC), M.lane_offsets, M.lane_offsets_plain),
        "weighted_sum": ((bk, GC), M.weighted_sum, M.weighted_sum_plain),
        "horner_fold": ((S, plan.c, GC), M.horner_fold,
                        M.horner_fold_jacobian_plain),
    }, merged_rows(compared)


def phase_2e20(device, rates):
    """Phase 14, the 2^20 path.  For G1 and G2 over 2^21 oracle inputs: the
    five windowed kernels against their plain versions at the plan's shapes
    (the leaf on LEAF_WINDOWS_2E21 windows, the others on all 19, the
    bucket step a window chunk at a time), then the
    MSM on the chunked plan against the host oracle, with its steps, its
    chunk count and its peak memory.  Then the main path: the 2^20 - 1
    constraint squaring chain through dev_e2e_2e20.run (setup on the card,
    a cold and two warm proves, verify, y + 1 rejected), the launch counts
    set to zero just before it and read just after: a prove's four G1 MSMs
    and one G2 MSM each launch the Horner fold once and the leaf, the lane
    offsets, the bucket step and the weighted sum once a window chunk; the
    ladder and
    reduction never; no plain version on the card.  Returns (the kernel
    rows, the path's launches)."""
    import torch
    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.ops import _cuda
    from gnark_tpu_torch.ops import msm as M
    from gnark_tpu_torch.ops.ec import points_to_host
    from gnark_tpu_torch.scripts import dev_e2e_2e20
    results, nchunks = {}, {}
    rng = np.random.default_rng(SEED + 2)
    # the 2^20 quotient's kernels: prove's three transform shapes
    # (compute_h in regular form) and its pointwise step
    ntt = ntt_rows("fr_bn254", 1 << E2E_LOG, device, rates, rng,
                   QUOTIENT_SHAPES, reps=5)
    # what streaming the planes once costs: a torch copy (a read and a
    # write of [16, 2^20] int64; the transform's two passes do each twice)
    x = ntt_inputs(fr_spec("fr_bn254"), 1 << E2E_LOG, device, rng)
    y = torch.empty_like(x)
    log(f"[kernels fr_bn254] n=2^{E2E_LOG}: one torch copy of the planes "
        f"{cuda_ms(lambda: y.copy_(x), 5):.4f} ms (a read and a write, "
        f"{2 * x.numel() * 8} bytes); the transform's passes read and "
        f"write them {passes(1 << E2E_LOG, 'fr_bn254')} times")
    del x, y
    torch.cuda.empty_cache()
    for kind, (G, host, gen) in groups().items():
        t0 = time.perf_counter()
        xs, ys, inf, sc, want = oracle_inputs_limbs(G, host, gen, device,
                                                    rng, N_2E21)
        log(f"[kernels {kind} 2^21] oracle inputs "
            f"{time.perf_counter() - t0:.2f} s")
        kinf = inf.clone()
        kinf[::64] = True
        plan, chunks, cases, results[f"buckets_{kind}"] = cases_2e21(
            kind, G, xs, ys, kinf, sc, rates)
        for name, (args, kern, plain) in cases.items():
            label = (f"{name} 2^21 plan, {LEAF_WINDOWS_2E21} of "
                     f"{plan.nwin} windows, the plain version in "
                     f"{plan.C // LEAF_SEGMENT} segments of {LEAF_SEGMENT} "
                     f"steps a chain seeded by the kernel's rows"
                     if name == "leaf_prefix" else f"{name} 2^21 plan")
            results[f"{name}_{kind}"] = compare(kind, label, args, kern,
                                                plain, rates, work=name)
        del cases, kinf
        torch.cuda.empty_cache()
        plan = M.MSM(G, N_2E21, 16)
        plan(xs, ys, inf, sc)                       # the warm-up
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out, ms = wall_ms(lambda: plan(xs, ys, inf, sc))
        peak = torch.cuda.max_memory_allocated(device)
        cap = M.memory_cap(
            torch.cuda.get_device_properties(device).total_memory)
        assert points_to_host(G, out)[0] == want, f"MSM {kind} 2^21 != oracle"
        log(f"[msm {kind} 2^21] n={N_2E21} oracle ok: kernel path {ms:.1f} "
            f"ms ({N_2E21 / ms * 1e3:.0f} points/s), {len(chunks)} window "
            f"chunk(s) {chunks}, peak memory {gb(peak)} ({gb(base)} before "
            f"the call; the cap a chunk {gb(cap)}, "
            f"{gb(M.window_bytes(plan.n_pad, G.F.L))} a window)")
        steps = msm_breakdown(plan, xs, ys, inf, sc)
        log(f"[msm {kind} 2^21] steps (ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in steps.items()))
        nchunks[kind] = len(chunks)
        del xs, ys, inf, sc, out
        torch.cuda.empty_cache()

    # the quotient call of each prove, timed with a synchronize on each
    # side: its compute_h phase less it is limb_planes' host work and
    # upload
    calls = []
    compute_h = groth16.compute_h

    def timed(domain, a, b, c, **kw):
        sync()
        t0 = time.perf_counter()
        out = compute_h(domain, a, b, c, **kw)
        sync()
        calls.append(time.perf_counter() - t0)
        return out

    groth16.compute_h = timed
    _cuda.reset_launches()
    reset_plain()
    reset_mont()
    try:
        res = dev_e2e_2e20.run(E2E_LOG, "bn254", device, log=log)
    finally:
        groth16.compute_h = compute_h
    launches = {f"{k}_{kind}": _cuda.launches[f"{k}_{kind}"]
                for k in _cuda.KERNELS for kind in BN254_KINDS}
    launches.update(ntt_part(_cuda.launches))
    # a prove's MSMs: four over G1, one over G2; the leaf, lane offsets,
    # bucket step and weighted sum launch once a window chunk, the fold
    # once an MSM; its
    # quotient seven transforms of 2^20 and one pointwise step
    n = len(res["proves"])
    want = {f"{k}_{kind}": (n * (4 if kind == "g1" else 1)
                            * (1 if k == "horner_fold" else nchunks[kind])
                            if k in _cuda.WINDOW_KERNELS else 0)
            for k in _cuda.KERNELS for kind in BN254_KINDS}
    # its setup: five batches of N_2E21 columns, SETUP_COLUMNS a launch
    want.update(setup_launches(res["pk"].curve, "groth16", N_2E21))
    SETUP_LAUNCHES["2e20"] = {k: launches[k] for k in want
                              if k.startswith("fixed_base_")}
    want.update(dict.fromkeys(ntt_part(_cuda.launches), 0))
    want.update({k: n * v for k, v in ntt_launches(
        res["pk"].curve, "groth16", 1 << E2E_LOG).items()})
    assert launches == want, (launches, want)
    assert {k for k, v in _cuda.launches.items() if v} <= set(want), \
        _cuda.launches
    assert not plain_runs(), plain_runs()
    assert res["pk"].n_pad == N_2E21, res["pk"].n_pad
    log(f"[groth16 sq2e{E2E_LOG}] launches during the {n} proves: "
        f"{launches}; no plain version on the card")
    check_no_mont(f"[groth16 sq2e{E2E_LOG}] the {n} proves' quotients:")
    assert len(calls) == n, calls
    for (label, (_, phases)), call in zip(res["proves"].items(), calls):
        log(f"[groth16 sq2e{E2E_LOG}] compute_h {label} "
            f"{phases['compute_h']:.4f} s: the quotient call {call:.4f} s "
            f"(synchronised), the rest {phases['compute_h'] - call:.4f} s "
            f"(limb_planes: the solver's limbs padded on the host and "
            f"uploaded)")
    return results, launches, {f"{k}_2e20": v for k, v in ntt.items()}


ADD_TYPE = re.compile(r"^(IADD3|IADD|IMAD\.X|IMAD\.IADD|IADD32I|LEA)")
MUL_TYPE = re.compile(r"^IMAD(\.WIDE|\.HI|\.U32|$)")


def sass_report(out_dir=None):
    """Disassemble both libraries with cuobjdump, count the multiply and
    add instructions of each function, and keep the microbenchmark's
    listing in ``out_dir`` when one is given.  The BN254 montmul chain's
    loop body (the instructions between a backward branch and its label) is
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
            if "chain_montmul_kernelI7BN254Fp" in fn:   # BN254's product
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
    log(f"[env] host CPU cores: {os.cpu_count()}")
    t0 = time.perf_counter()
    # phase 12's host side runs while nvcc builds the kernels (its
    # BLS24-315 inner setup waits for them), and its outer keys' setups,
    # which need none, one after the other, beside phases 2-11
    pool = concurrent.futures.ThreadPoolExecutor(1)
    build = pool.submit(_cuda.build_all)
    prepared = prepare_recursion(device, build.result)
    log(f"[phase] recursion, host side, during the nvcc builds "
        f"{time.perf_counter() - t0:.1f} s")
    build.result()
    log(f"[env] nvcc builds, side by side, {time.perf_counter() - t0:.1f} s")
    watch_ntt()
    watch_mont()
    outer_keys = {inner: pool.submit(recursion_outer_setup, device,
                                     prepared, inner)
                  for inner in RECURSION}
    pool.shutdown(wait=False)
    for name, info in _cuda.build_info.items():
        log(f"[env] nvcc {name} {info['seconds']:.1f} s: {info['command']}")
    for lib in ("msm", "msm_g1_bls24315", "msm_g2_bls24315", "ntt"):
        lines = ptxas_summary(_cuda.build_info[lib]["ptxas"])
        for line in lines + ntt_pass_smem(lines):
            log(f"[ptxas] {line}")
    for a in args:
        if a.split("=")[0] == "--sass":
            sass_report(a.partition("=")[2] or None)

    t0 = time.perf_counter()
    micro, rates, peak, lat = phase_microbench(device)
    log(f"[phase] microbenchmark {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    msm_rates = (peak, rates["mad_wide_u32"]["ops_per_s"],
                 lat["montmul_bn254"], lat["montmul_bls24315"])
    kern = phase_kernels(device, msm_rates)
    kern_fixed_base = phase_fixed_base_kernels(device, msm_rates)
    kern_ntt = phase_ntt_kernels(device, msm_rates)
    log(f"[phase] kernels vs plain {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_msm(device)
    log(f"[phase] msm oracle {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_groth16, groth16_served = phase_groth16(
        device, profile="--profile" in args, trace="--trace" in args)
    log(f"[phase] groth16 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_plonk, plonk_served = phase_plonk(device, trace="--trace" in args)
    log(f"[phase] plonk {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern_rollup = phase_rollup_kernels(device, msm_rates)
    l_rollup = phase_rollup(device)
    log(f"[phase] rollup {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern_bls24, kern_bls24_plonk = phase_bls24_kernels(device, msm_rates)
    log(f"[phase] BLS24-315 kernels vs plain {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_curves, curves_served = phase_curves_groth16(device)
    log(f"[phase] groth16 other curves {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_curves_plonk = phase_curves_plonk(device)
    log(f"[phase] plonk other curves {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_serial = phase_serialization(device, served_keys(
        groth16_served, plonk_served, curves_served))
    log(f"[phase] serialization {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    l_recursion = phase_recursion(device, prepared, outer_keys)
    log(f"[phase] recursion {time.perf_counter() - t0:.1f} s")
    log(f"[recursion] host memory after phase 12: {host_memory()}")
    # phase 13's ranks need the card's memory: the blocks that this
    # process's allocator keeps from the earlier phases (phase 3's plain
    # 2^18-column G2 scan alone about 20 GB) go back to the card
    reserved = torch.cuda.memory_reserved(device)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sharded] the main process's cached card memory: "
        f"{reserved / 1e9:.2f} GB reserved, "
        f"{torch.cuda.memory_reserved(device) / 1e9:.2f} GB after emptying")
    t0 = time.perf_counter()
    l_sharded, l_sharded_msm = phase_sharded(device, groth16_served)
    log(f"[phase] sharded {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kern_ntt_paths = phase_ntt_path_domains(device, msm_rates)
    log(f"[phase] quotient kernels at the paths' domains "
        f"{time.perf_counter() - t0:.1f} s")
    # the 2^20 path needs the card's memory: the earlier phases' keys go
    del groth16_served, plonk_served, curves_served, prepared, outer_keys
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kern_2e20, l_2e20, kern_ntt_2e20 = phase_2e20(device, msm_rates)
    log(f"[phase] 2^20 groth16 {time.perf_counter() - t0:.1f} s")
    check_ntt_held()
    log(f"[phase] total {time.perf_counter() - t_all:.1f} s")

    from gnark_tpu_torch.ops import msm as M
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "gnark_tpu")]
    assert not bad, f"loaded: {bad}"
    assert not plain_runs(), plain_runs()

    entries = []
    for key, r in kern.items():
        name = key.rsplit("_", 1)[0]
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/msm_kernels.cu",
            "replaces": REPLACES[name],
            "launches": (l_groth16[key] + l_plonk[key] + l_rollup[key]
                         + l_serial.get(key, 0) + l_sharded.get(key, 0)
                         + l_2e20[key]),
            "launches_groth16": l_groth16[key],
            "launches_plonk": l_plonk[key],
            "launches_rollup": l_rollup[key],
            "launches_serialization": l_serial.get(key, 0),
            "launches_sharded": (l_sharded.get(key, 0)
                                 + l_sharded_msm.get(key, 0)),
            "launches_sharded_prove": l_sharded.get(key, 0),
            "launches_sharded_msm": l_sharded_msm.get(key, 0),
            "launches_2e20": l_2e20[key], **r})
        if key in kern_rollup:
            entries[-1]["at_rollup_plan"] = {
                k: kern_rollup[key][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    for key, r in kern_2e20.items():
        # the 2^21 plan's rows: launched on the 2^20 path alone
        entries.append({
            "name": f"{key}_2e21", "route": "cuda",
            "source": "gnark_tpu_torch/csrc/msm_kernels.cu",
            "replaces": REPLACES[key.rsplit("_", 1)[0]],
            "plan": dict(zip(("c", "windows", "buckets", "R", "C"),
                             PLAN_2E21)),
            "launches": l_2e20[key], "launches_2e20": l_2e20[key], **r})
    for key, r in kern_bls24.items():
        name, kind = key.split("_g")[0], "g" + key.split("_g")[1]
        entries.append({
            "name": key, "route": "cuda",
            "source": f"gnark_tpu_torch/csrc/msm_{kind}.cu",
            "replaces": REPLACES[name],
            "launches": (l_curves.get(key, 0) + l_curves_plonk.get(key, 0)
                         + l_serial.get(key, 0) + l_recursion.get(key, 0)),
            "launches_groth16": l_curves.get(key, 0),
            "launches_plonk": l_curves_plonk.get(key, 0),
            "launches_serialization": l_serial.get(key, 0),
            "launches_recursion": l_recursion.get(key, 0), **r})
        if key in kern_bls24_plonk:
            entries[-1]["at_plonk_plan"] = {
                k: kern_bls24_plonk[key][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    # the quotient's kernels: launched on every path that proves
    paths = {"groth16": l_groth16, "plonk": l_plonk, "rollup": l_rollup,
             "curves_groth16": l_curves, "curves_plonk": l_curves_plonk,
             "serialization": l_serial, "recursion": l_recursion,
             "sharded_prove": l_sharded, "2e20": l_2e20}
    for key, r in {**kern_ntt, **kern_ntt_paths}.items():
        # the rows at phase 3's sizes and at other sizes (<kernel>_<kind>
        # _2e<k>): the kernel's launches on every path
        base = key.rsplit("_2e", 1)[0]
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/ntt_kernels.cu",
            "replaces": NTT_REPLACES[base.split("_fr_")[0]],
            "launches": sum(l.get(base, 0) for l in paths.values()),
            **{f"launches_{p}": l.get(base, 0) for p, l in paths.items()},
            **r})
    for key, r in kern_ntt_2e20.items():
        # the rows at 2^20: launched on the 2^20 path alone
        base = key.removesuffix("_2e20")
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/ntt_kernels.cu",
            "replaces": NTT_REPLACES[base.split("_fr_")[0]],
            "launches": l_2e20[base], "launches_2e20": l_2e20[base], **r})
    for key, r in kern_fixed_base.items():
        # launched in the setups of every path that sets up on the card;
        # the rows at the 2^20 key's slice on the 2^20 path alone
        base = key.removesuffix("_2e21")
        kind = base.removeprefix("fixed_base_")
        paths = ("2e20",) if key != base else SETUP_PATHS
        counts = {p: SETUP_LAUNCHES[p].get(base, 0) for p in paths}
        entries.append({
            "name": key, "route": "cuda",
            "source": ("gnark_tpu_torch/csrc/msm_kernels.cu"
                       if kind in BN254_KINDS else
                       f"gnark_tpu_torch/csrc/msm_{kind}.cu"),
            "replaces": FIXED_BASE_REPLACES,
            "launches": sum(counts.values()),
            **{f"launches_{p}": v for p, v in counts.items()}, **r})
    for key, r in micro.items():
        entries.append({
            "name": key, "route": "cuda",
            "source": "gnark_tpu_torch/csrc/microbench.cu",
            "replaces": MICROBENCH_REPLACES, **r})
    assert all(e["launches"] > 0 for e in entries), entries
    # a least time that a kernel beats counts more work than its function
    # needs
    log(f"[setup] fixed-base launches in each path's setups: "
        f"{SETUP_LAUNCHES}")
    beaten = [e["name"] for e in entries if e["ms"] < e["bound_ms"]]
    assert not beaten, f"kernels faster than their bounds: {beaten}"
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
