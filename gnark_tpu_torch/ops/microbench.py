"""Integer-multiply ceiling microbenchmark (counterpart of
scripts/dev_vpu_microbench.py::make, the TPU's vector-unit microbenchmark).

    python -m gnark_tpu_torch.ops.microbench

Per element, ``steps`` steps on each of four independent chains against a
second operand, then the sum of the four accumulators.  The TPU's four ops
(``mul_u32``, ``mul16_u32``, ``add_u32``, ``fma_f32``) compute the same
values here; ``mad_wide_u32``, ``mad_lo_hi_u32`` and ``montmul_bn254`` are
the multiply-adds and the Montgomery product of csrc/field.cuh, whose
rate bounds every MSM kernel.  The kernel is csrc/microbench.cu.

``chain`` launches the kernel on CUDA tensors and runs ``chain_plain`` on
CPU tensors; any other device raises, and there is no fallback from the
kernel.  Integer ops agree with the plain version bit for bit.  ``fma_f32``
does not: the kernel's fused multiply-add rounds once a step, torch's
``a * y + y`` twice, so with operands in [0, 1) (where the chain settles at
y / (1 - y)) the results differ by a few units in the last place a step;
FMA_RTOL bounds the accumulated difference.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops.limbs import field_ops

OPS = _cuda.MICROBENCH_OPS
# instructions a step issues: what "operations per second" counts
OPS_PER_STEP = {"mul_u32": 1, "mul16_u32": 1, "add_u32": 1, "fma_f32": 1,
                "mad_wide_u32": 1, "mad_lo_hi_u32": 2, "montmul_bn254": 1}
MULS_PER_MONTMUL = 2 * 8 * 8 + 8     # field.cuh: 2N^2 + N at N = 8
STEPS = 128                          # microbench.cu's STEPS
MONTMUL_STEPS = 32
# 16 threads' worth of elements for each of the 2048 threads an SM holds
N_U32 = 132 * 2048 * 16
N_MONTMUL = 132 * 2048
FMA_RTOL = 1e-4
_M32 = 0xFFFFFFFF


def chain_plain(op, x, y, steps=None):
    """The chains in plain PyTorch: int64 tensors masked to 32 bits
    (mad_wide_u32 wraps at 64), float32 for fma_f32, FieldOps for
    montmul_bn254."""
    if steps is None:
        steps = MONTMUL_STEPS if op == "montmul_bn254" else STEPS
    if op == "montmul_bn254":
        F = field_ops(BN254.fp)
        accs = [x]
        for _ in range(3):
            accs.append(F.double(accs[-1]))
        for _ in range(steps):
            accs = [F.mul(a, y) for a in accs]
        return F.add(F.add(F.add(accs[0], accs[1]), accs[2]), accs[3])
    if op == "fma_f32":
        accs = [x + float(k) for k in range(4)]
        for _ in range(steps):
            accs = [a * y + y for a in accs]
        return accs[0] + accs[1] + accs[2] + accs[3]
    x, y = x & _M32, y & _M32
    accs = [(x + k) & _M32 for k in range(4)]
    if op == "mad_wide_u32":
        # chain k's multiplicand is the low half of chain k + 1, the last
        # chain's that of the first, already updated; int64 wraps at 2^64
        for _ in range(steps):
            for k in range(4):
                accs[k] = (accs[(k + 1) % 4] & _M32) * y + accs[k]
        return accs[0] + accs[1] + accs[2] + accs[3]
    if op == "mad_lo_hi_u32":
        his = [torch.zeros_like(x) for _ in range(4)]
        y_lo, y_hi = y & 0xFFFF, y >> 16
        for _ in range(steps):
            for k in range(4):
                lo, hi = accs[k], his[k]
                # lo * y < 2^64 does not fit int64's 63 bits: split y
                p0 = lo * y_lo                      # < 2^48
                p1 = lo * y_hi                      # < 2^48
                low = (p0 + ((p1 & 0xFFFF) << 16))  # < 2^49
                accs[k] = (low + hi) & _M32
                his[k] = ((p1 >> 16) + (low >> 32) + lo) & _M32
        return sum(accs[k] + his[k] for k in range(4)) & _M32
    y16 = y & 0xFFFF
    for _ in range(steps):
        if op == "mul_u32":
            accs = [_mul32(a, y) for a in accs]
        elif op == "mul16_u32":
            accs = [(a & 0xFFFF) * y16 for a in accs]
        elif op == "add_u32":
            accs = [(a + y) & _M32 for a in accs]
        else:
            raise ValueError(f"unknown microbenchmark op {op!r}")
    return (accs[0] + accs[1] + accs[2] + accs[3]) & _M32


def _mul32(a, y):
    """a * y mod 2^32 for values below 2^32 in int64 (the full product
    would pass 2^63)."""
    return ((a & 0xFFFF) * y + (((a >> 16) * y & 0xFFFF) << 16)) & _M32


def chain(op, x, y, steps=None):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if op not in OPS:
        raise ValueError(f"unknown microbenchmark op {op!r}")
    if x.device.type == "cuda":
        if op == "montmul_bn254" and steps is None:
            steps = MONTMUL_STEPS
        return _cuda.microbench(op, x, y, steps)
    if x.device.type == "cpu":
        return chain_plain(op, x, y, steps)
    raise ValueError(f"microbench: no kernel or plain version for {x.device}")


def inputs(op, n, device, seed=0):
    """Seeded operands for ``op``: 16-bit values as the TPU benchmark draws
    them (full 32-bit for the multiply-adds), floats in [0, 1), or field
    elements in Montgomery form."""
    rng = np.random.default_rng(seed)
    if op == "fma_f32":
        x, y = (torch.from_numpy(rng.random(n, np.float32)) for _ in "xy")
    elif op == "montmul_bn254":
        p = BN254.fp.modulus
        # limb planes of values below p: the top limb below p's top limb
        top = (p >> 240) & 0xFFFF
        x, y = (torch.from_numpy(np.concatenate(
            [rng.integers(0, 1 << 16, (15, n)), rng.integers(0, top, (1, n))]
        ).astype(np.int64)) for _ in "xy")
    else:
        hi = 1 << (32 if op.startswith("mad_") else 16)
        x, y = (torch.from_numpy(rng.integers(0, hi, n, dtype=np.int64))
                for _ in "xy")
    return x.to(device), y.to(device)


def time_op(op, x, y, reps=10):
    """Mean milliseconds of one launch, by CUDA events over ``reps``
    launches after a warm-up."""
    chain(op, x, y)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        chain(op, x, y)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(device="cuda", log=print):
    """Time every op on the card; -> {op: {ms, ops_per_s, n, steps}}.
    One line per op, with the card's name and power limit on it."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the microbenchmark measures a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {}
    for op in OPS:
        montmul = op == "montmul_bn254"
        n = N_MONTMUL if montmul else N_U32
        steps = MONTMUL_STEPS if montmul else _cuda.microbench_steps()
        x, y = inputs(op, n, device)
        ms = time_op(op, x, y)
        rate = n * 4 * steps * OPS_PER_STEP[op] / (ms * 1e-3)
        out[op] = {"ms": ms, "ops_per_s": rate, "n": n, "steps": steps}
        extra = (f" ({rate * MULS_PER_MONTMUL:.4g} 32-bit multiplies/s)"
                 if montmul else "")
        log(f"[microbench] {op}: {rate:.4g} operations/s{extra}, "
            f"{ms:.4f} ms a launch, n={n}, 4 chains x {steps} steps "
            f"[{card}]")
    return out


if __name__ == "__main__":
    run()
