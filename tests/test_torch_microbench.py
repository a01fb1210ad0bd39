"""gnark_tpu_torch.ops.microbench: the plain versions of the
integer-multiply microbenchmark's chains against numpy and Python ints.

The kernel (csrc/microbench.cu) runs on a card only; tests/test_torch_cuda.py
holds it against these plain versions there.  Here, at a small shape and a
few steps: every integer op bit for bit against an independent reference
(numpy uint32/uint64 arithmetic, Python ints for the field product), and
``fma_f32`` against a float64 evaluation of the same recurrence.  The
wrapper raises on what it cannot launch instead of computing it another
way.

Tolerance: 0 for the integer ops.  ``fma_f32`` at 1e-5 relative: float32
rounds twice a step here (``a * y + y``), the float64 reference hardly at
all; with operands in [0, 1) the recurrence contracts, so the rounding of
each step (6e-8) does not build up over the steps.
"""

import numpy as np
import pytest
import torch

from gnark_tpu_torch.curves import BLS24_315, BN254
from gnark_tpu_torch.ops import _cuda
from gnark_tpu_torch.ops import microbench as MB
from gnark_tpu_torch.ops.limbs import field_ops

N, STEPS = 257, 9


def _reference(op, x, y, steps):
    """numpy, in unsigned types that wrap where the instruction wraps."""
    x, y = x.astype(np.uint64), y.astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    accs = [(x + np.uint64(k)) & m32 for k in range(4)]
    if op == "mad_wide_u32":
        with np.errstate(over="ignore"):
            for _ in range(steps):
                for k in range(4):
                    accs[k] = (accs[(k + 1) % 4] & m32) * y + accs[k]
            return (accs[0] + accs[1] + accs[2] + accs[3]).astype(np.int64)
    if op == "mad_lo_hi_u32":
        his = [np.zeros_like(x) for _ in range(4)]
        with np.errstate(over="ignore"):
            for _ in range(steps):
                for k in range(4):
                    prod = accs[k] * y                  # exact below 2^64
                    accs[k], his[k] = ((prod + his[k]) & m32,
                                       ((prod >> np.uint64(32)) + accs[k])
                                       & m32)
        return (sum(accs) + sum(his)).astype(np.uint64) & m32
    for _ in range(steps):
        if op == "mul_u32":
            accs = [(a * y) & m32 for a in accs]        # exact below 2^64
        elif op == "mul16_u32":
            accs = [(a & np.uint64(0xFFFF)) * (y & np.uint64(0xFFFF))
                    for a in accs]
        else:
            accs = [(a + y) & m32 for a in accs]
    return sum(accs) & m32


@pytest.mark.parametrize("op", _cuda.MICROBENCH_U32_OPS)
def test_plain_integer_chain_matches_numpy(op):
    x, y = MB.inputs(op, N, "cpu", seed=5)
    if op.startswith("mad_"):
        assert int(x.max()) > 1 << 31           # full 32-bit operands
    got = MB.chain(op, x, y, steps=STEPS)
    want = _reference(op, x.numpy(), y.numpy(), STEPS)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_plain_integer_chain_wraps_at_the_extremes():
    top = torch.full((4,), 0xFFFFFFFF, dtype=torch.int64)
    for op in _cuda.MICROBENCH_U32_OPS:
        got = MB.chain(op, top, top, steps=3)
        want = _reference(op, top.numpy(), top.numpy(), 3)
        assert np.array_equal(got.numpy(), want.astype(np.int64)), op


def test_plain_fma_chain_matches_float64():
    x, y = MB.inputs("fma_f32", N, "cpu", seed=5)
    got = MB.chain("fma_f32", x, y, steps=STEPS)
    accs = [x.double() + k for k in range(4)]
    for _ in range(STEPS):
        accs = [a * y.double() + y.double() for a in accs]
    want = accs[0] + accs[1] + accs[2] + accs[3]
    assert got.dtype == torch.float32
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=0)


def test_plain_montmul_chain_matches_python_ints():
    x, y = MB.inputs("montmul_bn254", 6, "cpu", seed=5)
    F, p = field_ops(BN254.fp), BN254.fp.modulus
    xs, ys = F.unpack(x), F.unpack(y)
    assert all(v < p for v in xs + ys)
    got = F.unpack(MB.chain("montmul_bn254", x, y, steps=3))
    want = [sum(xv << k for k in range(4)) * pow(yv, 3, p) % p
            for xv, yv in zip(xs, ys)]
    assert got == want


def test_plain_montmul_one_chain_matches_python_ints():
    """One chain (the latency measurement): x * y^steps, in Montgomery
    form, with no sum over chains."""
    x, y = MB.inputs("montmul_bn254", 6, "cpu", seed=6)
    F, p = field_ops(BN254.fp), BN254.fp.modulus
    xs, ys = F.unpack(x), F.unpack(y)
    got = F.unpack(MB.chain("montmul_bn254", x, y, steps=4, chains=1))
    assert got == [xv * pow(yv, 4, p) % p for xv, yv in zip(xs, ys)]


def test_plain_bls24315_montmul_chains_match_python_ints():
    """The 10-word product's chains (montmul_bls24315, R = 2^320): four
    chains summed, and one chain (its latency measurement), against
    x * y^steps in Python ints, operands below p."""
    x, y = MB.inputs("montmul_bls24315", 6, "cpu", seed=7)
    F, p = field_ops(BLS24_315.fp), BLS24_315.fp.modulus
    assert x.shape == (20, 6)
    xs, ys = F.unpack(x), F.unpack(y)
    assert all(v < p for v in xs + ys)
    got = F.unpack(MB.chain("montmul_bls24315", x, y, steps=3))
    assert got == [sum(xv << k for k in range(4)) * pow(yv, 3, p) % p
                   for xv, yv in zip(xs, ys)]
    got = F.unpack(MB.chain("montmul_bls24315", x, y, steps=4, chains=1))
    assert got == [xv * pow(yv, 4, p) % p for xv, yv in zip(xs, ys)]
    assert MB.MONTMUL_FIELDS["montmul_bls24315"][1] == 2 * 10 * 10 + 10


def test_default_steps_are_the_kernels():
    x, y = MB.inputs("add_u32", 3, "cpu")
    got = MB.chain("add_u32", x, y)
    assert got.tolist() == [(4 * xv + 6 + 4 * MB.STEPS * yv) & 0xFFFFFFFF
                            for xv, yv in zip(x.tolist(), y.tolist())]
    assert MB.MULS_PER_MONTMUL == 136
    assert MB.N_U32 >= 132 * 2048


def test_wrapper_raises_instead_of_falling_back():
    x, y = MB.inputs("mul_u32", 8, "cpu")
    # a CUDA launch needs CUDA tensors and a CUDA runtime
    with pytest.raises(ValueError):
        _cuda.microbench("mul_u32", x, y)
    with pytest.raises(ValueError):
        _cuda.microbench("fma_f32", x, y)           # wrong dtype as well
    with pytest.raises(ValueError):
        _cuda.microbench("mul_u64", x, y)
    with pytest.raises(ValueError):
        _cuda.microbench("mul_u32", x, y, chains=1)
    with pytest.raises(ValueError):
        MB.chain("mul_u64", x, y)
    # a device with no kernel and no plain version
    with pytest.raises(ValueError):
        MB.chain("mul_u32", x.to("meta"), y.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MB.run()
        with pytest.raises(RuntimeError):
            _cuda.build_all()
    assert not any(v for k, v in _cuda.launches.items()
                   if k.startswith("microbench_"))
