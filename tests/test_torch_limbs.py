"""gnark_tpu_torch.ops.limbs / towers (plain PyTorch field arithmetic)
against Python-int arithmetic and gnark_tpu.fields.np_field.

Tolerance: none.  Field elements compare exactly, as Python ints after
unpacking or as raw canonical limbs.
"""

import random

import numpy as np
import pytest
import torch

from gnark_tpu.curves import BN254
from gnark_tpu.fields import FieldSpec
from gnark_tpu.fields.np_field import np_field
from gnark_tpu_torch.ops.limbs import FieldOps, field_ops
from gnark_tpu_torch.ops.towers import fp2_ops

torch.set_num_threads(1)

# the 64-bit Goldilocks prime needs a slack limb (fields/spec.py L)
GOLDILOCKS = FieldSpec(name="gl_torch_slack", modulus=(1 << 64) - (1 << 32) + 1,
                       multiplicative_generator=7)
SPECS = {"bn254_fp": BN254.fp, "bn254_fr": BN254.fr, "goldilocks": GOLDILOCKS}


def _operands(p, seed):
    """Edge values (0, 1, p-1 and neighbours of R) and seeded randoms."""
    rnd = random.Random(seed)
    edges = [0, 1, p - 1, p - 2, 2, (1 << (p.bit_length() - 1)) % p]
    xs = edges + [rnd.randrange(p) for _ in range(40)]
    ys = list(reversed(edges)) + [rnd.randrange(p) for _ in range(40)]
    return xs, ys


OPS = {
    "add": (lambda F, a, b: F.add(a, b), lambda x, y, p: (x + y) % p),
    "sub": (lambda F, a, b: F.sub(a, b), lambda x, y, p: (x - y) % p),
    "neg": (lambda F, a, b: F.neg(a), lambda x, y, p: (-x) % p),
    "double": (lambda F, a, b: F.double(a), lambda x, y, p: 2 * x % p),
    "mul": (lambda F, a, b: F.mul(a, b), lambda x, y, p: x * y % p),
    "sqr": (lambda F, a, b: F.sqr(a), lambda x, y, p: x * x % p),
    "mul_small_9": (lambda F, a, b: F.mul_small(a, 9), lambda x, y, p: 9 * x % p),
    "mul_small_4095": (lambda F, a, b: F.mul_small(a, 4095),
                       lambda x, y, p: 4095 * x % p),
    "batch_inv": (lambda F, a, b: F.batch_inv(a),
                  lambda x, y, p: pow(x, -1, p) if x else 0),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("field", sorted(SPECS))
def test_field_op_matches_python_ints(field, op):
    spec = SPECS[field]
    F = field_ops(spec)
    p = spec.modulus
    xs, ys = _operands(p, seed=len(op) + len(field))
    fn, ref = OPS[op]
    a, b = F.pack(xs, "cpu"), F.pack(ys, "cpu")
    out = fn(F, a, b)
    assert out.dtype == torch.int64 and out.shape == a.shape
    assert int(out.min()) >= 0 and int(out.max()) <= 0xFFFF   # canonical
    assert F.unpack(out) == [ref(x, y, p) for x, y in zip(xs, ys)]


def test_inv_maps_zero_to_zero_and_batch_inv_keeps_zeros():
    F = field_ops(BN254.fr)
    p = BN254.fr.modulus
    vals = [0, 1, p - 1, 5, 0, 12345, 0]
    a = F.pack(vals, "cpu")
    want = [pow(v, -1, p) if v else 0 for v in vals]
    assert F.unpack(F.inv(a)) == want
    assert F.unpack(F.batch_inv(a)) == want


def test_mont_conversions():
    F = field_ops(BN254.fp)
    spec = BN254.fp
    xs, _ = _operands(spec.modulus, seed=3)
    regular = torch.from_numpy(spec.to_limbs(xs, montgomery=False)
                               .astype(np.int64))
    mont = F.to_mont(regular)
    assert torch.equal(mont, F.pack(xs, "cpu"))
    assert torch.equal(F.from_mont(mont), regular)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mmul"])
def test_raw_limbs_match_np_field(op):
    """Same Montgomery limb planes in, same canonical limbs out as the
    numpy field of the witness solver."""
    spec = BN254.fr
    F, N = field_ops(spec), np_field(spec)
    xs, ys = _operands(spec.modulus, seed=11)
    a, b = N.pack(xs, mont=True), N.pack(ys, mont=True)
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    got = {"add": F.add, "sub": F.sub, "mmul": F.mul,
           "neg": lambda u, v: F.neg(u)}[op](ta, tb)
    want = {"add": N.add, "sub": N.sub, "mmul": N.mmul,
            "neg": lambda u, v: N.neg(u)}[op](a, b)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_field_ops_broadcast_and_batch_shapes():
    F = field_ops(BN254.fp)
    p = BN254.fp.modulus
    xs, _ = _operands(p, seed=5)
    a = F.pack(xs[:24], "cpu").reshape(F.L, 4, 6)
    k = F.pack([7], "cpu").reshape(F.L, 1, 1)
    out = F.mul(a, k)
    assert out.shape == (F.L, 4, 6)
    assert F.unpack(out.reshape(F.L, -1)) == [x * 7 % p for x in xs[:24]]


FP2_OPS = {
    "add": (lambda F, a, b: F.add(a, b), lambda H, x, y: H.add(x, y)),
    "sub": (lambda F, a, b: F.sub(a, b), lambda H, x, y: H.sub(x, y)),
    "neg": (lambda F, a, b: F.neg(a), lambda H, x, y: H.neg(x)),
    "mul": (lambda F, a, b: F.mul(a, b), lambda H, x, y: H.mul(x, y)),
    "sqr": (lambda F, a, b: F.sqr(a), lambda H, x, y: H.mul(x, x)),
    "inv": (lambda F, a, b: F.inv(a),
            lambda H, x, y: H.inv(x) if x != (0, 0) else (0, 0)),
}


@pytest.mark.parametrize("op", sorted(FP2_OPS))
def test_fp2_op_matches_host_fp2(op):
    F = fp2_ops(BN254.fp, BN254.fp2_beta)
    H = BN254.host_g2.F
    p = BN254.fp.modulus
    rnd = random.Random(17)
    xs = [(0, 0), (1, 0), (0, 1), (p - 1, p - 1)] + [
        (rnd.randrange(p), rnd.randrange(p)) for _ in range(20)]
    ys = [(p - 1, 1), (0, 0), (5, p - 1), (1, 0)] + [
        (rnd.randrange(p), rnd.randrange(p)) for _ in range(20)]
    fn, ref = FP2_OPS[op]
    out = fn(F, F.pack(xs, "cpu"), F.pack(ys, "cpu"))
    assert out.shape == (2 * F.base.L, len(xs))
    assert F.unpack(out) == [ref(H, x, y) for x, y in zip(xs, ys)]


def test_field_ops_hold_no_device():
    """Constants are built per device on first use; no default device."""
    F = FieldOps(BN254.fp)
    assert F._consts == {}
    F.add(F.pack([1], "cpu"), F.pack([2], "cpu"))
    assert list(F._consts) == [torch.device("cpu")]
