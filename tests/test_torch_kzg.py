"""gnark_tpu_torch.backend.kzg against gnark_tpu.backend.kzg.

With a fixed tau, the port's SRS (fixed-base on the device, here the CPU,
and through the native core with host=True) equals the JAX package's
host SRS point for point; commitments, openings and folded batch openings
of seeded polynomials equal its host results and verify under both
packages' verifiers; the degree check raises; a wrong value and a wrong
proof are rejected.

Tolerance: none; points and values compare exactly as Python ints.
"""

import numpy as np
import pytest
import torch

from gnark_tpu.backend import kzg as jk
from gnark_tpu.curves import BN254 as JBN254
from gnark_tpu_torch.backend import kzg as tk
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.ops.limbs import ints_to_limbs

torch.set_num_threads(1)

Q = BN254.fr.modulus
TAU = 0x1234567890ABCDEF1234567890ABCDEF
SIZE = 12


def _poly(seed, k):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(k)]


@pytest.fixture(scope="module")
def srs():
    jsrs = jk.new_srs(JBN254, SIZE, tau=TAU, host=True)
    dsrs = tk.new_srs(BN254, SIZE, tau=TAU, device="cpu")
    hsrs = tk.new_srs(BN254, SIZE, tau=TAU, host=True)
    return jsrs, dsrs, hsrs


def test_srs_equals_jax_host_srs(srs):
    jsrs, dsrs, hsrs = srs
    for s in (dsrs, hsrs):
        assert s.g1 == jsrs.g1
        assert (s.g2_gen, s.g2_tau) == (jsrs.g2_gen, jsrs.g2_tau)
    assert dsrs.g1[0] == BN254.g1_gen
    assert dsrs.device == torch.device("cpu") and hsrs.device is None
    # the planes that the commit reads are the points' own
    F = tk._Groups(BN254).g1.F
    x, y, inf = dsrs.device_g1
    assert list(zip(F.unpack(x), F.unpack(y))) == dsrs.g1 and not inf.any()
    with pytest.raises(ValueError):
        hsrs.device_g1


def test_srs_draws_tau_like_jax():
    import random
    a = jk.new_srs(JBN254, 3, rng=random.Random(5), host=True)
    b = tk.new_srs(BN254, 3, rng=random.Random(5), host=True)
    assert a.g1 == b.g1 and a.g2_tau == b.g2_tau


def test_new_srs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tk.new_srs(BN254, 3, tau=TAU)


@pytest.mark.parametrize("k", [1, 5, SIZE])
def test_commit_equals_jax_host_commit(srs, k):
    jsrs, dsrs, hsrs = srs
    coeffs = _poly(k, k)
    want = jk.commit(jsrs, coeffs, host=True)
    assert tk.commit(dsrs, coeffs) == want
    assert tk.commit(hsrs, coeffs, host=True) == want
    # trailing zeros do not count against the degree bound
    assert tk.commit(hsrs, coeffs + [0] * 4, host=True) == want


def test_commit_of_zero_is_the_identity(srs):
    jsrs, dsrs, hsrs = srs
    assert jk.commit(jsrs, [0, 0], host=True) is None
    assert tk.commit(dsrs, [0, 0]) is None
    assert tk.commit(hsrs, [0, 0], host=True) is None
    assert tk.commit(dsrs, []) is None


def test_degree_check_raises(srs):
    _, dsrs, hsrs = srs
    too_long = _poly(3, SIZE + 1)
    with pytest.raises(ValueError, match="exceeds SRS size"):
        tk.commit(dsrs, too_long)
    with pytest.raises(ValueError, match="exceeds SRS size"):
        tk.commit(hsrs, too_long, host=True)
    planes = torch.from_numpy(
        ints_to_limbs(too_long, BN254.fr.L).astype(np.int64))
    with pytest.raises(ValueError, match="SRS only supports"):
        tk.commit_device(dsrs, planes)


def test_open_and_verify_match_jax(srs):
    jsrs, dsrs, hsrs = srs
    coeffs, z = _poly(7, 9), 0xABCDEF
    C = tk.commit(hsrs, coeffs, host=True)
    want_v, want_w = jk.open_poly(jsrs, coeffs, z, host=True)
    value, W = tk.open_poly(dsrs, coeffs, z)
    assert (value, W) == (want_v, want_w)
    assert tk.open_poly(hsrs, coeffs, z, host=True) == (want_v, want_w)
    assert value == sum(c * pow(z, i, Q) for i, c in enumerate(coeffs)) % Q
    assert tk.verify_opening(hsrs, C, z, value, W)
    assert jk.verify_opening(jsrs, C, z, value, W)
    assert not tk.verify_opening(hsrs, C, z, (value + 1) % Q, W)
    assert not tk.verify_opening(hsrs, C, z + 1, value, W)
    assert not tk.verify_opening(hsrs, C, z, value,
                                 BN254.host_g1.double(W))


def test_fold_and_batch_open_match_jax(srs):
    jsrs, dsrs, hsrs = srs
    polys = [_poly(20 + i, k) for i, k in enumerate((4, 9, 6))]
    z, gamma = 0x1357, 0x2468
    assert tk.fold_polys(polys, gamma, Q) == jk.fold_polys(polys, gamma, Q)
    values, W = tk.batch_open_single_point(hsrs, polys, z, gamma, host=True)
    want_values = [sum(c * pow(z, i, Q) for i, c in enumerate(p)) % Q
                   for p in polys]
    assert values == want_values
    folded = tk.fold_polys(polys, gamma, Q)
    assert (sum(v * pow(gamma, i, Q) for i, v in enumerate(values)) % Q, W) \
        == jk.open_poly(jsrs, folded, z, host=True)
    # two openings at distinct points, batched with a fixed u
    cs = [tk.commit(hsrs, p, host=True) for p in polys[:2]]
    zs = [z, z + 5]
    opened = [tk.open_poly(hsrs, p, zi, host=True)
              for p, zi in zip(polys, zs)]
    vs, ws = [o[0] for o in opened], [o[1] for o in opened]
    assert tk.batch_verify_multi_points(hsrs, cs, zs, vs, ws, u=77)
    assert jk.batch_verify_multi_points(jsrs, cs, zs, vs, ws, u=77)
    assert tk.batch_verify_multi_points(hsrs, cs, zs, vs, ws)
    assert not tk.batch_verify_multi_points(hsrs, cs, zs, vs[::-1], ws, u=77)
