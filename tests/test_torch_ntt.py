"""gnark_tpu_torch.ops.ntt and the Groth16 quotient against gnark_tpu's
host NTT (gnark_tpu.backend.groth16._host_ntt) and naive evaluation.

Tolerance: none; field elements compare exactly as Python ints.
"""

import random

import numpy as np
import pytest
import torch

from gnark_tpu.backend.groth16 import _host_ntt
from gnark_tpu.curves import BN254
from gnark_tpu.ops.ntt import bit_reverse_perm as jax_bit_reverse_perm
from gnark_tpu_torch.backend.groth16 import compute_h
from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm

torch.set_num_threads(1)
SPEC = BN254.fr
Q = SPEC.modulus


def _rand(n, seed):
    rnd = random.Random(seed)
    return [rnd.randrange(Q) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 8, 1024])
def test_bit_reverse_perm_matches_jax_package(n):
    np.testing.assert_array_equal(bit_reverse_perm(n), jax_bit_reverse_perm(n))


@pytest.mark.parametrize("coset", [False, True])
def test_fft_dif_matches_naive_evaluation(coset):
    n = 16
    d = Domain(SPEC, n, "cpu")
    coeffs = _rand(n, 1)
    evals = d.F.unpack(d.fft(d.F.pack(coeffs, "cpu"), "DIF", coset=coset))
    g = d.coset_gen if coset else 1
    brev = bit_reverse_perm(n)
    for i in range(n):
        x = g * pow(d.omega, int(brev[i]), Q) % Q
        assert evals[i] == sum(c * pow(x, k, Q) for k, c in enumerate(coeffs)) % Q


@pytest.mark.parametrize("order", ["DIF", "DIT"])
@pytest.mark.parametrize("coset", [False, True])
def test_fft_ifft_roundtrip(order, coset):
    n = 64
    d = Domain(SPEC, n, "cpu")
    x = d.F.pack(_rand(n, 2), "cpu")
    back = d.ifft(d.fft(x, order, coset=coset),
                  "DIT" if order == "DIF" else "DIF", coset=coset)
    assert torch.equal(back, x)


def test_dit_matches_host_ntt():
    """DIT on bit-reversed input gives natural-order evaluations."""
    n = 32
    d = Domain(SPEC, n, "cpu")
    coeffs = _rand(n, 3)
    brev = bit_reverse_perm(n)
    x = d.F.pack([coeffs[i] for i in brev], "cpu")
    assert d.F.unpack(d.fft(x, "DIT")) == _host_ntt(coeffs, d.omega, Q)


@pytest.mark.parametrize("n", [16, 64])
def test_compute_h_matches_host_chain(n):
    """The quotient chain of gnark_tpu's _prove_host, built from
    _host_ntt, against the port's device compute_h."""
    a, b, c = _rand(n, 4), _rand(n, 5), _rand(n, 6)
    omega = SPEC.root_of_unity(n)
    g = SPEC.multiplicative_generator % Q

    def coset_evals(vals):
        coeffs = _host_ntt(vals, omega, Q, inverse=True)
        return _host_ntt([v * pow(g, i, Q) % Q for i, v in enumerate(coeffs)],
                         omega, Q)

    ae, be, ce = coset_evals(a), coset_evals(b), coset_evals(c)
    den = pow(pow(g, n, Q) - 1, -1, Q)
    he = [(x * y - z) % Q * den % Q for x, y, z in zip(ae, be, ce)]
    h = _host_ntt(he, omega, Q, inverse=True)
    ginv = pow(g, -1, Q)
    h = [v * pow(ginv, i, Q) % Q for i, v in enumerate(h)]
    want = [h[i] for i in bit_reverse_perm(n)]

    d = Domain(SPEC, n, "cpu")
    F = d.F
    got = compute_h(d, F.pack(a, "cpu"), F.pack(b, "cpu"), F.pack(c, "cpu"))
    assert F.unpack(got) == want
