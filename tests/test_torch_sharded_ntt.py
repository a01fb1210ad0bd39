"""gnark_tpu_torch.parallel.sharded_ntt, the four-step NTT over gloo
ranks on the CPU (world 2 and 4, n = 64), against the port's unsharded
``Domain`` and ``compute_h`` and against gnark_tpu: its host NTT and
quotient chain (``backend.groth16._host_ntt``), its ``ShardedDomain``'s
order helpers and coset tables (built on the conftest's 8-device CPU
mesh, which needs no transform compile) and, under ``-m slow``, its own
sharded transforms and unsharded ``Domain`` (their XLA compiles take
minutes on the CPU).

Every rank gathers its blocks into the global [L, n]; each rank's result
must be the same.  Tolerance: none; limbs and field elements compare
exactly.
"""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_sharded_cases as C
from gnark_tpu.backend.groth16 import _host_ntt
from gnark_tpu.fields import BN254_FR as JFR
from gnark_tpu.parallel.sharded_ntt import ShardedDomain as JShardedDomain
from gnark_tpu_torch.backend.groth16 import compute_h
from gnark_tpu_torch.curves import BN254
from gnark_tpu_torch.ops.ntt import Domain, bit_reverse_perm

torch.set_num_threads(1)
N = 64
WORLDS = (2, 4)
SPEC = BN254.fr
Q = SPEC.modulus


def _vals(seed, bound=1 << 62):
    rnd = random.Random(seed)
    return [rnd.randrange(1, bound) for _ in range(N)]


@pytest.fixture(scope="module")
def case():
    dom = Domain(SPEC, N, "cpu")
    F = dom.F
    coeffs = _vals(3)
    x = F.pack(coeffs, "cpu")
    brev = torch.from_numpy(bit_reverse_perm(N).astype(np.int64))
    evals = dom.fft(x, "DIF")[:, brev]                  # natural order
    abc = [F.pack(_vals(s, Q % (1 << 60)), "cpu") for s in (7, 8, 9)]
    args = (N, x.numpy(), evals.numpy(), *(t.numpy() for t in abc))
    started = {w: C.start_ranks(C.ntt_case, w, args, timeout=240)
               for w in WORLDS}
    runs = {}
    for w, ranks in started.items():
        try:
            runs[w] = ranks.join()
        except Exception as e:          # each world's tests report it
            runs[w] = e
    return dict(dom=dom, coeffs=coeffs, x=x, evals=evals, abc=abc,
                runs=runs)


def _ranks(case, world):
    runs = case["runs"][world]
    if isinstance(runs, Exception):
        raise runs
    assert len(runs) == world
    for r in runs[1:]:
        assert r.keys() == runs[0].keys()
        for k in r:
            assert np.array_equal(r[k], runs[0][k]), k
    return runs[0]


def _ints(planes):
    return BN254_F.unpack(torch.as_tensor(planes))


BN254_F = Domain(SPEC, 2, "cpu").F


def _sd(world):
    return JShardedDomain(JFR, N, Mesh(np.array(jax.devices()[:world]),
                                       ("x",)), "x")


@pytest.mark.parametrize("world", WORLDS)
def test_fft_equals_domain_and_host_ntt(case, world):
    got = _ranks(case, world)
    sd = _sd(world)
    nat = sd.deinterleave(got["fft"])
    assert np.array_equal(nat, case["evals"].numpy())
    assert _ints(nat) == _host_ntt(case["coeffs"], SPEC.root_of_unity(N), Q)


@pytest.mark.parametrize("world", WORLDS)
def test_ifft_round_trip(case, world):
    got = _ranks(case, world)
    back = _sd(world).deinterleave(got["ifft"])
    assert np.array_equal(back, case["x"].numpy())
    evals = _ints(case["evals"])
    assert _ints(back) == _host_ntt(evals, SPEC.root_of_unity(N), Q,
                                    inverse=True)


@pytest.mark.parametrize("world", WORLDS)
def test_fft_from_strided_inverts_ifft(case, world):
    got = _ranks(case, world)
    assert np.array_equal(got["from_strided"], case["evals"].numpy())


def _host_quotient(a, b, c):
    """gnark_tpu's host quotient chain (groth16._prove_host): bit-reversed
    coefficients of (ab - c) / (g^n - 1) on the coset."""
    omega, g = SPEC.root_of_unity(N), SPEC.multiplicative_generator % Q

    def coset_evals(vals):
        coeffs = _host_ntt(vals, omega, Q, inverse=True)
        return _host_ntt([v * pow(g, i, Q) % Q for i, v in enumerate(coeffs)],
                         omega, Q)

    ae, be, ce = (coset_evals(v) for v in (a, b, c))
    den = pow(pow(g, N, Q) - 1, -1, Q)
    he = [(x * y - z) * den % Q for x, y, z in zip(ae, be, ce)]
    ginv = pow(g, -1, Q)
    h = [v * pow(ginv, i, Q) % Q
         for i, v in enumerate(_host_ntt(he, omega, Q, inverse=True))]
    return [h[i] for i in bit_reverse_perm(N)]


@pytest.mark.parametrize("world", WORLDS)
def test_compute_h_equals_domain_and_host_chain(case, world):
    got = _ranks(case, world)
    want = compute_h(case["dom"], *case["abc"])
    assert np.array_equal(got["h_brev"], want.numpy())
    assert _ints(got["h_brev"]) == _host_quotient(
        *(_ints(t) for t in case["abc"]))


@pytest.mark.parametrize("world", WORLDS)
def test_order_helpers_and_coset_tables_equal_gnark_tpu(case, world):
    got = _ranks(case, world)
    sd = _sd(world)
    x = case["x"].numpy()
    assert np.array_equal(got["perm"], sd.strided_to_brev_perm())
    assert np.array_equal(got["interleave"], sd.interleave(x))
    assert np.array_equal(got["deinterleave"], sd.deinterleave(x))
    for key, inverse in (("coset", False), ("coset_inv", True)):
        want = np.asarray(sd.coset_scale_strided(inverse)).astype(np.int64)
        assert np.array_equal(got[key], want)


@pytest.mark.parametrize("world", WORLDS)
def test_preconditions_refuse_a_domain_below_a_squared(case, world):
    assert _ranks(case, world)["small_refused"]


@pytest.mark.slow
@pytest.mark.parametrize("world", WORLDS)
def test_transforms_equal_gnark_tpu_sharded_and_domain(case, world):
    """gnark_tpu's own sharded calls on a mesh of ``world`` CPU devices,
    and its unsharded Domain and _compute_h (XLA compiles: minutes)."""
    import jax.numpy as jnp

    from gnark_tpu.backend.groth16 import _compute_h
    from gnark_tpu.ops.ntt import Domain as JDomain

    got = _ranks(case, world)
    sd = _sd(world)
    u32 = {k: jnp.asarray(case[k].numpy().astype(np.uint32))
           for k in ("x", "evals")}
    abc = [jnp.asarray(t.numpy().astype(np.uint32)) for t in case["abc"]]
    assert np.array_equal(np.asarray(sd.fft(u32["x"])), got["fft"])
    assert np.array_equal(np.asarray(sd.ifft(u32["evals"])), got["ifft"])
    assert np.array_equal(np.asarray(sd.fft_from_strided(sd.ifft(
        u32["evals"]))), got["from_strided"])
    h = sd.compute_h(*abc)
    assert np.array_equal(np.asarray(jnp.take(
        h, jnp.asarray(sd.strided_to_brev_perm()), axis=1)), got["h_brev"])
    jdom = JDomain(JFR, N)
    assert np.array_equal(np.asarray(_compute_h(jdom, *abc)), got["h_brev"])
