"""The JAX package's signed windowed Pallas MSM, in interpret mode, against
the port's MSM on the same inputs: those of
test_msm_sortgather.py::test_signed_windowed_msm_interpret_end_to_end
(BN254, n = 64) and of its small-field smoke (a 62-bit field, n = 16,
16-bit scalars, with a zero scalar, a repeated point and an infinity
point).

slow tier: interpret mode unrolls the Pallas grid in-trace. The BN254
graph's XLA CPU compile takes tens of minutes and tens of GB; the
small-field graph takes minutes.  Tier-1 holds the port against the host
oracle and the JAX package's sort/gather instead (test_torch_msm.py).
Tolerance: none; points compare as Python ints.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import gnark_tpu.ops.msm as jax_msm
from gnark_tpu import fields
from gnark_tpu.curves import BN254
from gnark_tpu.curves.host import HostCurve, HostFp
from gnark_tpu.ops.ec import CurveOps as JaxCurveOps
from gnark_tpu.ops.limbs import field_ops as jax_field_ops
from gnark_tpu_torch.ops.ec import CurveOps, points_to_host
from gnark_tpu_torch.ops.limbs import field_ops
from gnark_tpu_torch.ops.msm import MSM

torch.set_num_threads(1)


def _bn254_n64():
    n = 64
    rng = np.random.default_rng(41)
    host = BN254.host_g1
    pts, P = [], BN254.g1_gen
    for _ in range(n):
        pts.append(P)
        P = host.add(P, BN254.g1_gen)
    scalars = [int.from_bytes(rng.bytes(31), "little") for _ in range(n)]
    scalars[0] = 0
    limbs = BN254.fr.to_limbs(scalars, montgomery=False)
    return (BN254.fp, BN254.b, host, pts, scalars, np.zeros(n, bool), limbs,
            None)


def _p62_n16():
    spec = fields.FieldSpec(name="p62_msm_smoke", modulus=(1 << 62) - 57,
                            multiplicative_generator=3)
    host = HostCurve(HostFp(spec.modulus), 1)          # y^2 = x^3 + 1
    gen = (3, 1159191455696576622)
    n = 16
    rng = np.random.default_rng(13)
    pts, P = [], gen
    for _ in range(n):
        pts.append(P)
        P = host.add(P, gen)
    scalars = [int(x) for x in rng.integers(1, 1 << 16, size=n)]
    scalars[0] = 0
    scalars[1] = (1 << 16) - 1
    pts[5] = pts[4]
    inf = np.zeros(n, bool)
    inf[7] = True
    limbs = spec.to_limbs(scalars, montgomery=False)[:1]
    return spec, 1, host, pts, scalars, inf, limbs, 4


CASES = {"bn254_n64": _bn254_n64, "p62_n16": _p62_n16}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_msm_matches_jax_window_pallas_interpret(case):
    spec, b, host, pts, scalars, inf, limbs, c = CASES[case]()
    n = len(pts)
    want = None
    for p, s, i in zip(pts, scalars, inf):
        if not i and s:
            want = host.add(want, host.scalar_mul(p, s))

    JF = jax_field_ops(spec)
    old = jax_msm._INTERPRET
    jax_msm._INTERPRET = True
    try:
        jplan = jax_msm.MSM(JaxCurveOps(JF, b=b), n, limbs.shape[0], c=c,
                            lanes=8, method="window_pallas", signed=True)
        out = jplan(JF.pack([p[0] for p in pts]), JF.pack([p[1] for p in pts]),
                    jnp.asarray(inf), jnp.asarray(limbs))
    finally:
        jax_msm._INTERPRET = old
    q = spec.modulus
    X, Y, Z = (JF.unpack(np.asarray(a))[0] for a in out)
    zi = pow(Z, -1, q)
    jax_got = (X * zi * zi % q, Y * zi * zi * zi % q)

    F = field_ops(spec)
    G = CurveOps(F, b=b)
    plan = MSM(G, n, limbs.shape[0], c=jplan.c, lanes=8)
    got = plan(F.pack([p[0] for p in pts], "cpu"),
               F.pack([p[1] for p in pts], "cpu"),
               torch.from_numpy(inf),
               torch.from_numpy(limbs.astype(np.int64)))
    assert points_to_host(G, got) == [jax_got] == [want]
