"""Multi-process cases of gnark_tpu_torch/parallel on the CPU: gloo ranks
spawned from a test by ``gnark_tpu_torch.parallel.ranks``, each running a
case of the port alone (this module imports no jax and nothing of
gnark_tpu, so a rank loads only the port).
"""

from gnark_tpu_torch.parallel import ranks
from gnark_tpu_torch.parallel.ranks import free_port  # noqa: F401

DEPTH = 62           # the squaring chain of tests/test_sharded.py: domain 64


def start_ranks(case, world, args=(), timeout=240, env=None, master=True):
    """``ranks.start_ranks`` with one torch thread a rank: the tests' ranks
    run beside other test workers."""
    return ranks.start_ranks(case, world, args, timeout, env, master,
                             threads=1)


# ---- the cases (each runs in every rank) -----------------------------------


def msm_fixture(n=64):
    """tests/test_sharded.py's fixture: n points (3 + 2i) G, scalars the
    product of two seeded 62-bit draws; G2's points the same multiples of
    G2's generator.  -> {group: (host points, scalars)}."""
    import numpy as np

    from gnark_tpu_torch.curves import BN254
    rng = np.random.default_rng(0)
    scalars = [int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
               for _ in range(n)]
    return {g: ([host.scalar_mul(gen, 3 + 2 * i) for i in range(n)], scalars)
            for g, host, gen in (("g1", BN254.host_g1, BN254.g1_gen),
                                 ("g2", BN254.host_g2, BN254.g2_gen))}


def msm_inputs(group, points, scalars, device="cpu"):
    """-> (curve ops, host curve, (xs, ys, inf, scalar limbs))."""
    import torch

    from gnark_tpu_torch.backend.groth16 import _Groups
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.ops.ec import points_to_device
    from gnark_tpu_torch.ops.limbs import ints_to_limbs
    K = _Groups(BN254)
    G, host, zero = ((K.g1, BN254.host_g1, 0) if group == "g1"
                     else (K.g2, BN254.host_g2, K.g2_zero))
    xs, ys, inf = points_to_device(G, points, zero, device)
    sc = torch.from_numpy(ints_to_limbs(scalars, BN254.fr.L).astype(
        "int64")).to(device)
    return G, host, (xs, ys, inf, sc)


def affine(G, host, P):
    """A Jacobian result point -> host affine (None = infinity)."""
    from gnark_tpu_torch.backend.groth16 import _to_host
    return _to_host(G, host, P)


def chain_circuit(schema, depth=DEPTH):
    """y = x^(2^depth), one multiplication a squaring."""
    class Chain(schema.Circuit):
        x = schema.Secret()
        out = schema.Public()

        def define(self, api):
            v = self.x
            for _ in range(depth):
                v = api.mul(v, v)
            api.assert_is_equal(v, self.out)
    return Chain()


def chain_witness(q, depth=DEPTH):
    return [pow(3, pow(2, depth, q - 1), q), 3]


def chain_key():
    """The chain's host setup (rng 3), packed for the CPU."""
    import random

    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.frontend import schema
    from gnark_tpu_torch.frontend.compile import compile_circuit
    cs = compile_circuit(chain_circuit(schema), BN254)
    pk, vk = groth16.setup(cs, BN254, rng=random.Random(3), host=True)
    return cs, groth16.pk_to_device(pk, "cpu"), vk


def sharded_case(axis="shard"):
    """The sharded MSM of the fixture (G1 and G2; G1 again with the last
    rank's scalars zero) and the mesh prove of the chain (rng 4):
    -> {"msm": {case: affine}, "proof": (ar, bs, krs),
    "timings": ..., "n_dev": ..., "local_rank": ...}."""
    import random

    from gnark_tpu_torch.backend import groth16
    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.parallel import multihost
    from gnark_tpu_torch.parallel.sharded_msm import sharded_msm

    mesh = multihost.init_mesh(ntt_axis=axis)
    out = {"msm": {}, "n_dev": mesh.get_group(axis).size(),
           "local_rank": mesh.get_local_rank(axis)}
    for group, (points, scalars) in msm_fixture().items():
        G, host, args = msm_inputs(group, points, scalars)
        out["msm"][group] = affine(G, host,
                                   sharded_msm(G, mesh, axis, *args))
    # the last rank's shard all zero scalars: its partial is the identity
    points, scalars = msm_fixture()["g1"]
    zeros = scalars[:-len(scalars) // out["n_dev"]]
    zeros += [0] * (len(scalars) - len(zeros))
    G, host, args = msm_inputs("g1", points, zeros)
    out["msm"]["g1_zero_shard"] = affine(G, host,
                                         sharded_msm(G, mesh, axis, *args))
    cs, pk, _ = chain_key()
    timings = {}
    proof = groth16.prove(cs, pk, chain_witness(BN254.fr.modulus),
                          rng=random.Random(4), mesh=mesh, mesh_axis=axis,
                          timings=timings)
    out["proof"] = (proof.ar, proof.bs, proof.krs)
    out["timings"] = timings
    return out


def ntt_case(n, x, evals, a, b, c, axis="x"):
    """ShardedDomain over BN254's fr at size n: x natural coefficients,
    evals natural evaluations, a/b/c the quotient's inputs, all global
    int64 [L, n] Montgomery planes (numpy).  Each output is gathered into
    the global [L, n]: -> {"fft": strided, "ifft": strided, "from_strided":
    natural, "h_brev": ..., "perm", "interleave", "deinterleave"}."""
    import numpy as np
    import torch

    from gnark_tpu_torch.curves import BN254
    from gnark_tpu_torch.parallel import multihost
    from gnark_tpu_torch.parallel.sharded_ntt import ShardedDomain

    mesh = multihost.init_mesh(ntt_axis=axis)
    sd = ShardedDomain(BN254.fr, n, mesh, axis, "cpu")
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, evals=evals, a=a, b=b, c=c).items()}
    out = {"fft": sd.gather(sd.fft(sd.block(t["x"]))),
           "ifft": sd.gather(sd.ifft(sd.block(t["evals"]))),
           "from_strided": sd.gather(sd.fft_from_strided(sd.ifft(
               sd.block(t["evals"])))),
           "coset": sd.coset_scale_strided(),
           "coset_inv": sd.coset_scale_strided(inverse=True)}
    h = sd.gather(sd.compute_h(sd.block(t["a"]), sd.block(t["b"]),
                               sd.block(t["c"])))
    out["h_brev"] = h[:, torch.from_numpy(
        sd.strided_to_brev_perm().astype(np.int64))]
    out = {k: v.numpy() for k, v in out.items()}
    out["perm"] = sd.strided_to_brev_perm()
    out["interleave"] = sd.interleave(x)
    out["deinterleave"] = sd.deinterleave(x)
    try:                         # n < A^2: the four steps do not fit
        ShardedDomain(BN254.fr, sd.A, mesh, axis, "cpu")
        out["small_refused"] = False
    except AssertionError:
        out["small_refused"] = True
    return out


def mesh_case(axis_names=("ntt", "dp"), backend=None):
    """init_mesh under the rank's environment: -> the mesh's dim names,
    shape, and per dim the local rank and the sum of the global ranks over
    that dim's group (an all_reduce on it)."""
    import torch
    import torch.distributed as dist

    from gnark_tpu_torch.parallel import multihost

    ntt, dp = axis_names
    mesh = multihost.init_mesh(ntt_axis=ntt, dp_axis=dp, backend=backend)
    out = {"names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "dims": {}}
    for name in mesh.mesh_dim_names:
        t = torch.tensor([dist.get_rank()])
        dist.all_reduce(t, group=mesh.get_group(name))
        out["dims"][name] = (mesh.get_local_rank(name), int(t))
    return out
