"""Multi-process mesh initialization on torch.distributed (counterpart of
gnark_tpu/parallel/multihost.py).

One process a card: the mesh's minor axis spans the ranks of one host and
its major axis the hosts.  The prover's collectives are laid out so the
heavy traffic stays on the minor axis:

  * sharded MSM partial fold (parallel/sharded_msm.py): one all-gather of
    one partial point a rank and MSM; shard the point axis over the whole
    mesh.
  * sharded four-step NTT (parallel/sharded_ntt.py): two all-to-all
    transposes a transform, bandwidth-bound; keep the NTT axis within a
    host and replicate across hosts.

Usage (the same program on every rank, e.g. under torchrun):

    from gnark_tpu_torch.parallel import multihost
    mesh = multihost.init_mesh(ntt_axis="ntt", dp_axis="dp")
    proof = groth16.prove(cs, pk, witness, mesh=mesh, mesh_axis="ntt")

The backend is NCCL when every rank of a host has a card of its own.  Two
NCCL ranks on one card are refused ("Duplicate GPU detected"), so ranks
that outnumber the cards need ``backend="gloo"`` from the caller, which
then stages each collective through host memory; without a card, gloo.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def local_ranks(world_size: int) -> int:
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def pick_backend(backend: str | None, ranks_here: int) -> str:
    """The caller's backend, else NCCL when each of this host's ranks has a
    card of its own, gloo when there is no card; raises when ranks
    outnumber the cards."""
    if backend is not None:
        return backend
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        return "gloo"
    if ranks_here <= cards:
        return "nccl"
    raise ValueError(
        f"{ranks_here} ranks on this host share {cards} card(s): NCCL "
        f"refuses two ranks on one device; pass backend='gloo' to stage "
        f"the collectives through host memory")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """init_process_group with torchrun's env-var fallbacks (MASTER_ADDR
    and MASTER_PORT as ``coordinator`` "host:port", WORLD_SIZE, RANK);
    arguments take precedence.  A no-op when single-process or already
    initialized."""
    if dist.is_initialized():
        return
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator is None:
        return
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    here = local_ranks(world)
    backend = pick_backend(backend, here)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % here)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, timeout=timeout)


def init_mesh(ntt_axis: str = "ntt", dp_axis: str = "dp",
              backend: str | None = None):
    """The global mesh: [hosts, ranks a host] named (dp_axis, ntt_axis),
    or 1-D (ntt_axis,) when every rank lives on one host.  A single
    process gets a world of one.  ``mesh.get_group(axis)`` is the process
    group a sharded plan's collectives run on."""
    init_distributed(backend=backend)
    if not dist.is_initialized():
        dist.init_process_group(pick_backend(backend, 1),
                                store=dist.HashStore(), world_size=1,
                                rank=0, timeout=TIMEOUT)
    world = dist.get_world_size()
    per_host = local_ranks(world)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if world <= per_host:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=(ntt_axis,))
    return init_device_mesh(device_type, (world // per_host, per_host),
                            mesh_dim_names=(dp_axis, ntt_axis))
