"""Ranks of one host, spawned from a running program: each sets torchrun's
variables, runs ``case(*args)`` and hands back its result.

``start_ranks`` spawns ``world`` processes (the ``spawn`` start method, a
free TCP port on 127.0.0.1 for the process group).  ``Ranks.join`` waits
at most ``timeout`` seconds in all, kills any rank still running, and
raises with a rank's traceback if one failed: a collective that never
completes fails the caller instead of hanging it (the process group has
its own timeout too, ``multihost.TIMEOUT``).  The tests run the mesh
prover's cases so on the CPU, and ``chip_smoke.py`` its phase on the card.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, case, args, out, env, threads):
    import torch
    if threads is not None:
        torch.set_num_threads(threads)
    os.environ.update(env)
    if "MASTER_ADDR" in env:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
    try:
        result = ("ok", case(*args))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    if result[0] != "ok":
        os._exit(1)


class Ranks:
    def __init__(self, procs, out, timeout):
        self.procs, self.out, self.timeout = procs, out, timeout
        self.t0 = time.monotonic()

    def join(self):
        """-> [rank 0's result, rank 1's, ...]; raises if a rank failed or
        did not finish within the timeout."""
        deadline = self.t0 + self.timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.out.name, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results.append(pickle.load(f))
            else:
                results.append(("error", f"no result (exit {p.exitcode})"))
        self.out.cleanup()
        if late:
            raise TimeoutError(f"ranks {late} still running after "
                               f"{self.timeout} s")
        errors = [f"rank {r}: {v}" for r, (k, v) in enumerate(results)
                  if k != "ok"]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [v for _, v in results]


def start_ranks(case, world, args=(), timeout=240, env=None,
                master=True, threads=None) -> Ranks:
    """Spawn ``world`` ranks running ``case(*args)``; with ``master``,
    torchrun's MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE are set (a free
    port), else none (a single process).  ``threads`` sets each rank's
    torch CPU threads.  ``case`` must be importable by name."""
    env = dict(env or {})
    if master:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    out = tempfile.TemporaryDirectory()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, case, args, out.name, env, threads))
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out, timeout)
