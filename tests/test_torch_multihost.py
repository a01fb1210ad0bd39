"""gnark_tpu_torch.parallel.multihost on torch.distributed (CPU, gloo):

  * ``init_distributed`` is a no-op without torchrun's variables;
  * ``init_mesh`` gives a 1-D mesh (ntt,) when every rank is on one host,
    a 2-D [hosts, ranks a host] mesh (dp, ntt) when LOCAL_WORLD_SIZE says
    there are several hosts, and a world of one to a single process; each
    dim's process group holds the ranks it should (an all_reduce of the
    global ranks over it);
  * the backend rule: NCCL when every local rank has a card of its own,
    gloo without a card or when the caller names it, and a refusal when
    ranks outnumber the cards and the caller did not ask for gloo.
"""

import pytest
import torch
import torch.distributed as dist

import torch_sharded_cases as C
from gnark_tpu_torch.parallel import multihost

TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
            "LOCAL_WORLD_SIZE", "LOCAL_RANK")


def test_init_distributed_is_a_no_op_without_env(monkeypatch):
    for k in TORCHRUN:
        monkeypatch.delenv(k, raising=False)
    multihost.init_distributed()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def meshes():
    started = {
        "1d": C.start_ranks(C.mesh_case, 2, timeout=180),
        "2d": C.start_ranks(C.mesh_case, 4, timeout=180,
                            env={"LOCAL_WORLD_SIZE": "2"}),
        "single": C.start_ranks(C.mesh_case, 1, timeout=180, master=False),
    }
    return {k: v.join() for k, v in started.items()}


def test_init_mesh_1d_on_one_host(meshes):
    for rank, r in enumerate(meshes["1d"]):
        assert r["names"] == ("ntt",) and r["shape"] == (2,)
        assert r["backend"] == "gloo" and r["world"] == 2
        assert r["dims"]["ntt"] == (rank, 1)


def test_init_mesh_2d_across_hosts(meshes):
    for rank, r in enumerate(meshes["2d"]):
        assert r["names"] == ("dp", "ntt") and r["shape"] == (2, 2)
        host, local = divmod(rank, 2)
        # the ntt group is this host's ranks {2 host, 2 host + 1}, the dp
        # group this local rank across hosts {local, local + 2}
        assert r["dims"]["ntt"] == (local, 4 * host + 1)
        assert r["dims"]["dp"] == (host, 2 * local + 2)


def test_init_mesh_single_process(meshes):
    (r,) = meshes["single"]
    assert r["names"] == ("ntt",) and r["shape"] == (1,)
    assert r["world"] == 1 and r["dims"]["ntt"] == (0, 0)


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_backend_rule(monkeypatch):
    _cards(monkeypatch, 0)
    assert multihost.pick_backend(None, 4) == "gloo"
    _cards(monkeypatch, 2)
    assert multihost.pick_backend(None, 2) == "nccl"
    assert multihost.pick_backend("gloo", 2) == "gloo"
    _cards(monkeypatch, 1)
    assert multihost.pick_backend("gloo", 2) == "gloo"
    with pytest.raises(ValueError, match="backend='gloo'"):
        multihost.pick_backend(None, 2)


def test_ranks_outnumbering_cards_are_refused_before_connecting(monkeypatch):
    """Two ranks on one card without backend='gloo': init_distributed
    raises before it opens the store (no rank 1 ever joins here)."""
    _cards(monkeypatch, 1)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(C.free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="share 1 card"):
        multihost.init_mesh()
    assert not dist.is_initialized()
