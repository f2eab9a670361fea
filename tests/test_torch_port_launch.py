"""The port's multi-process launcher (`mrcnn3d_torch/parallel/launch.py`)
on the CPU, gloo ranks spawned from this JAX-free module:

  * a rank that raises makes `spawn` raise with the rank's traceback;
  * a rank that dies of SIGABRT makes `spawn` raise: no dead rank goes
    unseen;
  * ten spawns in a row of a two-rank all_gather return the same
    gathered tensors, with no rank lost;
  * a rank that builds an optimizer (which imports
    `torch.distributed.nn.functional`) leaves no process group behind,
    and a rank that keeps its group makes `spawn` raise: a group alive
    at interpreter shutdown aborted ranks at random (ROADMAP Queue C 10,
    `parallel.mesh.import_before_joining`).

The peer of a failing rank sleeps: `spawn` stops it once the failure is
seen, so the error it raises is always the failing rank's.
"""
import os
import resource
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mrcnn3d_torch.parallel.launch import spawn
from torch_port_fixtures import torch_threads  # noqa: F401

PEER_SLEEP_S = 120


def _raising_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(PEER_SLEEP_S)


def _aborting_rank(rank, world):
    if rank == 1:
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))  # no core file
        os.abort()
    time.sleep(PEER_SLEEP_S)


def _optimizer_rank(rank, world):
    torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1)
    x = torch.ones(4)
    dist.all_reduce(x)
    return float(x[0])


_KEPT = []


def _keeping_rank(rank, world):
    _KEPT.append(dist.group.WORLD)


def _gather_rank(rank, world):
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.stack(parts)


def test_a_raising_rank_raises_with_its_traceback(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException) as info:
        spawn(_raising_rank, 2, workdir=str(tmp_path))
    msg = str(info.value)
    assert "Process 1 terminated with the following error" in msg
    assert "_raising_rank" in msg
    assert "ValueError: rank 1 fails on purpose" in msg
    assert time.perf_counter() - t0 < PEER_SLEEP_S


def test_an_aborted_rank_raises(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessExitedException) as info:
        spawn(_aborting_rank, 2, workdir=str(tmp_path))
    assert info.value.error_index == 1
    assert info.value.signal_name == "SIGABRT"
    assert time.perf_counter() - t0 < PEER_SLEEP_S


def test_ten_spawns_in_a_row_gather_alike(tmp_path):
    want = torch.arange(4, dtype=torch.float32) + torch.tensor([[0.], [10.]])
    for i in range(10):
        out = spawn(_gather_rank, 2, workdir=str(tmp_path / str(i)))
        assert len(out) == 2
        for got in out:
            assert torch.equal(got, want), (i, got)


def test_a_rank_that_builds_an_optimizer_tears_its_group_down(tmp_path):
    assert spawn(_optimizer_rank, 2, workdir=str(tmp_path)) == [2.0, 2.0]


def test_a_rank_that_keeps_its_group_raises(tmp_path):
    with pytest.raises(mp.ProcessRaisedException,
                       match="outlived destroy_process_group"):
        spawn(_keeping_rank, 2, workdir=str(tmp_path))
