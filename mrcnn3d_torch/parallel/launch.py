"""Fresh processes joined in one gloo process group: the multi-process
runs of `entry.dryrun_multichip`, the tests and `chip_smoke.py`'s
multicard phase (gloo carries CPU and CUDA tensors, so two ranks can
share one card).  `torchrun`, through `tools/dist_train.sh`, launches
training on N cards under NCCL.

The ranks meet over a file store in a fresh directory, so runs side by
side never share a port.  A rank that raises takes the run down: `spawn`
raises with its traceback.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 300


def _rank_main(rank, fn, world, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world, args=(), workdir=None):
    """Runs `fn(rank, world, *args)` in `world` spawned processes, one
    intra-op thread each, joined in a gloo process group whose file
    store lies in `workdir` (a temporary directory, removed after, by
    default).  Returns the ranks' return values (torch.save'd, so
    tensors are brought back on their device) in rank order.  `fn` must
    be a module-level function."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="mrcnn3d_torch_spawn_")
    os.makedirs(workdir, exist_ok=True)
    try:
        mp.start_processes(_rank_main, args=(fn, world, workdir, args),
                           nprocs=world, start_method="spawn", join=True)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
