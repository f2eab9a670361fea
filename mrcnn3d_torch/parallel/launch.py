"""Fresh processes joined in one gloo process group: the multi-process
runs of `entry.dryrun_multichip`, the tests and `chip_smoke.py`'s
multicard phase (gloo carries CPU and CUDA tensors, so two ranks can
share one card).  `torchrun`, through `tools/dist_train.sh`, launches
training on N cards under NCCL.

The ranks meet over a file store in a fresh directory, so runs side by
side never share a port.  A rank that raises or dies takes the run down:
`spawn` raises, with the rank's traceback where it has one.  So does a
rank whose process group outlives its teardown (`_check_torn_down`): its
gloo workers would otherwise reach interpreter shutdown, where one that
still holds a tensor aborts the rank at random
(`mesh.import_before_joining`).
"""
from __future__ import annotations

import datetime
import faulthandler
import gc
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import import_before_joining

TIMEOUT_S = 300


def _gloo_workers():
    """How many gloo worker threads (a process group's `pt_gloo_runloop`)
    this process runs; 0 where /proc cannot tell."""
    try:
        tasks = os.listdir("/proc/self/task")
    except OSError:
        return 0
    n = 0
    for t in tasks:
        try:
            with open(f"/proc/self/task/{t}/comm") as f:
                n += f.read().startswith("pt_gloo")
        except OSError:
            pass
    return n


def _check_torn_down(rank):
    """Collects (a group held only by a reference cycle dies here, not
    in interpreter shutdown), then raises if a process group's gloo
    workers still run: a reference to the group was kept, by torch or by
    the rank function, and the workers would reach interpreter
    shutdown."""
    gc.collect()
    n = _gloo_workers()
    if n:
        raise RuntimeError(
            f"rank {rank}: {n} gloo worker threads outlived "
            "destroy_process_group; something still holds a process "
            "group (see parallel.mesh.import_before_joining)")


def _rank_main(rank, fn, world, workdir, args):
    # a rank that dies of a signal prints every thread's stack
    faulthandler.enable()
    torch.set_num_threads(1)
    import_before_joining()
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    _check_torn_down(rank)


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
