"""Process groups for data and depth parallelism (torch.distributed).

Counterpart of `mrcnn3d/parallel/mesh.py`.  One process drives one
card.  A `Mesh` lays the world's ranks out as (n_data, n_depth), depth
innermost (rank = data_rank * n_depth + depth_rank), and holds this
rank's data group (the ranks of its depth index: they share the batch
normalizers and the loss) and depth group (the ranks of its data index:
they share the volumes, each holding a depth slab, `parallel/spatial.py`).

The JAX step differentiates one loss over the global batch.  Here each
rank differentiates its share of it: the loss normalizers are summed
over the data group before they divide (`core.reduce.global_sum` under
`loss_group`), and the gradients are summed, not averaged, over every
rank of the mesh (`allreduce_grads`, bucketed as the reference's
DistOptimizerHook, mmdet/core/utils/dist_utils.py:134-182).

The JAX module's barrier exists for XLA's compile skew; here a barrier
is needed only around checkpoints (`process_barrier`).
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..utils.device import resolve_device

BUCKET_MB = 25
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")

logger = logging.getLogger("mrcnn3d_torch")


def import_before_joining():
    """What a process imports before it joins a process group.

    `torch.distributed.nn.functional` binds the world group as its
    functions' default argument when it is imported (torch 2.13:
    `def broadcast(tensor, src, group=group.WORLD)`).  The first
    `torch.optim` optimizer imports it, through `torch._dynamo` and
    `torch.distributed._shard`: imported while a group exists, it keeps
    that group alive past `destroy_process_group`.  The group's gloo
    workers then run on into interpreter shutdown, and a worker still
    dropping the tensors of the last collective takes the GIL of a
    finalizing interpreter: the process aborts ("terminate called
    without an active exception", SIGABRT), at random, whenever that
    worker was slower than the main thread's way out.  Imported first,
    its defaults hold no group."""
    import torch.distributed.nn.functional  # noqa: F401


def init_dist(launcher="pytorch", backend=None, device=None):
    """Joins the process group of a `torchrun` launch (reference
    mmdet/apis/env.py:13-50): rank, world and local rank from torchrun's
    environment, raising when it is missing.  device: the card of
    LOCAL_RANK unless "cpu"; backend: NCCL on the card, gloo on the CPU
    unless given.  Returns (rank, world, device)."""
    if launcher != "pytorch":
        raise ValueError(f"launcher {launcher!r}: the port has 'pytorch' "
                         "(torchrun) only")
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--launcher pytorch needs torchrun's environment (missing "
            f"{', '.join(missing)}): run it under torchrun "
            "--nproc_per_node=N, or mrcnn3d_torch/tools/dist_train.sh")
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    import_before_joining()
    dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size(), device


def get_dist_info():
    """(rank, world); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class Mesh:
    """This rank's place in an (n_data, n_depth) layout of the world.
    data_group / depth_group: the process groups of this rank's depth
    and data index (depth_group None when n_depth is 1)."""

    n_data: int
    n_depth: int
    rank: int
    data_group: object
    depth_group: object = None

    @property
    def data_rank(self):
        return self.rank // self.n_depth

    @property
    def depth_rank(self):
        return self.rank % self.n_depth


def make_mesh(n_data=None):
    """The 1-D data-parallel layout over the world (n_data: the world
    size, which it must equal)."""
    return make_mesh2(n_data or get_dist_info()[1], 1)


def make_mesh2(n_data, n_depth):
    """The (n_data, n_depth) layout of hybrid parallelism, depth
    innermost as `mrcnn3d/parallel/mesh.py:make_mesh2` lays it, so a
    volume's slabs sit on neighbouring ranks.  Every rank must call it:
    it creates every group (torch.distributed's rule)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh2 needs a process group "
                           "(parallel.mesh.init_dist)")
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_data * n_depth != world:
        raise ValueError(f"a {n_data}x{n_depth} mesh needs {n_data * n_depth}"
                         f" ranks; the world has {world}")
    if n_depth == 1:
        return Mesh(n_data, 1, rank, dist.group.WORLD)
    grid = np.arange(world).reshape(n_data, n_depth)
    data_groups = [dist.new_group(grid[:, z].tolist())
                   for z in range(n_depth)]
    depth_groups = [dist.new_group(grid[d].tolist()) for d in range(n_data)]
    return Mesh(n_data, n_depth, rank, data_groups[rank % n_depth],
                depth_groups[rank // n_depth])


def local_rows(batch, rank, world):
    """This rank's rows of a global batch, the JAX layout
    (`shard_batch` / `globalize_batch`): global row j lives on rank
    j // (B / world).  batch: a dict of tensors, arrays or lists with
    the batch first."""
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {sizes}")
    b = sizes.pop()
    if b % world:
        raise ValueError(f"a batch of {b} does not split over {world} ranks")
    per = b // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def process_barrier(name):
    """All ranks meet here (a no-op outside a process group); `name`
    labels the wait in the debug log."""
    if dist.is_available() and dist.is_initialized():
        logger.debug("barrier %s", name)
        dist.barrier()


def broadcast_params(module, src=0, group=None):
    """Every parameter and buffer of `module` from rank `src`."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src, group=group)


def allreduce_grads(params, group=None, bucket_mb=BUCKET_MB):
    """Sums the gradients of `params` over `group` in place: flattened
    into buckets of at most `bucket_mb` MiB of one dtype, one all-reduce
    each (reference DistOptimizerHook's `_allreduce_coalesced`).  Every
    parameter needs a gradient: `train.step` zero-fills the ones the
    loss did not reach first, so that every rank reduces the same
    buckets."""
    grads = [p.grad for p in params]
    if any(g is None for g in grads):
        raise ValueError("allreduce_grads: a parameter has no gradient")
    limit = bucket_mb * 2**20
    buckets, nbytes = [[]], 0
    for g in grads:
        size = g.numel() * g.element_size()
        cur = buckets[-1]
        if cur and (g.dtype != cur[0].dtype or nbytes + size > limit):
            buckets.append([])
            nbytes = 0
        buckets[-1].append(g)
        nbytes += size
    for bucket in buckets:
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))
