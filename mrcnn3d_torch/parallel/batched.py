"""Data-parallel batched inference (`mrcnn3d/parallel/batched.py`).

Volumes are independent at test time: each rank of the group runs the
one-card `simple_test` on its rows of the global batch with no
collective, then the outputs are all-gathered in global row order.  The
reference's counterpart is the multi-GPU test scatter of
MMDistributedDataParallel (mmdet/apis/train.py _dist_train and the
multi-GPU path of tools/test.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import local_rows


def make_batched_infer(det, group=None):
    """Returns a function: the global batch (B volumes a scale, B a
    multiple of the group's size, the same on every rank) -> the
    outputs of `det.simple_test` (an `entry.Flagship`) over all B rows,
    on every rank: dets / labels / valid (B, ...) and, with masks,
    mask_logits (B * max_per_img, ...)."""
    group = group or dist.group.WORLD
    rank, world = dist.get_rank(group), dist.get_world_size(group)

    def run(batch):
        out = det.simple_test(local_rows(batch, rank, world))
        whole = {}
        for k, v in out.items():
            parts = [torch.empty_like(v) for _ in range(world)]
            dist.all_gather(parts, v.contiguous(), group=group)
            whole[k] = torch.cat(parts)
        return whole

    return run
