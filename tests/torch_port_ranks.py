"""Rank functions of the port's multi-process CPU tests, for
`mrcnn3d_torch.parallel.launch.spawn`.

A spawned rank imports the module of its function, so these live apart
from the test files that compare with the JAX package: a rank here
imports torch and the port, never JAX or `mrcnn3d` (under the tier-1
run's load, importing those took a rank about 12 s of its 25).
"""
import os
import types

import pytest
import torch

import chip_smoke as cs
from mrcnn3d_torch.core import reduce
from mrcnn3d_torch.models.resnet3d import ResNet3D
from mrcnn3d_torch.parallel import mesh as pmesh
from mrcnn3d_torch.parallel.spatial import spatial_extract_feat


def backbone_rank(rank, world, weights, x, width, grads):
    """The port's ResNet3D-50 depth-sharded over the world on the whole
    volume `x` (`spatial_extract_feat` on a model whose features are the
    backbone's, as the JAX test's wrapper): its stage outputs and, with
    `grads`, each parameter's gradient of sum_k <out_k, cos(out_k)> over
    1/world, summed over the ranks (the train step's rule)."""
    model = ResNet3D(50, width).to(x.dtype)
    model.load_state_dict(weights)
    outs = spatial_extract_feat(
        types.SimpleNamespace(backbone=model, extract_feat=model))(x)
    if not grads:
        return [o.detach() for o in outs]
    loss = sum((o * torch.cos(o.detach())).sum() for o in outs) / world
    loss.backward()
    pmesh.allreduce_grads(list(model.parameters()))
    return ([o.detach() for o in outs],
            {n: p.grad for n, p in model.named_parameters()})


def allreduce_rank(rank, world):
    """Sums of gradients of mixed sizes and dtypes over 1-KiB buckets."""
    params = [torch.nn.Parameter(torch.zeros(n, dtype=dt))
              for n, dt in ((300, torch.float32), (10, torch.float32),
                            (7, torch.float64), (500, torch.float32))]
    for i, p in enumerate(params):
        p.grad = torch.arange(p.numel(), dtype=p.dtype) * (rank + 1) + i
    pmesh.allreduce_grads(params, bucket_mb=1 / 1024)
    mesh = pmesh.make_mesh2(world // 2, 2)
    one = torch.tensor(float(rank))
    with reduce.loss_group(mesh.data_group):
        count = reduce.global_sum(one)
    with reduce.loss_group(None):
        local = reduce.global_sum(one)
    # under 4 ranks a normalizer outside a loss group is refused
    with pytest.raises(RuntimeError, match="outside a loss group"):
        reduce.global_sum(one)
    return [p.grad for p in params], float(count), mesh.depth_rank, \
        local is one


def train_detector_rank(rank, world, root):
    """train_detector at world 2 for two iterations on the synthetic
    set; this rank's parameters after them, and its checkpoint steps."""
    from mrcnn3d_torch.apis.train_api import train_detector
    from mrcnn3d_torch.data.coco3d import Coco3D2ScalesDataset
    from mrcnn3d_torch.train import checkpoint

    cfg = cs.small_train_config()
    cfg.data["imgs_per_gpu"] = 1
    cfg.data["workers_per_gpu"] = 0
    tr = cfg.data["train"]
    ds = Coco3D2ScalesDataset(
        os.path.join(root, "data", "instances.json"),
        os.path.join(root, "data", "volumes"),
        img_norm_cfg=tr["img_norm_cfg"], max_gt=4,
        extra_aug=tr["extra_aug"], seed=rank)
    wd = os.path.join(root, "wd")
    state = train_detector(cfg, ds, work_dir=wd, max_iters=2, mesh="auto",
                           device="cpu")
    return ({n: p.detach() for n, p in state.model.named_parameters()},
            state.step, checkpoint.CheckpointManager(wd).all_steps())
