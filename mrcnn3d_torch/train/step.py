"""The train state and one train step (port of `mrcnn3d/train/step.py`).

A step: `forward_train` under autocast (bf16 compute over
float32 parameters when `compute_dtype` is bf16, as the JAX package's
`dtype=bfloat16` modules with float32 params), backward, the optax
chain's clip, then SGD.  It returns the loss dict plus "loss", the
total, as tensors on the device (no host sync).

With a mesh (`parallel.mesh.Mesh`, the JAX step's `mesh=`), each rank
takes its rows of the global batch and the step is the JAX step's over
that batch: the normalizers count over the data group, the samplers key
each image by its global index, the gradients (zero-filled where the
loss did not reach) are summed over every rank before the global-norm
clip, and the logged losses are summed over the data group.  A 2-D mesh
also shards each volume's depth over the depth group
(`parallel/spatial.py`), whose ranks each differentiate 1/n_depth of
the loss they share.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..detectors.build import anchor_cfgs
from ..detectors.pipeline import (
    _no_mark,
    anchor_sets_for,
    forward_train,
    scale_shapes,
)
from ..core.reduce import global_sum, loss_group
from ..parallel.mesh import allreduce_grads
from ..parallel.spatial import depth_sharded
from .optim import clip_by_global_norm_, make_optimizer, step_lr_schedule


@dataclasses.dataclass
class TrainState:
    """model, optimizer (SGD), schedule (step -> lr), cfg, step (the
    number of steps taken), compute_dtype (None: float32 throughout),
    mesh (None: one process)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: object
    cfg: object
    step: int = 0
    compute_dtype: torch.dtype | None = None
    anchors: dict = dataclasses.field(default_factory=dict)
    mesh: object = None

    def anchor_sets(self, shapes):
        """Per-scale anchor sets for the (D, H, W) input of each scale,
        inside flags under train_cfg.rpn.allowed_border (as
        `mrcnn3d/apis/train_api.py:compute_anchor_sets`)."""
        key = tuple(tuple(int(v) for v in s) for s in shapes)
        if key not in self.anchors:
            dev = next(self.model.parameters()).device
            allowed = self.cfg.train_cfg["rpn"].get("allowed_border", 0)
            self.anchors[key] = anchor_sets_for(
                self.model, anchor_cfgs(self.cfg), key, dev, allowed)
        return self.anchors[key]


def create_train_state(model, cfg, compute_dtype=None, iters_per_epoch=None):
    """A fresh state for a training build of the model (train=True):
    SGD and the step schedule from cfg.optimizer / cfg.lr_config.

    iters_per_epoch turns the config's lr steps (epochs) into iterations,
    as `mrcnn3d/apis/train_api.py` counts it (len(dataset) // batch
    size).  None: no step decay, only the warmup, as the JAX benches run
    it (steps=[])."""
    lr_cfg = cfg.get("lr_config", {})
    steps = lr_cfg.get("step", []) if iters_per_epoch else []
    schedule = step_lr_schedule(
        cfg.optimizer["lr"], steps, iters_per_epoch or 1,
        lr_cfg.get("warmup_iters", 10), lr_cfg.get("warmup_ratio", 1.0 / 3),
    )
    optimizer = make_optimizer(list(model.parameters()), cfg.optimizer)
    return TrainState(model, optimizer, schedule, cfg,
                      compute_dtype=compute_dtype)


def train_step(state, batch, draws, mark=None):
    """One SGD step on `batch` (the layout of `forward_train`; with a
    mesh, this rank's rows of the global batch), its samplers drawing
    from `draws` (`core.targets.TorchDraws`, `KeyedDraws` or a replay).
    `mark(name)` is called at the start and after each stage.  Returns
    the loss dict plus "loss"; updates `state` in place."""
    mark = mark or _no_mark
    mesh = state.mesh
    sets = state.anchor_sets(scale_shapes(state.model, batch))
    state.optimizer.zero_grad(set_to_none=True)
    mark("start")
    dev = batch["imgs"].device
    offset = mesh.data_rank * batch["imgs"].shape[0] if mesh else 0
    depth_group = mesh.depth_group if mesh else None
    shard = contextlib.nullcontext() if depth_group is None else \
        depth_sharded(state.model.backbone, depth_group)
    with loss_group(mesh.data_group if mesh else None), shard:
        with torch.autocast(dev.type,
                            dtype=state.compute_dtype or torch.float32,
                            enabled=state.compute_dtype is not None):
            total, losses = forward_train(state.model, batch, state.cfg,
                                          sets, draws, mark=mark,
                                          offset=offset)
        (total / mesh.n_depth if mesh else total).backward()
        mark("backward")
        if mesh is not None:
            params = list(state.model.parameters())
            _fill_grads(params)
            allreduce_grads(params)
            mark("allreduce")
        apply_gradients(state)
        mark("optimizer")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if mesh is not None:
            # each rank's losses are its share of the global batch's
            keys = [k for k in metrics if "loss" in k]
            summed = global_sum(torch.stack([metrics[k] for k in keys]))
            metrics.update(zip(keys, summed))
    return metrics


def _fill_grads(params):
    """A parameter the loss does not reach (the mask heads of scales past
    the first) takes a zero gradient, as in the JAX step, so that weight
    decay and momentum move it as optax does, and so that every rank
    reduces the same gradients."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def apply_gradients(state):
    """The optimizer half of a step, on the gradients the parameters
    hold: this step's learning rate, the global-norm clip, SGD; then the
    step count advances."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
        _fill_grads(group["params"])
    grad_clip = state.cfg.get("optimizer_config", {}).get("grad_clip")
    if grad_clip:
        clip_by_global_norm_(list(state.model.parameters()),
                             grad_clip.get("max_norm", 35.0))
    state.optimizer.step()
    state.step += 1
