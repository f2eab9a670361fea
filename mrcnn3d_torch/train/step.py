"""The train state and one train step (port of `mrcnn3d/train/step.py`,
one device: data parallelism and the mesh branches are ROADMAP Queue A
item 10).

A step: the flagship `forward_train` under autocast (bf16 compute over
float32 parameters when `compute_dtype` is bf16, as the JAX package's
`dtype=bfloat16` modules with float32 params), backward, the optax
chain's clip, then SGD.  It returns the loss dict plus "loss", the
total, as tensors on the device (no host sync).
"""
from __future__ import annotations

import dataclasses

import torch

from ..detectors.build import anchor_cfgs
from ..detectors.pipeline import _no_mark, anchor_sets_for, forward_train
from .optim import clip_by_global_norm_, make_optimizer, step_lr_schedule


@dataclasses.dataclass
class TrainState:
    """model, optimizer (SGD), schedule (step -> lr), cfg, step (the
    number of steps taken), compute_dtype (None: float32 throughout)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: object
    cfg: object
    step: int = 0
    compute_dtype: torch.dtype | None = None
    anchors: dict = dataclasses.field(default_factory=dict)

    def anchor_sets(self, shapes):
        """Per-scale anchor sets for the (D, H, W) input of each scale."""
        key = tuple(tuple(int(v) for v in s) for s in shapes)
        if key not in self.anchors:
            dev = next(self.model.parameters()).device
            self.anchors[key] = anchor_sets_for(
                self.model, anchor_cfgs(self.cfg), key, dev)
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
    """One SGD step on `batch` (the layout of `forward_train`), its
    samplers drawing from `draws` (`core.targets.TorchDraws` or a
    replay).  `mark(name)` is called at the start and after each stage.
    Returns the loss
    dict plus "loss"; updates `state` in place."""
    mark = mark or _no_mark
    sets = state.anchor_sets([batch["imgs"].shape[2:],
                              batch["imgs_2"].shape[2:]])
    state.optimizer.zero_grad(set_to_none=True)
    mark("start")
    dev = batch["imgs"].device
    with torch.autocast(dev.type, dtype=state.compute_dtype or torch.float32,
                        enabled=state.compute_dtype is not None):
        total, losses = forward_train(state.model, batch, state.cfg, sets,
                                      draws, mark=mark)
    total.backward()
    mark("backward")
    apply_gradients(state)
    mark("optimizer")
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    return metrics


def apply_gradients(state):
    """The optimizer half of a step, on the gradients the parameters
    hold: this step's learning rate, the global-norm clip, SGD; then the
    step count advances."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    grad_clip = state.cfg.get("optimizer_config", {}).get("grad_clip")
    if grad_clip:
        clip_by_global_norm_(list(state.model.parameters()),
                             grad_clip.get("max_norm", 35.0))
    state.optimizer.step()
    state.step += 1
