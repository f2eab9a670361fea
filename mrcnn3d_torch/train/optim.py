"""SGD and its learning-rate schedule, as `mrcnn3d/train/optim.py`'s
optax chain (reference configs/3d-multi-resolution-rcnn.py:233-244 and
mmdet DistOptimizerHook): clip the gradients' global norm to 35, then
coupled weight decay (grad + wd * param), then momentum 0.9 (no
dampening, no Nesterov), then the step policy with a linear warmup.

How each part matches optax:
  * `clip_by_global_norm_` is optax's rule, not `clip_grad_norm_`'s:
    gradients scale by max_norm / norm only when the norm reaches
    max_norm, with no 1e-6 added to the norm (the scale is one multiply
    where optax divides then multiplies: a rounding apart);
  * `torch.optim.SGD(momentum, weight_decay, dampening=0)` is
    add_decayed_weights -> trace -> scale_by_learning_rate: its first
    step sets the buffer to the gradient, which is optax's trace started
    from zero (0.9 * 0 + g); a carried-over trace is set as the buffer;
  * the learning rate of step k (counted from 0) is schedule(k), set on
    the parameter group before the step, as optax's count is.
"""
from __future__ import annotations

import torch


def step_lr_schedule(base_lr, steps, iters_per_epoch, warmup_iters=10,
                     warmup_ratio=1.0 / 3, gamma=0.1):
    """mmcv's 'step' policy: gamma at each epoch in `steps` (counted in
    iterations: epoch * iters_per_epoch, from that iteration on), times
    the linear warmup factor ratio + (1 - ratio) * min(k / warmup, 1)."""
    boundaries = sorted(int(e) * iters_per_epoch for e in steps)

    def schedule(count):
        lr = base_lr
        for b in boundaries:
            if count >= b:
                lr = lr * gamma
        frac = min(count / max(warmup_iters, 1), 1.0)
        return lr * (warmup_ratio + (1.0 - warmup_ratio) * frac)

    return schedule


def make_optimizer(params, optimizer_cfg):
    """torch SGD from the reference optimizer config dict."""
    if optimizer_cfg["type"] != "SGD":
        raise NotImplementedError(
            f"optimizer {optimizer_cfg['type']!r}: the port has SGD only")
    return torch.optim.SGD(
        params, lr=optimizer_cfg["lr"],
        momentum=optimizer_cfg.get("momentum", 0.9),
        weight_decay=optimizer_cfg.get("weight_decay", 0.0),
        dampening=0.0, nesterov=False,
    )


@torch.no_grad()
def clip_by_global_norm_(params, max_norm):
    """optax.clip_by_global_norm in place on the parameters' gradients.
    Returns the norm before clipping (a 0-d tensor; no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    # one fused launch for the tensors' norms, then the norm of those
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
