"""Weighted detection losses (torch).

Same semantics as `mrcnn3d/ops/losses.py` (reference
mmdet/core/loss/losses.py): `avg_factor` is always passed explicitly and
computed by the caller from tensors, so no loss needs a host value.
The losses compute in float32 whatever the dtype of the logits (bf16
under autocast).  The normalizers that count over the batch (the mask
loss's voxels, the accuracy's rows) are summed over the data group of a
multi-process step (`core.reduce.global_sum`), as the JAX step counts
them over the global batch.
"""
from __future__ import annotations

import torch

from ..core.reduce import global_sum


def _bce_with_logits(logits, labels):
    """Elementwise binary CE with logits, in the stable form
    max(x, 0) - x * y + log(1 + exp(-|x|)), JAX's (`mrcnn3d/ops/
    losses.py:_bce_with_logits`) to the bit and in its gradient.

    At x == 0 exactly the pieces are not differentiable and the two
    frameworks pick other one-sided slopes: JAX takes 1/2 for max(x, 0)
    (its tie rule) and +1 for |x|, so the loss's gradient there is -y;
    torch's `clamp` takes 1 and `abs` 0, which gives 1 - y.  Logits are
    exactly 0 wherever a head's last layer sees all-zero features while
    its bias is still 0 (the first step from zero biases).  So max(x, 0)
    is written (x + |x|) / 2 (slope 1/2 at 0) and the |x| inside the
    log as a select on x >= 0 (slope +1 at 0): the same values, JAX's
    slopes."""
    relu = 0.5 * (logits + logits.abs())
    mag = torch.where(logits >= 0, logits, -logits)
    return relu - logits * labels + torch.log1p(torch.exp(-mag))


def weighted_cross_entropy(logits, labels, weight, avg_factor):
    """Softmax CE; logits (N, C), labels (N,) int, weight (N,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    raw = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    return torch.sum(raw * weight) / avg_factor


def weighted_binary_cross_entropy(logits, labels, weight, avg_factor):
    """Sigmoid BCE; shapes broadcastable; labels float or int."""
    logits = logits.float()
    raw = _bce_with_logits(logits, labels.to(logits.dtype))
    return torch.sum(raw * weight) / avg_factor


def smooth_l1(pred, target, beta):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def weighted_smoothl1(pred, target, weight, beta, avg_factor):
    return torch.sum(smooth_l1(pred.float(), target, beta) * weight) \
        / avg_factor


def mask_cross_entropy(pred, target, label, valid=None):
    """Per-class voxel BCE (reference losses.py:73-79).

    pred: (N, num_classes, Dm, Hm, Wm) logits; target (N, Dm, Hm, Wm);
    label (N,) int class per roi; valid (N,) bool padding mask.  The mean
    over the voxels of the valid rois' selected class slices.
    """
    idx = label.long()[:, None, None, None, None].expand(
        -1, 1, *pred.shape[2:])
    pred_slice = torch.gather(pred, 1, idx)[:, 0].float()
    raw = _bce_with_logits(pred_slice, target.float())
    if valid is None:
        return raw.mean()
    vox = float(raw[0].numel())
    w = valid.float()
    denom = torch.clamp(global_sum(w.sum()) * vox, min=1.0)
    return torch.sum(raw * w[:, None, None, None]) / denom


def accuracy(logits, target, valid=None):
    correct = (logits.argmax(dim=-1) == target).float()
    if valid is None:
        return 100.0 * correct.mean()
    w = valid.float()
    hits, rows = global_sum(torch.stack([torch.sum(correct * w), w.sum()]))
    return 100.0 * hits / torch.clamp(rows, min=1.0)


def expand_binary_labels(labels, label_weights, label_channels):
    """1-based class labels (N,) -> one-hot binary targets (N, C) and the
    weights broadcast to them (reference losses.py:118-126; `mrcnn3d/ops/
    losses.py:expand_binary_labels`): background (0) is all zeros."""
    labels = labels.long()
    cols = torch.arange(1, label_channels + 1, device=labels.device)
    bin_labels = (labels[:, None] == cols[None, :]).float()
    bin_weights = label_weights[:, None].expand(labels.shape[0],
                                                label_channels)
    return bin_labels, bin_weights


def weighted_sigmoid_focal_loss(logits, target, weight, avg_factor,
                                gamma=2.0, alpha=0.25):
    """Sigmoid focal loss (reference py_sigmoid_focal_loss, losses.py
    :35-55); target one-hot (N, C), weight broadcastable to it.  The BCE
    is `_bce_with_logits`, so its gradient at logit 0 is JAX's."""
    logits = logits.float()
    p = torch.sigmoid(logits)
    t = target.float()
    pt = (1 - p) * t + p * (1 - t)
    w = (alpha * t + (1 - alpha) * (1 - t)) * weight
    w = w * pt ** gamma
    return torch.sum(_bce_with_logits(logits, t) * w) / avg_factor
