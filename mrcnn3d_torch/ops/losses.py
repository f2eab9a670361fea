"""Weighted detection losses (torch).

Same semantics as `mrcnn3d/ops/losses.py` (reference
mmdet/core/loss/losses.py): `avg_factor` is always passed explicitly and
computed by the caller from tensors, so no loss needs a host value.
The losses compute in float32 whatever the dtype of the logits (bf16
under autocast).
"""
from __future__ import annotations

import torch


def _bce_with_logits(logits, labels):
    """Elementwise binary CE with logits, in the stable form
    max(x, 0) - x * y + log(1 + exp(-|x|))."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


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
    denom = torch.clamp(w.sum() * vox, min=1.0)
    return torch.sum(raw * w[:, None, None, None]) / denom


def accuracy(logits, target, valid=None):
    correct = (logits.argmax(dim=-1) == target).float()
    if valid is None:
        return 100.0 * correct.mean()
    w = valid.float()
    return 100.0 * torch.sum(correct * w) / torch.clamp(w.sum(), min=1.0)
