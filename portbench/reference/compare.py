"""The numbers that decide `correct`, and the helpers the references
share.

Every number compares a value the program produced with the float32
reference's value of the same thing: the same rows, the rows the
program's own scores chose.  None compares two rankings, so no number
depends on which of two rows that tie within rounding comes first.
"""
from __future__ import annotations

import torch

from . import ops


def rel(p, r):
    """||p - r|| / ||r|| over the whole tensor."""
    p, r = p.float(), r.float()
    return float((p - r).norm() / r.norm().clamp(min=1e-30))


def rowrel(p, r):
    """The worst row's ||p_i - r_i|| over the larger of ||r_i|| and the
    median row's norm (a row of near-zero values is measured against
    the typical row, not against itself)."""
    if p.shape[0] == 0:
        return 0.0
    p = p.float().reshape(p.shape[0], -1)
    r = r.float().reshape(r.shape[0], -1)
    norms = r.norm(dim=1)
    den = torch.maximum(norms, norms.median()).clamp(min=1e-30)
    return float(((p - r).norm(dim=1) / den).max())


def head_rows(outs):
    """A head's output tuple as one row per roi: the concatenated
    outputs, each flattened."""
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    return torch.cat([o.float().reshape(o.shape[0], -1) for o in outs], 1)


def det_error(prog, replay, ref_boxes, ref_scores, rois):
    """The worst detection slot: 1.0 where the program's slot and the
    replay's disagree on valid or label; else the larger of the box's
    largest coordinate gap and the score's gap (a probability).  A
    coordinate's gap is measured against the larger of the box's and
    its roi's extent on that axis, so that a gap the head's deltas make
    reads alike on a box the head grew and on one it shrank.  Returns
    (worst, the box part, the score part).

    prog, replay: (dets (M, 7), labels (M,), valid (M,)); ref_boxes
    (M, 6), ref_scores (M,) and rois (M, 6): the reference's values at
    the replayed slots' source rows, and those rows' rois."""
    (pd, pl, pv), (_, rl, rv) = prog, replay
    worst = box = score = 0.0
    if bool((pv != rv).any()) or bool((pl[pv] != rl[pv]).any()):
        worst = 1.0
    both = pv & rv
    if bool(both.any()):
        b, r = ref_boxes[both], rois[both]
        ext = [torch.maximum(b[:, hi] - b[:, lo], r[:, hi] - r[:, lo]) + 1
               for lo, hi in ((0, 2), (1, 3), (4, 5))]
        ext = torch.stack([ext[0], ext[1], ext[0], ext[1], ext[2], ext[2]],
                          1)
        box = float(((pd[both, :6] - b).abs() / ext).max())
        score = float((pd[both, 6] - ref_scores[both]).abs().max())
    return max(worst, box, score), box, score


def replay_mismatch(prog, replay):
    """Slots where the program's detections differ from the replay of
    the class-wise NMS over the program's own scores (a diagnostic,
    printed, not compared: both sides are the program's arithmetic)."""
    (pd, pl, pv), (rd, rl, rv) = prog, replay
    return int(((pv != rv) | (pl != rl) | (pd != rd).any(-1)).sum())


def align(feats, rois, valid, roi_cfg):
    """RoIAlign under an roi extractor config, float32."""
    layer = roi_cfg["roi_layer"]
    strides = roi_cfg["featmap_strides"]
    return ops.roi_align(feats[:len(strides)], rois, valid,
                         layer["out_size"], layer["out_size_depth"],
                         strides, roi_cfg["featmap_strides_depth"],
                         layer["sample_num"])


def codec(head_cfg, default_stds=(1.0,) * 6):
    return (tuple(head_cfg.get("target_means", (0.0,) * 6)),
            tuple(head_cfg.get("target_stds", default_stds)))


def in_chunks(fn, x, rows=256):
    """fn over row chunks of x, concatenated (bounds the float32
    activations of the mask heads)."""
    outs = [fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(t) for t in zip(*outs))
    return torch.cat(outs)
