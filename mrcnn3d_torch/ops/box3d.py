"""6-DoF box geometry and the delta codec (torch).

Same semantics as `mrcnn3d/ops/box3d.py`:
  * "+1 extent" boxes: w = x2 - x1 + 1;
  * z is decoded as (center, log-depth) like x/y;
  * the depth deltas reuse the xy `wh_ratio_clip` clamp.

Boxes are (..., 6) tensors laid out [x1, y1, x2, y2, z1, z2]; deltas
(..., 6) laid out [dx, dy, dw, dh, dz, dd].  The expression order of
every formula follows the JAX version, so float32 results agree.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DELTA_MEANS = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
DELTA_STDS = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def box_volume(boxes):
    """Volume with +1 extents; boxes (..., 6)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    d = boxes[..., 5] - boxes[..., 4] + 1.0
    return w * h * d


def bbox2delta3d(proposals, gt, means=DELTA_MEANS, stds=DELTA_STDS):
    """Encode gt boxes as regression deltas against proposals (the
    inverse of `delta2bbox3d`).  proposals, gt: (..., 6).  Returns
    (..., 6) float32 deltas."""
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    pz = (proposals[..., 4] + proposals[..., 5]) * 0.5
    pd = proposals[..., 5] - proposals[..., 4] + 1.0

    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gz = (gt[..., 4] + gt[..., 5]) * 0.5
    gd = gt[..., 5] - gt[..., 4] + 1.0

    deltas = torch.stack(
        [
            (gx - px) / pw,
            (gy - py) / ph,
            torch.log(gw / pw),
            torch.log(gh / ph),
            (gz - pz) / pd,
            torch.log(gd / pd),
        ],
        dim=-1,
    )
    dev = deltas.device
    means = torch.tensor(means, dtype=torch.float32, device=dev)
    stds = torch.tensor(stds, dtype=torch.float32, device=dev)
    return (deltas - means) / stds


def delta2bbox3d(
    rois,
    deltas,
    means=DELTA_MEANS,
    stds=DELTA_STDS,
    max_shape=None,
    wh_ratio_clip=16.0 / 1000.0,
):
    """Decode regression deltas into boxes.

    rois: (..., 6); deltas: (..., 6*K) for K classes.  Returns (..., 6*K).
    max_shape: (H, W, ?, D) -- x clamped to [0, W-1], y to [0, H-1], z to
    [0, D-1], the reference's img_shape indexing.
    """
    k = deltas.shape[-1] // 6
    dev = deltas.device
    means = torch.tensor(means, dtype=torch.float32, device=dev).repeat(k)
    stds = torch.tensor(stds, dtype=torch.float32, device=dev).repeat(k)
    den = deltas * stds + means
    dx, dy = den[..., 0::6], den[..., 1::6]
    dw, dh = den[..., 2::6], den[..., 3::6]
    dz, dd = den[..., 4::6], den[..., 5::6]

    max_ratio = float(abs(math.log(wh_ratio_clip)))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    dz = dz.clamp(-max_ratio, max_ratio)
    dd = dd.clamp(-max_ratio, max_ratio)

    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pz = ((rois[..., 4] + rois[..., 5]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
    pd = (rois[..., 5] - rois[..., 4] + 1.0)[..., None]

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gd = pd * torch.exp(dd)
    gx = px + pw * dx
    gy = py + ph * dy
    gz = pz + pd * dz

    x1 = gx - gw * 0.5 + 0.5
    y1 = gy - gh * 0.5 + 0.5
    x2 = gx + gw * 0.5 - 0.5
    y2 = gy + gh * 0.5 - 0.5
    z1 = gz - gd * 0.5 + 0.5
    z2 = gz + gd * 0.5 - 0.5

    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1] - 1)
        y1 = y1.clamp(0, max_shape[0] - 1)
        x2 = x2.clamp(0, max_shape[1] - 1)
        y2 = y2.clamp(0, max_shape[0] - 1)
        z1 = z1.clamp(0, max_shape[3] - 1)
        z2 = z2.clamp(0, max_shape[3] - 1)

    out = torch.stack([x1, y1, x2, y2, z1, z2], dim=-1)
    return out.reshape(deltas.shape)


def bbox_overlaps_3d(boxes1, boxes2):
    """Pairwise volume IoU with +1 extents: (m, 6), (n, 6) -> (m, n).

    The expression order is the one the NMS kernel repeats:
    inter / (vol1 + vol2 - inter).
    """
    xa = torch.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    ya = torch.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    xb = torch.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    yb = torch.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    za = torch.maximum(boxes1[:, None, 4], boxes2[None, :, 4])
    zb = torch.minimum(boxes1[:, None, 5], boxes2[None, :, 5])
    inter = (
        (xb - xa + 1.0).clamp(min=0)
        * (yb - ya + 1.0).clamp(min=0)
        * (zb - za + 1.0).clamp(min=0)
    )
    vol1 = box_volume(boxes1)
    vol2 = box_volume(boxes2)
    return inter / (vol1[:, None] + vol2[None, :] - inter)


def clip_boxes(boxes, img_shape):
    """Clip boxes (..., 6) to the volume; img_shape (H, W, C, D), the
    reference layout."""
    h, w, d = img_shape[0], img_shape[1], img_shape[3]
    hi = (w - 1, h - 1, w - 1, h - 1, d - 1, d - 1)
    return torch.stack(
        [boxes[..., i].clamp(0, hi[i]) for i in range(6)], dim=-1
    )


def xyxyzz_to_xywhzd(boxes):
    """The COCO-3D json box [x1, y1, w+1, h+1, z1, d+1] of numpy boxes
    (reference coco_utils.py:233-242 xyxyzz2xywhzd)."""
    boxes = np.asarray(boxes)
    return np.stack(
        [
            boxes[..., 0],
            boxes[..., 1],
            boxes[..., 2] - boxes[..., 0] + 1,
            boxes[..., 3] - boxes[..., 1] + 1,
            boxes[..., 4],
            boxes[..., 5] - boxes[..., 4] + 1,
        ],
        axis=-1,
    )
