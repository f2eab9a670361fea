"""Mask post-processing: paste predicted voxel masks into full volumes.

The port's copy of `mrcnn3d/eval/masks.py`, a port of reference
FCNMaskHead3D.get_seg_masks (mmdet/models/mask_heads/fcn_mask_head_3d.py
:126-191): per detection, sigmoid mask logits for the predicted class
are trilinearly resized from (mask_d, mask_h, mask_w) to the integer box
extents, thresholded at mask_thr_binary (0.25), and pasted into a zeroed
(D, H, W) volume.  Host-side numpy, through the port's own
`native.resize_trilinear`.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..ops.box3d import xyxyzz_to_xywhzd


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _trilinear_resize(vol, out_shape):
    return native.resize_trilinear(
        np.ascontiguousarray(vol, np.float32)[..., None], *out_shape
    )[..., 0]


def box_extent(box):
    """(d, h, w) of an int [x0, y0, x1, y1, z0, z1] box, +1 extents, at
    least 1."""
    w = max(int(box[2]) - int(box[0]) + 1, 1)
    h = max(int(box[3]) - int(box[1]) + 1, 1)
    d = max(int(box[5]) - int(box[4]) + 1, 1)
    return d, h, w


def box_mask_from_probs(probs, box, mask_thr_binary=0.25):
    """Resize one detection's (Dm, Hm, Wm) mask PROBS to its integer box
    extents and threshold: the per-detection tail of get_box_masks_3d,
    split out so that callers that merge-NMS first (apis/tiled.py) resize
    the surviving detections only.

    box: int [x0, y0, x1, y1, z0, z1]. Returns (d, h, w) uint8.
    """
    return (
        _trilinear_resize(probs, box_extent(box)) > mask_thr_binary
    ).astype(np.uint8)


def get_box_masks_3d(
    mask_logits,
    det_bboxes,
    det_labels,
    det_valid,
    mask_thr_binary=0.25,
    scale_factor=1.0,
):
    """Per-detection box-extent masks (no full-volume paste).

    Same resize+threshold semantics as the reference get_seg_masks
    (fcn_mask_head_3d.py:126-191) but stops before the paste, returning
    for each valid detection i a dict with:
      label: 1-based class id
      box:   int32 [x0, y0, x1, y1, z0, z1] in the (scaled) output frame
      mask:  (d, h, w) uint8, d/h/w = +1 box extents
    mask_logits is (N, C, Dm, Hm, Wm), or (N, Dm, Hm, Wm) when the
    predicted class's slice was gathered already.
    """
    probs = _sigmoid(np.asarray(mask_logits, np.float32))
    preselected = probs.ndim == 4
    boxes = np.asarray(det_bboxes)[:, :6]
    labels = np.asarray(det_labels) + 1
    valid = np.asarray(det_valid).astype(bool)

    out = []
    for i in range(boxes.shape[0]):
        if not valid[i]:
            continue
        bbox = (boxes[i] / scale_factor).astype(np.int32)
        label = int(labels[i])
        mask = probs[i] if preselected else probs[i, label]
        bbox_mask = (
            _trilinear_resize(mask, box_extent(bbox)) > mask_thr_binary
        ).astype(np.uint8)
        out.append(dict(index=i, label=label,
                        box=bbox.astype(np.int32), mask=bbox_mask))
    return out


def paste_mask_3d(box, mask, vol_shape):
    """Paste one box-extent mask into a zeroed (D, H, W) uint8 volume.

    box: int [x0, y0, x1, y1, z0, z1]; paste region clamped to extents
    (reference fcn_mask_head_3d.py paste semantics).
    """
    img_d, img_h, img_w = vol_shape
    x0 = max(int(box[0]), 0)
    y0 = max(int(box[1]), 0)
    z0 = max(int(box[4]), 0)
    d, h, w = mask.shape
    im_mask = np.zeros((img_d, img_h, img_w), np.uint8)
    z1 = min(z0 + d, img_d)
    y1 = min(y0 + h, img_h)
    x1 = min(x0 + w, img_w)
    if z1 > z0 and y1 > y0 and x1 > x0:
        im_mask[z0:z1, y0:y1, x0:x1] = mask[
            : z1 - z0, : y1 - y0, : x1 - x0
        ]
    return im_mask


def get_seg_masks_3d(
    mask_logits,
    det_bboxes,
    det_labels,
    det_valid,
    num_classes,
    ori_shape,
    mask_thr_binary=0.25,
    scale_factor=1.0,
):
    """mask_logits (N, C, Dm, Hm, Wm); det boxes (N, >=6) in final frame.

    ori_shape: (H, W, D) of the output volume.
    Returns per-class lists of (D, H, W) uint8 volumes (classes 1..C-1).
    """
    img_h, img_w, img_d = ori_shape[0], ori_shape[1], ori_shape[2]
    cls_segms = [[] for _ in range(num_classes - 1)]
    for bm in get_box_masks_3d(
        mask_logits, det_bboxes, det_labels, det_valid,
        mask_thr_binary, scale_factor,
    ):
        cls_segms[bm["label"] - 1].append(
            paste_mask_3d(bm["box"], bm["mask"], (img_d, img_h, img_w))
        )
    return cls_segms


def segm_entries(cls_segms, per_class_dets, img_info, cat_ids=None):
    """Build segm dt dicts (with full-volume masks) for voxel evaluation.

    Mirrors reference segm2json3D (coco_utils.py:416-477) but keeps masks
    as arrays (the evaluator consumes volumes directly).
    """
    image_id = img_info.get("full_volume_id", img_info["id"])
    out = []
    for label, (segms, dets) in enumerate(zip(cls_segms, per_class_dets)):
        dets = np.asarray(dets)
        cat = cat_ids[label] if cat_ids else label + 1
        for mask, det in zip(segms, dets):
            out.append(
                dict(
                    image_id=int(image_id),
                    category_id=int(cat),
                    bbox=[float(v) for v in xyxyzz_to_xywhzd(det[:6])],
                    score=float(det[6]),
                    segmentation=mask,
                )
            )
    return out
