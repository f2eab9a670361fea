"""Detection post-processing: batched multi-class NMS (padded shapes).

Port of `mrcnn3d/core/post.py:multiclass_nms_3d` (reference
bbox_nms.py:57-107), with the batch dimension written out: per image and
foreground class -- score threshold, hard NMS -- then the global top
`max_num` by score.  Every (image, class) NMS problem goes through one
K1 launch.
"""
from __future__ import annotations

import torch

from ..ops.nms3d import nms_3d_mask_segments, sort_desc


def multiclass_nms_3d(multi_bboxes, multi_scores, valid, score_thr,
                      iou_thr, max_num):
    """Class-wise NMS over padded detection arrays.

    multi_bboxes (B, N, 6) or (B, N, C*6); multi_scores (B, N, C) softmax
    scores (class 0 = background); valid (B, N) bool.

    Returns dets (B, max_num, 7) [x1, y1, x2, y2, z1, z2, score] (padded
    rows 0), labels (B, max_num) int64 0-based, valid (B, max_num) bool
    and src_idx (B, max_num): the input row of each detection.
    """
    b, n, num_classes = multi_scores.shape
    dev = multi_scores.device
    boxes, scores, sel = [], [], []
    for i in range(1, num_classes):
        scores_i = multi_scores[:, :, i]
        if multi_bboxes.shape[-1] == 6:
            boxes.append(multi_bboxes)
        else:
            boxes.append(multi_bboxes[:, :, i * 6:(i + 1) * 6])
        scores.append(scores_i)
        sel.append(valid & (scores_i > score_thr))
    boxes = torch.cat(boxes, dim=1)  # (B, (C-1)*N, 6), class-major
    scores = torch.cat(scores, dim=1)
    sel = torch.cat(sel, dim=1)
    keep = nms_3d_mask_segments(
        boxes.reshape(-1, 6), scores.reshape(-1), sel.reshape(-1),
        [n] * (b * (num_classes - 1)), iou_thr,
    ).reshape(b, -1)
    labels = torch.arange(num_classes - 1, device=dev).repeat_interleave(n)

    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    top_s, top_i = sort_desc(torch.where(keep, scores, neg_inf))
    k = min(max_num, top_s.shape[1])
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    det_valid = top_s > neg_inf
    det_boxes = torch.gather(boxes, 1, top_i[..., None].expand(b, k, 6))
    det_boxes = torch.where(det_valid[..., None], det_boxes, 0.0)
    det_scores = torch.where(det_valid, top_s, 0.0)
    det_labels = torch.where(det_valid, labels[top_i], 0)
    src_idx = torch.where(det_valid, top_i % n, 0)
    dets = torch.cat([det_boxes, det_scores[..., None]], dim=-1)
    if k < max_num:
        dets, det_labels, det_valid, src_idx = (
            torch.cat([t, t.new_zeros((b, max_num - k) + t.shape[2:])], 1)
            for t in (dets, det_labels, det_valid, src_idx)
        )
    return dets, det_labels, det_valid, src_idx
