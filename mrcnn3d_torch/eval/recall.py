"""Proposal recall evaluation (RPN-only training): the port's copy of
`mrcnn3d/eval/recall.py`.

Equivalent of the reference's recall metrics + CocoDistEvalRecallHook
(mmdet/core/evaluation/recall.py, eval_hooks.py) on 6-DoF boxes: average
recall of top-k proposals at a set of IoU thresholds.
"""
from __future__ import annotations

import numpy as np

from .coco_eval3d import iou3d_xywhzd


def _xyxyzz_to_xywhzd_np(b):
    b = np.asarray(b, np.float32)
    return np.stack(
        [
            b[:, 0],
            b[:, 1],
            b[:, 2] - b[:, 0] + 1,
            b[:, 3] - b[:, 1] + 1,
            b[:, 4],
            b[:, 5] - b[:, 4] + 1,
        ],
        axis=-1,
    )


def eval_recalls_3d(
    gt_boxes_list,
    proposal_list,
    proposal_nums=(100, 300, 1000),
    iou_thrs=(0.5,),
):
    """Recall matrix (len(proposal_nums), len(iou_thrs)).

    gt_boxes_list: per-image (G, 6) xyxyzz arrays.
    proposal_list: per-image (P, >=6) arrays (col 6 = score if present,
    assumed already sorted or sortable by score desc).
    """
    iou_thrs = np.asarray(iou_thrs, np.float64)
    all_ious = []
    for gts, props in zip(gt_boxes_list, proposal_list):
        gts = np.asarray(gts, np.float32).reshape(-1, 6)
        props = np.asarray(props, np.float32)
        if props.shape[1] > 6:
            order = np.argsort(-props[:, 6], kind="stable")
            props = props[order, :6]
        if len(gts) == 0:
            continue
        if len(props) == 0:
            all_ious.append(np.zeros((len(gts), 0)))
            continue
        ious = iou3d_xywhzd(
            _xyxyzz_to_xywhzd_np(gts), _xyxyzz_to_xywhzd_np(props)
        )
        all_ious.append(ious)

    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    for ni, num in enumerate(proposal_nums):
        matched = np.zeros(len(iou_thrs))
        total = 0
        for ious in all_ious:
            total += ious.shape[0]
            if ious.shape[1] == 0:
                continue
            sub = ious[:, :num]
            best = sub.max(axis=1) if sub.size else np.zeros(ious.shape[0])
            for ti, thr in enumerate(iou_thrs):
                matched[ti] += (best >= thr).sum()
        recalls[ni] = matched / max(total, 1)
    return recalls
