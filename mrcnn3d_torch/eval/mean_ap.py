"""VOC-style mean AP for 6-DoF detections (reference mean_ap.py parity):
the port's copy of `mrcnn3d/eval/mean_ap.py`.

The reference carries the classic VOC evaluation alongside the COCO fork
(mmdet/core/evaluation/mean_ap.py); this is the 3-D equivalent: greedy
per-image matching at a single IoU threshold, 11-point or continuous AP.
"""
from __future__ import annotations

import numpy as np

from .class_names import get_classes
from .coco_eval3d import iou3d_xywhzd


def _to_xywhzd(b):
    b = np.asarray(b, np.float32).reshape(-1, 6)
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


def average_precision(recalls, precisions, mode="area"):
    """AP from a recall/precision curve ('area' = continuous, '11points')."""
    recalls = np.asarray(recalls)
    precisions = np.asarray(precisions)
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    ap = 0.0
    for thr in np.arange(0, 1.1, 0.1):
        p = precisions[recalls >= thr]
        ap += (p.max() if p.size else 0.0) / 11.0
    return float(ap)


def eval_map_3d(det_results, gt_boxes_list, iou_thr=0.5, mode="area"):
    """VOC-style mAP over one class.

    det_results: per-image (n, 7) xyxyzz+score arrays.
    gt_boxes_list: per-image (g, 6) xyxyzz arrays.
    Returns (ap, recall_curve, precision_curve).
    """
    all_scores, all_tp = [], []
    total_gts = 0
    for dets, gts in zip(det_results, gt_boxes_list):
        dets = np.asarray(dets, np.float32).reshape(-1, 7)
        gts = np.asarray(gts, np.float32).reshape(-1, 6)
        total_gts += len(gts)
        if len(dets) == 0:
            continue
        order = np.argsort(-dets[:, 6], kind="stable")
        dets = dets[order]
        matched = np.zeros(len(gts), bool)
        for det in dets:
            all_scores.append(det[6])
            if len(gts) == 0:
                all_tp.append(0)
                continue
            ious = iou3d_xywhzd(
                _to_xywhzd(det[None, :6]), _to_xywhzd(gts)
            )[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not matched[j]:
                matched[j] = True
                all_tp.append(1)
            else:
                all_tp.append(0)
    if not all_scores or total_gts == 0:
        return 0.0, np.zeros(0), np.zeros(0)
    order = np.argsort(-np.asarray(all_scores), kind="stable")
    tp = np.asarray(all_tp)[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1 - tp)
    recalls = tp_cum / total_gts
    precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    return average_precision(recalls, precisions, mode), recalls, precisions


# ---------------------------------------------------------------------------
# multi-class VOC-style mAP (reference mean_ap.py:57-378): per-class
# tp/fp marking with ignore + scale buckets, AP aggregation, summary table
# ---------------------------------------------------------------------------


def _overlaps_np(a, b):
    """Pairwise IoU for corner-format boxes, +1 extents (VOC convention).

    a: (n, 4|6) xyxy / xyxyzz; b: (m, same).  Returns (n, m).
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    lo_idx, hi_idx = _corner_cols(a.shape[-1])
    alo, ahi = a[:, lo_idx], a[:, hi_idx]
    blo, bhi = b[:, lo_idx], b[:, hi_idx]
    lo = np.maximum(alo[:, None], blo[None, :])
    hi = np.minimum(ahi[:, None], bhi[None, :])
    inter = np.prod(np.clip(hi - lo + 1, 0, None), axis=-1)
    va = np.prod(ahi - alo + 1, axis=-1)
    vb = np.prod(bhi - blo + 1, axis=-1)
    return inter / np.maximum(va[:, None] + vb[None, :] - inter, 1e-10)


def _corner_cols(width):
    """Column indices of (lo, hi) corners: xyxy (2-D) or xyxyzz (3-D)."""
    if width >= 6:
        return [0, 1, 4], [2, 3, 5]
    return [0, 1], [2, 3]


def _det_measure(boxes):
    """Area (2-D) or volume (3-D) with +1 extents."""
    boxes = np.asarray(boxes, np.float32)
    lo_idx, hi_idx = _corner_cols(boxes.shape[-1])
    return np.prod(boxes[:, hi_idx] - boxes[:, lo_idx] + 1, axis=-1)


def _empty_gt_fp(dets, area_ranges, num_scales):
    fp = np.zeros((num_scales, dets.shape[0]), np.float32)
    if area_ranges == [(None, None)]:
        fp[...] = 1
    else:
        areas = _det_measure(dets[:, :-1])
        for i, (lo, hi) in enumerate(area_ranges):
            fp[i, (areas >= lo) & (areas < hi)] = 1
    return fp


def tpfp_default(dets, gts, gt_ignore, iou_thr, area_ranges=None):
    """Mark each detection tp/fp per scale bucket (reference
    mean_ap.py:138-201 semantics: argmax-gt greedy match in score order;
    matches to ignored gts count neither way)."""
    dets = np.asarray(dets, np.float32).reshape(-1, dets.shape[-1])
    gts = np.asarray(gts, np.float32).reshape(-1, gts.shape[-1] if gts.size else dets.shape[-1] - 1)
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    num_dets, num_gts = dets.shape[0], gts.shape[0]
    tp = np.zeros((num_scales, num_dets), np.float32)
    fp = np.zeros((num_scales, num_dets), np.float32)
    if num_gts == 0:
        return tp, _empty_gt_fp(dets, area_ranges, num_scales)
    ious = _overlaps_np(dets[:, :-1], gts)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    order = np.argsort(-dets[:, -1], kind="stable")
    gt_areas = _det_measure(gts)
    det_areas = _det_measure(dets[:, :-1])
    gt_ignore = np.asarray(gt_ignore, bool)
    for k, (lo, hi) in enumerate(area_ranges):
        covered = np.zeros(num_gts, bool)
        area_ign = (
            np.zeros(num_gts, bool)
            if lo is None
            else (gt_areas < lo) | (gt_areas >= hi)
        )
        for i in order:
            if ious_max[i] >= iou_thr:
                j = ious_argmax[i]
                if not (gt_ignore[j] or area_ign[j]):
                    if not covered[j]:
                        covered[j] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # ignored gt: neither tp nor fp
            elif lo is None or (det_areas[i] >= lo and det_areas[i] < hi):
                fp[k, i] = 1
    return tp, fp


def tpfp_imagenet(dets, gts, gt_ignore, default_iou_thr, area_ranges=None):
    """ImageNet DET/VID marking (reference mean_ap.py:57-135): per-gt
    size-dependent IoU threshold, best *available* gt (re-matching
    allowed when the argmax gt is taken)."""
    dets = np.asarray(dets, np.float32).reshape(-1, dets.shape[-1])
    gts = np.asarray(gts, np.float32).reshape(-1, gts.shape[-1] if gts.size else dets.shape[-1] - 1)
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    num_dets, num_gts = dets.shape[0], gts.shape[0]
    tp = np.zeros((num_scales, num_dets), np.float32)
    fp = np.zeros((num_scales, num_dets), np.float32)
    if num_gts == 0:
        return tp, _empty_gt_fp(dets, area_ranges, num_scales)
    ious = _overlaps_np(dets[:, :-1], gts - 1)
    lo_idx, hi_idx = _corner_cols(gts.shape[-1])
    ext = gts[:, hi_idx] - gts[:, lo_idx] + 1
    # per-gt threshold shrinks for small boxes (10px slack per axis)
    iou_thrs = np.minimum(
        np.prod(ext, -1) / np.prod(ext + 10.0, -1), default_iou_thr
    )
    order = np.argsort(-dets[:, -1], kind="stable")
    gt_areas = _det_measure(gts)
    det_areas = _det_measure(dets[:, :-1])
    gt_ignore = np.asarray(gt_ignore, bool)
    for k, (lo, hi) in enumerate(area_ranges):
        covered = np.zeros(num_gts, bool)
        area_ign = (
            np.zeros(num_gts, bool)
            if lo is None
            else (gt_areas < lo) | (gt_areas >= hi)
        )
        for i in order:
            cand = np.where(
                ~covered & (ious[i] >= iou_thrs) & (ious[i] > -1)
            )[0]
            if cand.size:
                j = cand[np.argmax(ious[i, cand])]
                covered[j] = True
                if not (gt_ignore[j] or area_ign[j]):
                    tp[k, i] = 1
            elif lo is None or (det_areas[i] >= lo and det_areas[i] < hi):
                fp[k, i] = 1
    return tp, fp


def eval_map(
    det_results,
    gt_bboxes,
    gt_labels,
    gt_ignore=None,
    scale_ranges=None,
    iou_thr=0.5,
    dataset=None,
    print_summary=True,
):
    """Multi-class VOC mAP (reference mean_ap.py:204-330).

    det_results: per-image list of per-class (n, 5|7) det arrays.
    gt_bboxes: per-image (g, 4|6); gt_labels: per-image (g,) 1-based.
    scale_ranges: [(s_min, s_max), ...] — bucketed as s**dim measure
    ranges.  dataset: names for the table; 'voc07' switches to 11-point
    AP; 'det'/'vid' switch to the ImageNet tpfp rule.
    Returns (mean_ap | [per-scale mean_ap], per-class result dicts).
    """
    assert len(det_results) == len(gt_bboxes) == len(gt_labels)
    num_classes = len(det_results[0])
    dim = None
    for per_img in det_results:
        for d in per_img:
            if np.asarray(d).size:
                dim = (np.asarray(d).shape[-1] - 1) // 2
                break
        if dim:
            break
    if dim is None:
        # zero detections anywhere (e.g. an underfit checkpoint):
        # infer the box rank from the gt pool instead of assuming 2-D
        for gb in gt_bboxes:
            if np.asarray(gb).size:
                dim = np.asarray(gb).shape[-1] // 2
                break
    dim = dim or 2
    area_ranges = (
        [(rg[0] ** dim, rg[1] ** dim) for rg in scale_ranges]
        if scale_ranges is not None
        else None
    )
    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    gt_labels = [
        np.asarray(l) if np.asarray(l).ndim == 1 else np.asarray(l)[:, 0]
        for l in gt_labels
    ]
    tpfp_func = tpfp_imagenet if dataset in ("det", "vid") else tpfp_default
    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_ign = [], [], []
        for j in range(len(gt_bboxes)):
            sel = gt_labels[j] == c + 1
            gb = np.asarray(gt_bboxes[j], np.float32).reshape(
                -1, 2 * dim
            )
            cls_dets.append(
                np.asarray(det_results[j][c], np.float32).reshape(
                    -1, 2 * dim + 1
                )
            )
            cls_gts.append(gb[sel] if gb.shape[0] else gb)
            cls_ign.append(
                np.asarray(gt_ignore[j])[sel].astype(np.int32)
                if gt_ignore is not None
                else np.zeros(int(sel.sum()), np.int32)
            )
        pairs = [
            tpfp_func(cls_dets[j], cls_gts[j], cls_ign[j], iou_thr,
                      area_ranges)
            for j in range(len(cls_dets))
        ]
        tp = np.hstack([p[0] for p in pairs])
        fp = np.hstack([p[1] for p in pairs])
        num_gts = np.zeros(num_scales, int)
        for j, gb in enumerate(cls_gts):
            keep = np.logical_not(cls_ign[j].astype(bool))
            if area_ranges is None:
                num_gts[0] += int(keep.sum())
            else:
                areas = _det_measure(gb) if gb.shape[0] else np.zeros(0)
                for k, (lo, hi) in enumerate(area_ranges):
                    num_gts[k] += int(
                        (keep & (areas >= lo) & (areas < hi)).sum()
                    )
        all_dets = np.vstack(cls_dets)
        order = np.argsort(-all_dets[:, -1], kind="stable")
        tp = np.cumsum(tp[:, order], axis=1)
        fp = np.cumsum(fp[:, order], axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        mode = "11points" if dataset == "voc07" else "area"
        if scale_ranges is None:
            r1, p1 = recalls[0], precisions[0]
            ap = average_precision(r1, p1, mode)
            eval_results.append(dict(
                num_gts=int(num_gts[0]), num_dets=int(all_dets.shape[0]),
                recall=r1, precision=p1, ap=ap,
            ))
        else:
            ap = np.array([
                average_precision(recalls[k], precisions[k], mode)
                for k in range(num_scales)
            ])
            eval_results.append(dict(
                num_gts=num_gts, num_dets=int(all_dets.shape[0]),
                recall=recalls, precision=precisions, ap=ap,
            ))
    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in eval_results])
        all_ng = np.vstack([r["num_gts"] for r in eval_results])
        mean_ap_out = [
            float(all_ap[all_ng[:, k] > 0, k].mean())
            if np.any(all_ng[:, k] > 0) else 0.0
            for k in range(num_scales)
        ]
    else:
        aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
        mean_ap_out = float(np.mean(aps)) if aps else 0.0
    if print_summary:
        print_map_summary(mean_ap_out, eval_results, dataset)
    return mean_ap_out, eval_results


def print_map_summary(mean_ap, results, dataset=None):
    """Per-class AP table (reference mean_ap.py:333-378), plain ASCII."""
    num_classes = len(results)
    first_ap = results[0]["ap"]
    num_scales = len(first_ap) if isinstance(first_ap, np.ndarray) else 1
    if dataset is None:
        names = [str(i) for i in range(1, num_classes + 1)]
    else:
        try:
            names = get_classes(dataset)
        except ValueError:
            names = [str(i) for i in range(1, num_classes + 1)]
    if not isinstance(mean_ap, list):
        mean_ap = [mean_ap]
    header = ["class", "gts", "dets", "recall", "precision", "ap"]
    for k in range(num_scales):
        rows = [header]
        for j, r in enumerate(results):
            rec = np.array(r["recall"], ndmin=2)
            pre = np.array(r["precision"], ndmin=2)
            ng = np.array(r["num_gts"], ndmin=1)
            rows.append([
                str(names[j]) if j < len(names) else str(j + 1),
                str(int(ng[min(k, len(ng) - 1)])),
                str(r["num_dets"]),
                f"{rec[min(k, rec.shape[0] - 1), -1]:.3f}"
                if rec.size else "0.000",
                f"{pre[min(k, pre.shape[0] - 1), -1]:.3f}"
                if pre.size else "0.000",
                f"{np.array(r['ap'], ndmin=1)[min(k, num_scales - 1)]:.3f}",
            ])
        rows.append(
            ["mAP", "", "", "", "", f"{mean_ap[k]:.3f}"]
        )
        widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(sep)
        for ri, r in enumerate(rows):
            print(
                "| "
                + " | ".join(v.ljust(w) for v, w in zip(r, widths))
                + " |"
            )
            if ri == 0 or ri == len(rows) - 2:
                print(sep)
        print(sep)
