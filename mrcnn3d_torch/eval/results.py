"""Detection-result json assembly: patch->volume translation and the
global merge.

The port's copy of `mrcnn3d/eval/results.py`, a port of reference
mmdet/core/evaluation/coco_utils.py:
  * det2json3D (:334-370): per-class dets -> COCO xywhzd entries, with
    patch->full-volume coordinate translation via img_info pos_top /
    pos_left / pos_front offsets
  * apply_nms (:306-332): per-volume greedy merge of overlapping patch
    predictions with the asymmetric-overlap NMS at thr 0.1 (the port's
    `native.nms3d_overlap`)
  * results2json3DMulti (:480-574): merge of two-dataset (dual
    resolution) outputs before the global NMS
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from .. import native
from ..ops.box3d import xyxyzz_to_xywhzd

MERGE_NMS_THR = 0.1


def det_entries(per_class_dets, img_info, cat_ids=None, coord_scale=1.0):
    """Per-class (n, 7) xyxyzz+score arrays -> COCO dt dicts (global coords).

    img_info may carry pos_top/pos_left/pos_front patch offsets and a
    full_volume_id; falls back to its own id. coord_scale maps the
    translated boxes into the evaluation frame (e.g. 1/1.5 for a
    1.5x-resolution dataset evaluated against 1.0x ground truth).
    """
    top = img_info.get("pos_top", 0)
    left = img_info.get("pos_left", 0)
    front = img_info.get("pos_front", 0)
    image_id = img_info.get("full_volume_id", img_info["id"])
    out = []
    for label, dets in enumerate(per_class_dets):
        dets = np.asarray(dets)
        if dets.size == 0:
            continue
        boxes = dets[:, :6] + np.array(
            [left, top, left, top, front, front], np.float32
        )
        if coord_scale != 1.0:
            boxes = boxes * coord_scale
        xywhzd = xyxyzz_to_xywhzd(boxes)
        cat = cat_ids[label] if cat_ids else label + 1
        for b, score in zip(xywhzd, dets[:, 6]):
            out.append(
                dict(
                    image_id=int(image_id),
                    category_id=int(cat),
                    bbox=[float(v) for v in b],
                    score=float(score),
                )
            )
    return out


def merge_patch_detections(entries, nms_thr=MERGE_NMS_THR):
    """Global per-volume NMS merge (reference apply_nms :306-332)."""
    by_img = defaultdict(list)
    for e in entries:
        by_img[(e["image_id"], e["category_id"])].append(e)
    merged = []
    for es in by_img.values():
        dets = np.array(
            [
                [
                    e["bbox"][0],
                    e["bbox"][1],
                    e["bbox"][0] + e["bbox"][2] - 1,
                    e["bbox"][1] + e["bbox"][3] - 1,
                    e["bbox"][4],
                    e["bbox"][4] + e["bbox"][5] - 1,
                    e["score"],
                ]
                for e in es
            ],
            np.float32,
        )
        keep = native.nms3d_overlap(dets, nms_thr)
        merged.extend(es[i] for i in keep)
    return merged


def results2json3d(all_results, img_infos, merge=True):
    """Full pipeline: list of per-image per-class det lists -> dt dicts."""
    entries = []
    for per_class, info in zip(all_results, img_infos):
        entries.extend(det_entries(per_class, info))
    if merge:
        entries = merge_patch_detections(entries)
    return entries


def results2json3d_multi(
    results1, infos1, results2, infos2, scale2=1.0 / 1.5, merge=True
):
    """Dual-dataset (`double_test`) result merge (reference
    results2json3DMulti, coco_utils.py:480-574 + det2json3DMulti).

    Pass 1 is the native-resolution test set, pass 2 the upscaled
    (1.5x) set; both are translated to full-volume coordinates, the
    second mapped back into the 1.0x evaluation frame, then merged with
    the same global apply_nms used for patch merging (:306-332).

    Two deliberate deviations from the reference code, as in the JAX
    package: pass-2 results are the second pass's own outputs (the
    reference's det2json3DMulti iterates `results[idx]` for dataset2,
    coco_utils.py:509), and they are rescaled by `scale2` into the 1.0x
    gt frame (the reference never rescales them).  results2=None scores
    pass 1 alone.
    """
    entries = []
    for per_class, info in zip(results1, infos1):
        entries.extend(det_entries(per_class, info))
    if results2 is not None:
        for per_class, info in zip(results2, infos2):
            entries.extend(
                det_entries(per_class, info, coord_scale=scale2)
            )
    if merge:
        entries = merge_patch_detections(entries)
    return entries
