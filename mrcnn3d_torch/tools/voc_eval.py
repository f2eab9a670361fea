"""VOC-style mean-AP evaluation of saved results on the port's evaluator
(reference tools/voc_eval.py; the JAX package's tools/voc_eval.py:23-98).

    python -m mrcnn3d_torch.tools.voc_eval results.pkl <ann_list> <voc_root> [--iou-thr 0.5]

`results.pkl` holds per-image per-class detection lists (what
`mrcnn3d_torch.tools.test --out` writes; 7-wide xyxyzz+score rows of the
depth-1 pipeline are cut to VOC's x1, y1, x2, y2, score); the ground
truth is read from the VOC XML tree by VOCDataset, its difficult boxes
joining the gt pool flagged ignored.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VOC mean AP of saved results")
    p.add_argument("result_file")
    p.add_argument("ann_list")
    p.add_argument("voc_root")
    p.add_argument("--iou-thr", type=float, default=0.5)
    return p.parse_args(argv)


def voc_gt(ds):
    """(gt boxes, gt labels, gt ignore flags or None) per image of a
    VOCDataset: the difficult boxes appended to each image's pool with
    ignore flag 1 (reference tools/voc_eval.py:26-35)."""
    gt_bboxes, gt_labels, gt_ignore = [], [], None
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        bboxes, labels = ann["bboxes"], ann["labels"]
        if len(ann["bboxes_ignore"]):
            if gt_ignore is None:
                gt_ignore = [np.zeros(len(b), np.int32) for b in gt_bboxes]
            gt_ignore.append(np.concatenate([
                np.zeros(len(bboxes), np.int32),
                np.ones(len(ann["bboxes_ignore"]), np.int32)]))
            bboxes = np.vstack([bboxes, ann["bboxes_ignore"]])
            labels = np.concatenate([labels, ann["labels_ignore"]])
        elif gt_ignore is not None:
            gt_ignore.append(np.zeros(len(bboxes), np.int32))
        gt_bboxes.append(bboxes)
        gt_labels.append(labels)
    return gt_bboxes, gt_labels, gt_ignore


def to_2d(d):
    """A class's detections as (n, 5) x1, y1, x2, y2, score (7-wide
    depth-1 rows drop their z columns)."""
    d = np.asarray(d, np.float32)
    if d.ndim == 2 and d.shape[-1] == 7:
        return d[:, [0, 1, 2, 3, 6]]
    return d.reshape(-1, 5)


def main(argv=None):
    args = parse_args(argv)
    from ..data.legacy2d import VOCDataset
    from ..eval.mean_ap import eval_map

    norm = dict(mean=[0, 0, 0], std=[1, 1, 1], to_rgb=True)
    ds = VOCDataset(args.ann_list, args.voc_root, norm)
    with open(args.result_file, "rb") as f:
        det_results = pickle.load(f)
    gt_bboxes, gt_labels, gt_ignore = voc_gt(ds)
    det_results = [[to_2d(d) for d in per_img] for per_img in det_results]
    dataset_name = "voc07" if "VOC2007" in args.ann_list else "voc"
    mean_ap, results = eval_map(
        det_results, gt_bboxes, gt_labels, gt_ignore=gt_ignore,
        iou_thr=args.iou_thr, dataset=dataset_name, print_summary=True)
    # the per-class lines of the original tool
    for name, r in zip(VOCDataset.CLASSES, results):
        ap = float(np.array(r["ap"], ndmin=1)[0])
        print(f"{name:16s} AP@{args.iou_thr}: {ap:.4f}")
    print(f"{'mAP':16s}: {float(np.mean([mean_ap])):.4f}")
    return mean_ap, results


if __name__ == "__main__":
    main()
