"""Standalone 3-D COCO evaluation of saved results (the reference's
tools/coco_eval.py, and the JAX package's), on the port's evaluator.

    python -m mrcnn3d_torch.tools.coco_eval results.pkl gt_annotations.json
    python -m mrcnn3d_torch.tools.coco_eval results.json gt_annotations.json
"""
from __future__ import annotations

import argparse
import json
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Score saved 3-D detections")
    p.add_argument("results", nargs="+",
                   help="one or more results pickles (per-image per-class "
                        "arrays) or COCO dt jsons; multiple files are "
                        "merged before the global NMS (reference "
                        "results2json3DMulti)")
    p.add_argument("ann_file", help="ground-truth COCO-3D json")
    p.add_argument("--no-merge", action="store_true",
                   help="skip the patch-merge NMS")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..eval.coco_eval3d import CocoEval3D
    from ..eval.results import merge_patch_detections, results2json3d

    with open(args.ann_file) as f:
        gt = json.load(f)
    entries = []
    for path in args.results:
        if path.endswith(".json"):
            with open(path) as f:
                entries.extend(json.load(f))
        else:
            with open(path, "rb") as f:
                results = pickle.load(f)
            infos = gt["images"][: len(results)]
            entries.extend(results2json3d(results, infos, merge=False))
    if not args.no_merge:
        entries = merge_patch_detections(entries)

    evaluator = CocoEval3D(gt, entries)
    stats = evaluator.named_stats()
    for k, v in stats.items():
        print(f"{k}: {v:.4f}")
    return stats


if __name__ == "__main__":
    main()
