"""Qualitative whole-volume evaluation with per-slice overlays, on the port.

Equivalent of the reference's standalone test_images.py: runs two-scale
inference over volumes and writes per-slice PNGs with predicted boxes
(red, scored) and ground-truth boxes (dashed green).  Rendering needs
matplotlib (`apis.inference.show_result_3d` raises without it).

    python -m mrcnn3d_torch.tools.test_images \
        configs/mask_rcnn_3d_2scales.py WORK_DIR --synthetic --out-dir viz/
"""
from __future__ import annotations

import argparse
import os

from .common import add_device_flag, resolve, synthetic_root, test_dataset


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Per-slice detection overlays")
    p.add_argument("config")
    p.add_argument("checkpoint", help="work dir holding the checkpoints")
    p.add_argument("--out-dir", default="viz")
    p.add_argument("--score-thr", type=float, default=0.2)
    p.add_argument("--synthetic", action="store_true")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from ..apis.inference import show_result_3d
    from ..apis.test_api import load_detector, run_inference
    from ..utils.config import Config

    device = resolve(args.device)
    cfg = Config.fromfile(args.config)
    model, _ = load_detector(cfg, args.checkpoint, device)
    te = cfg.data["test"]
    if args.synthetic:
        from ..data.synthetic import make_synthetic_coco3d

        ann_file, img_dir = make_synthetic_coco3d(
            synthetic_root("viz"), num_volumes=2, hw=128, depth=32, seed=11
        )
    else:
        ann_file, img_dir = te["ann_file"], te["img_prefix"]
    dataset = test_dataset(te, ann_file, img_dir)

    results, infos = run_inference(cfg, model, dataset)[:2]
    written = {}
    for per_class, info in zip(results, infos):
        vol = dataset.load_volume(info)
        gt = np.array(
            [
                [
                    a["bbox"][0],
                    a["bbox"][1],
                    a["bbox"][0] + a["bbox"][2] - 1,
                    a["bbox"][1] + a["bbox"][3] - 1,
                    a["bbox"][4],
                    a["bbox"][4] + a["bbox"][5] - 1,
                ]
                for a in dataset.anns_by_img.get(info["id"], [])
            ],
            np.float32,
        )
        out = show_result_3d(
            vol,
            per_class,
            os.path.join(args.out_dir, os.path.splitext(info["file_name"])[0]),
            score_thr=args.score_thr,
            gt_boxes=gt if len(gt) else None,
        )
        written[info["file_name"]] = out
        print(f"{info['file_name']}: wrote {len(out)} slice overlays")
    return written


if __name__ == "__main__":
    main()
