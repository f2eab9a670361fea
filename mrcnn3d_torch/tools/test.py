"""Offline test/eval CLI on the port (the flags of `tools/test.py`).

    python -m mrcnn3d_torch.tools.test configs/mask_rcnn_3d_2scales.py \
        WORK_DIR --out results.pkl --eval bbox

WORK_DIR holds the checkpoints (`train/checkpoint.py`); its newest is
loaded.  When the config carries a `data2` block (the dual-resolution
offline protocol, reference tools/test.py:38-73 `double_test`), or with
--double, a second pass runs over the 1.5x test set with `test_cfg2`,
and both result sets are merged via the results2json3DMulti path
(coco_utils.py:480-574) before the global NMS and a single evaluation
against the 1.0x ground truth.
"""
from __future__ import annotations

import argparse
import copy
import pickle

from .common import add_device_flag, resolve, synthetic_root, test_dataset


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a 3D detector")
    p.add_argument("config")
    p.add_argument("checkpoint", help="work dir holding the checkpoints")
    p.add_argument("--out", help="output result pickle")
    p.add_argument("--eval", nargs="+", default=["bbox"],
                   choices=["bbox", "segm"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--gpu_collect", action="store_true",
                   help="accepted for reference-CLI parity")
    p.add_argument(
        "--double",
        action="store_true",
        help="force the dual-dataset double_test protocol (implied when "
        "the config has a data2 block; with --synthetic, pass 2 runs a "
        "1.5x twin of the synthetic set)",
    )
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.test_api import load_detector, run_inference
    from ..eval.coco_eval3d import CocoEval3D
    from ..eval.masks import segm_entries
    from ..eval.results import results2json3d, results2json3d_multi
    from ..utils.config import Config

    device = resolve(args.device)
    cfg = Config.fromfile(args.config)
    if "segm" in args.eval:
        # the mask path only runs when bbox-only mode is off
        cfg.test_cfg["return_bbox_only"] = False
    model, step = load_detector(cfg, args.checkpoint, device)
    if step is None:
        print("WARNING: no checkpoint found, using random init")
    else:
        print(f"loaded checkpoint at step {step}")

    te = cfg.data["test"]
    if args.synthetic:
        from ..data.synthetic import make_synthetic_coco3d

        root = synthetic_root("test")
        ann_file, img_dir = make_synthetic_coco3d(
            root, num_volumes=4, hw=128, depth=32, seed=7
        )
    else:
        ann_file, img_dir = te["ann_file"], te["img_prefix"]
    dataset = test_dataset(te, ann_file, img_dir)

    out = run_inference(cfg, model, dataset)
    results, infos = out[0], out[1]
    segms = out[2] if len(out) > 2 else None

    # double_test: second pass over the 1.5x dataset with test_cfg2
    # (reference tools/test.py:38-73,123-139)
    results2 = infos2 = None
    # reference cfg names the twin block `data2_2scales` and aliases it
    # as cfg.data2 (configs/3d-multi-resolution-rcnn.py:149,204)
    data2_cfg = cfg.get("data2", None) or cfg.get("data2_2scales", None)
    use_double = args.double or data2_cfg is not None
    scale2 = 1.0 / cfg.get("upscale_factor", 1.5)
    if use_double:
        if args.synthetic:
            from ..data.synthetic import make_synthetic_coco3d_scaled

            ann2, img_dir2 = make_synthetic_coco3d_scaled(
                ann_file, img_dir, root + "_1dot5x", 1.0 / scale2
            )
            te2 = te
        else:
            if data2_cfg is None:
                raise SystemExit(
                    "--double needs a data2/data2_2scales config block"
                )
            te2 = data2_cfg["test"]
            ann2, img_dir2 = te2["ann_file"], te2["img_prefix"]
        dataset2 = test_dataset(te2, ann2, img_dir2)
        cfg2 = copy.deepcopy(cfg)
        cfg2["test_cfg"] = cfg2.get("test_cfg2", cfg2["test_cfg"])
        results2, infos2 = run_inference(cfg2, model, dataset2)[:2]

    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(
                results if results2 is None else results + results2, f
            )

    if "bbox" in args.eval:
        if results2 is not None:
            entries = results2json3d_multi(
                results, infos, results2, infos2, scale2=scale2
            )
        else:
            entries = results2json3d(results, infos)
        evaluator = CocoEval3D(dataset.coco, entries)
        for k, v in evaluator.named_stats().items():
            print(f"{k}: {v:.4f}")
    if "segm" in args.eval and segms is not None:
        entries = []
        for cls_segms, per_class, info in zip(segms, results, infos):
            entries.extend(segm_entries(cls_segms, per_class, info))
        evaluator = CocoEval3D(dataset.coco, entries, iou_type="segm")
        for k, v in evaluator.named_stats(prefix="segm").items():
            print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
