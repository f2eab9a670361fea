"""Training CLI on the port (the flags of `tools/train.py`, the reference's).

    python -m mrcnn3d_torch.tools.train configs/mask_rcnn_3d_2scales.py \
        --validate
    python -m mrcnn3d_torch.tools.train configs/mask_rcnn_3d_2scales.py \
        --synthetic --max-iters 50   # smoke run on generated data

Trains on one card (`--device cpu` on the CPU).  --gpus above 1 and a
--launcher are ROADMAP Queue A item 10 and raise.
"""
from __future__ import annotations

import argparse

from .common import add_device_flag, resolve, synthetic_root


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a 3D detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work_dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume_from",
                   help="accepted for reference-CLI parity: training "
                        "resumes from the work dir's newest checkpoint")
    p.add_argument(
        "--validate", action="store_true", help="eval every k epochs"
    )
    p.add_argument("--gpus", type=int, default=1,
                   help="cards to train on (one: several are A10)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--launcher", default="none",
                   help="none (multi-process launchers are A10)")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--max-iters", type=int, default=None,
                   help="stop after N iterations (smoke runs)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated synthetic COCO-3D dataset")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.train_api import MULTI_CARD, train_detector
    from ..data.coco3d import Coco3D2ScalesDataset
    from ..utils.config import Config

    if args.launcher not in ("none", None) or args.gpus > 1:
        raise SystemExit(MULTI_CARD)
    device = resolve(args.device)
    cfg = Config.fromfile(args.config)
    if args.work_dir:
        cfg.work_dir = args.work_dir
    if args.resume_from:
        cfg.resume_from = args.resume_from

    tr = cfg.data["train"]
    max_gt = cfg.get("static_shapes", {}).get("max_gt", 16)
    if args.synthetic:
        from ..data.synthetic import make_synthetic_coco3d

        ann_file, img_dir = make_synthetic_coco3d(
            synthetic_root("train"), num_volumes=8, hw=128, depth=32, seed=0
        )
    else:
        ann_file, img_dir = tr["ann_file"], tr["img_prefix"]

    kwargs = dict(
        img_norm_cfg=tr["img_norm_cfg"],
        size_divisor=tr.get("size_divisor", 32),
        with_mask=tr.get("with_mask", True),
        max_gt=max_gt,
        extra_aug=tr.get("extra_aug"),
        seed=args.seed or 0,
    )
    upscale = cfg.get("upscale_factor", 1.5)
    dataset = Coco3D2ScalesDataset(ann_file, img_dir,
                                   upscale_factor=upscale, **kwargs)

    val_dataset = None
    if args.validate:
        if args.synthetic:
            val_dataset = Coco3D2ScalesDataset(
                ann_file, img_dir, test_mode=True, upscale_factor=upscale,
                **{k: v for k, v in kwargs.items() if k != "extra_aug"},
            )
        else:
            v = cfg.data["val"]
            val_dataset = Coco3D2ScalesDataset(
                v["ann_file"],
                v["img_prefix"],
                img_norm_cfg=v["img_norm_cfg"],
                size_divisor=v.get("size_divisor", 32),
                with_mask=False,
                test_mode=True,
                max_gt=max_gt,
                upscale_factor=upscale,
            )

    train_detector(
        cfg,
        dataset,
        work_dir=cfg.get("work_dir"),
        seed=args.seed or 0,
        validate=args.validate,
        val_dataset=val_dataset,
        max_iters=args.max_iters,
        device=device,
    )


if __name__ == "__main__":
    main()
