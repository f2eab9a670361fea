"""Training CLI on the port (the flags of `tools/train.py`, the reference's).

    python -m mrcnn3d_torch.tools.train configs/mask_rcnn_3d_2scales.py \
        --validate
    python -m mrcnn3d_torch.tools.train configs/mask_rcnn_3d_2scales.py \
        --synthetic --max-iters 50   # smoke run on generated data

    torchrun --nproc_per_node=N -m mrcnn3d_torch.tools.train \
        configs/mask_rcnn_3d_2scales.py --launcher pytorch

One process drives one card (`--device cpu` the CPU).  Under torchrun
(or `mrcnn3d_torch/tools/dist_train.sh`) with --launcher pytorch the N
processes train data-parallel: NCCL on the cards, gloo on the CPU.
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
                   help="cards to train on: one a process, so more than "
                        "one needs torchrun and --launcher pytorch")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--launcher", default="none",
                   choices=("none", "pytorch"),
                   help="pytorch: join torchrun's process group")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--max-iters", type=int, default=None,
                   help="stop after N iterations (smoke runs)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a generated synthetic COCO-3D dataset")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.train_api import train_detector
    from ..data.coco3d import Coco3DDataset
    from ..utils.config import Config
    from .common import train_dataset_class

    rank, world = 0, 1
    if args.launcher == "pytorch":
        from ..parallel.mesh import init_dist

        try:
            rank, world, device = init_dist(
                "pytorch", device=None if args.device == "cuda"
                else args.device)
        except RuntimeError as e:
            raise SystemExit(f"tools.train: {e}") from e
    elif args.gpus > 1:
        raise SystemExit(
            f"tools.train: --gpus {args.gpus} needs one process a card: "
            f"torchrun --nproc_per_node={args.gpus} -m "
            "mrcnn3d_torch.tools.train CONFIG --launcher pytorch "
            "(mrcnn3d_torch/tools/dist_train.sh)")
    else:
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

        # one copy a rank: ranks that wrote one set would race
        ann_file, img_dir = make_synthetic_coco3d(
            synthetic_root("train" if world == 1 else f"train_rank{rank}"),
            num_volumes=8, hw=128, depth=32, seed=0)
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
    # the dataset by the type's scale count; single-scale sets take no
    # upscale factor
    ds_cls = train_dataset_class(cfg)
    scale_kw = {}
    if ds_cls is not Coco3DDataset:
        scale_kw["upscale_factor"] = cfg.get("upscale_factor", 1.5)
    dataset = ds_cls(ann_file, img_dir, **kwargs, **scale_kw)

    val_dataset = None
    if args.validate:
        if args.synthetic:
            val_dataset = ds_cls(
                ann_file, img_dir, test_mode=True, **scale_kw,
                **{k: v for k, v in kwargs.items() if k != "extra_aug"},
            )
        else:
            v = cfg.data["val"]
            val_dataset = ds_cls(
                v["ann_file"],
                v["img_prefix"],
                img_norm_cfg=v["img_norm_cfg"],
                size_divisor=v.get("size_divisor", 32),
                with_mask=False,
                test_mode=True,
                max_gt=max_gt,
                **scale_kw,
            )

    train_detector(
        cfg,
        dataset,
        work_dir=cfg.get("work_dir"),
        seed=args.seed or 0,
        validate=args.validate,
        val_dataset=val_dataset,
        max_iters=args.max_iters,
        mesh="auto",
        device=device,
    )
    if args.launcher == "pytorch":
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
