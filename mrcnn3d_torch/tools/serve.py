"""Serving CLI on the port: a resident detector over a directory.

    python -m mrcnn3d_torch.tools.serve CONFIG WORK_DIR --in-dir volumes/ \
        --out-dir results/ [--once]

Keeps the built detector and its anchor sets resident across volumes
(cached per shape) and overlaps host IO with the card's compute.
`--once` processes the current directory contents and exits; the
default watches for new volumes forever.  The detector runs in bfloat16
(the JAX serving tool's dtype) unless --dtype float32.
"""
from __future__ import annotations

import argparse
import os

from .common import add_device_flag, resolve


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve a 3D detector")
    p.add_argument("config")
    p.add_argument("checkpoint", help="work dir holding the checkpoints")
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--once", action="store_true")
    p.add_argument("--score-thr", type=float, default=0.05)
    p.add_argument("--poll-s", type=float, default=1.0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..apis.inference import DEFAULT_NORM
    from ..apis.serve import watch
    from ..apis.test_api import InferenceRunner, load_detector
    from ..utils.config import Config

    device = resolve(args.device)
    cfg = Config.fromfile(args.config)
    model, step = load_detector(cfg, args.checkpoint, device,
                                getattr(torch, args.dtype))
    if step is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint}")
    runner = InferenceRunner(cfg, model)

    norm = cfg.data["test"]["img_norm_cfg"] if "data" in cfg else \
        DEFAULT_NORM
    n_before = len(
        [f for f in os.listdir(args.in_dir) if f.endswith(".npy")]
    )
    watch(
        runner,
        args.in_dir,
        args.out_dir,
        norm,
        size_divisor=cfg.data.get("size_divisor", 32)
        if "data" in cfg else 32,
        num_classes=model.num_classes,
        poll_s=args.poll_s,
        stop_after=n_before if args.once else None,
        score_thr=args.score_thr,
    )


if __name__ == "__main__":
    main()
