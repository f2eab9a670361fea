"""Pinned learning benchmark on the port: frozen seed, data hash, band.

Counterpart of `tools/learning_bench.py`, with every constant that
affects the score kept (data seeds 123 / 321, 256^2 x 48 volumes, 12
train / 4 val, lesions 3-6, train seed 2024, 1600 iterations through
configs/mask_rcnn_3d_2scales.py) and the same path-independent content
hash of the generated data (`sha256_paths`):

  * data: the port's `make_synthetic_coco3d` train / val sets and the
    materialised 1.5x val twin, byte for byte the JAX package's;
  * training: `apis.train_api.train_detector`, float32 parameters and
    compute (TF32 off), on one card, as the JAX protocol trains;
  * eval: the double_test protocol (pass 1 on the 1.0x val set, pass 2
    on the 1.5x twin with test_cfg2, global 0.1-IoU merge, 29-stat 3-D
    COCO summary against the 1.0x gt), the single-pass stats, a segm pass
    from the 1.0x detections, the mask-quality oracle and where its best
    masks sit (`mask_placement`).

    python -m mrcnn3d_torch.tools.learning_bench [--iters 1600]
        [--workdir DIR] [--skip-train] [--train-seed N] [--json-out PATH]
        [--device cuda|cpu]

The artifact goes to --json-out (default <workdir>/LEARNING_torch.json).
`--synthetic` swaps the pinned data for a small generated set (a smoke
run of the same code: its hash is not the pinned one) and `--config`
another config, for tests.
"""
from __future__ import annotations

import argparse
import copy
import glob
import hashlib
import json
import os
import time

import numpy as np

# ---- pinned protocol constants ----
DATA_SEED_TRAIN = 123
DATA_SEED_VAL = 321
TRAIN_SEED = 2024
HW, DEPTH = 256, 48
TRAIN_VOLUMES, VAL_VOLUMES = 12, 4
LESIONS = (3, 7)
PINNED_SHA256 = \
    "0e443db0f4c7a46a99763cac637a7a3e88f971933a31fcfec4c03e4f260c50c4"
# the smoke set of --synthetic: (hw, depth, train volumes, val volumes)
SYNTHETIC = (96, 16, 2, 1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "mask_rcnn_3d_2scales.py")


def sha256_paths(paths):
    """Content hash that is independent of WHERE the data was written:
    the generator embeds absolute segmentation paths in the annotation
    json, so json values that are paths are reduced to basenames before
    hashing (otherwise the pinned hash would change with --workdir)."""

    def canon(v):
        if isinstance(v, str) and "/" in v:
            return os.path.basename(v)
        if isinstance(v, dict):
            return {k: canon(x) for k, x in sorted(v.items())}
        if isinstance(v, list):
            return [canon(x) for x in v]
        return v

    h = hashlib.sha256()
    for p in sorted(paths, key=os.path.basename):
        h.update(os.path.basename(p).encode())
        if p.endswith(".json"):
            with open(p) as f:
                blob = json.dumps(canon(json.load(f)), sort_keys=True).encode()
        else:
            with open(p, "rb") as f:
                blob = f.read()
        h.update(hashlib.sha256(blob).digest())
    return h.hexdigest()


def generate_pinned_data(workdir, upscale_factor=1.5, geometry=None):
    """Generate the pinned train/val/1.5x-twin datasets and return
    (data_hash, ann_tr, dir_tr, ann_va, dir_va, ann_va2, dir_va2).

    geometry: (hw, depth, train volumes, val volumes) in place of the
    pinned one (the --synthetic smoke set)."""
    from ..data.synthetic import (
        make_synthetic_coco3d,
        make_synthetic_coco3d_scaled,
    )

    hw, depth, n_train, n_val = geometry or (HW, DEPTH, TRAIN_VOLUMES,
                                             VAL_VOLUMES)
    train_root = os.path.join(workdir, "train_data")
    val_root = os.path.join(workdir, "val_data")
    ann_tr, dir_tr = make_synthetic_coco3d(
        train_root, num_volumes=n_train, hw=hw, depth=depth,
        lesions_per_volume=LESIONS, seed=DATA_SEED_TRAIN,
    )
    ann_va, dir_va = make_synthetic_coco3d(
        val_root, num_volumes=n_val, hw=hw, depth=depth,
        lesions_per_volume=LESIONS, seed=DATA_SEED_VAL,
    )
    ann_va2, dir_va2 = make_synthetic_coco3d_scaled(
        ann_va, dir_va, val_root + "_1dot5x", upscale_factor
    )
    # everything the protocol consumes, the 1.5x val twin included
    data_hash = sha256_paths(
        [ann_tr, ann_va, ann_va2]
        + glob.glob(os.path.join(dir_tr, "*.npy"))
        + glob.glob(os.path.join(dir_va, "*.npy"))
        + glob.glob(os.path.join(dir_va2, "*.npy"))
    )
    return data_hash, ann_tr, dir_tr, ann_va, dir_va, ann_va2, dir_va2


def train_dataset(cfg, ann_tr, dir_tr, seed):
    """The protocol's training set: crops from `seed`'s RandomState."""
    from ..data.coco3d import Coco3D2ScalesDataset

    tr = cfg.data["train"]
    return Coco3D2ScalesDataset(
        ann_tr, dir_tr,
        upscale_factor=cfg.get("upscale_factor", 1.5),
        img_norm_cfg=tr["img_norm_cfg"],
        size_divisor=tr.get("size_divisor", 32),
        with_mask=True,
        max_gt=cfg.get("static_shapes", {}).get("max_gt", 16),
        extra_aug=tr.get("extra_aug"),
        seed=seed,
    )


def round_stats(stats):
    return {k: round(float(v), 4) for k, v in stats.items()}


def mask_quality(seg_ev):
    """The mask-quality oracle: the distribution of each gt's best voxel
    IoU (`CocoEval3D.best_overlaps`)."""
    best = np.array([v["iou"] for v in seg_ev.best_overlaps.values()], float)
    if not best.size:
        return {}
    return dict(
        n_gt=int(best.size),
        mean=round(float(best.mean()), 4),
        median=round(float(np.median(best)), 4),
        p10=round(float(np.percentile(best, 10)), 4),
        p90=round(float(np.percentile(best, 90)), 4),
        frac_ge_50=round(float((best >= 0.5).mean()), 4),
        frac_ge_70=round(float((best >= 0.7).mean()), 4),
    )


def evaluate_protocol(cfg, model, ann_va, dir_va, ann_va2, dir_va2,
                      timers=None, passes=None):
    """The double_test + segm evaluation (`tools/learning_bench.py:
    218-274`) of `model`: (stats, stats_single_pass, segm_stats,
    mask_quality), raw floats.  timers: optional dict, given each pass's
    seconds.  passes: optional dict, given pass 1's `run_inference`
    output ("pass1": results, infos, segms), pass 2's ("pass2": results,
    infos) and the segm evaluator of pass 1's masks ("segm_eval")."""
    from ..apis.test_api import run_inference
    from ..data.coco3d import Coco3D2ScalesDataset
    from ..eval.coco_eval3d import CocoEval3D
    from ..eval.masks import segm_entries
    from ..eval.results import results2json3d_multi

    timers = {} if timers is None else timers
    scfg = copy.deepcopy(cfg)
    scfg.test_cfg["return_bbox_only"] = False  # mask path for segm
    te = cfg.data["test"]
    mk = dict(
        img_norm_cfg=te["img_norm_cfg"],
        size_divisor=te.get("size_divisor", 32),
        with_mask=False,
        test_mode=True,
    )
    ds1 = Coco3D2ScalesDataset(ann_va, dir_va, **mk)
    ds2 = Coco3D2ScalesDataset(ann_va2, dir_va2, **mk)
    t = time.perf_counter()
    results1, infos1, segms = run_inference(scfg, model, ds1, progress=False)
    timers["pass1_s"] = time.perf_counter() - t
    cfg2 = copy.deepcopy(cfg)
    cfg2["test_cfg"] = cfg2.get("test_cfg2", cfg2["test_cfg"])
    t = time.perf_counter()
    results2, infos2 = run_inference(cfg2, model, ds2, progress=False)[:2]
    timers["pass2_s"] = time.perf_counter() - t

    t = time.perf_counter()
    scale2 = 1.0 / cfg.get("upscale_factor", 1.5)
    entries = results2json3d_multi(
        results1, infos1, results2, infos2, scale2=scale2
    )
    stats = CocoEval3D(ds1.coco, entries).named_stats()
    entries1 = results2json3d_multi(
        results1, infos1, None, None, scale2=scale2
    )
    stats_single = CocoEval3D(ds1.coco, entries1).named_stats()
    timers["bbox_eval_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sentries = []
    for cls_segms, per_class, info in zip(segms, results1, infos1):
        sentries.extend(segm_entries(cls_segms, per_class, info))
    seg_ev = CocoEval3D(ds1.coco, sentries, iou_type="segm")
    seg_stats = seg_ev.named_stats(prefix="segm")
    timers["segm_eval_s"] = time.perf_counter() - t
    timers["detections_pass1"] = sum(len(c) for r in results1 for c in r)
    timers["detections_pass2"] = sum(len(c) for r in results2 for c in r)
    if passes is not None:
        passes.update(pass1=(results1, infos1, segms),
                      pass2=(results2, infos2), segm_eval=seg_ev)
    return stats, stats_single, seg_stats, mask_quality(seg_ev)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=1600)
    p.add_argument("--workdir",
                   default=os.path.join(REPO, "work_dirs",
                                        "learning_bench_torch"))
    p.add_argument("--skip-train", action="store_true",
                   help="reuse the checkpoint already in --workdir")
    p.add_argument("--train-seed", type=int, default=TRAIN_SEED,
                   help="override the pinned train seed (multi-seed noise "
                        "studies; the artifact records it)")
    p.add_argument("--json-out", default=None,
                   help="write the result artifact here (default "
                        "<workdir>/LEARNING_torch.json)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--config", default=CONFIG,
                   help="config file (the protocol pins the flagship)")
    p.add_argument("--synthetic", action="store_true",
                   help="a small generated set instead of the pinned one "
                        "(smoke runs; its hash is not the pinned one)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..apis.test_api import load_detector
    from ..apis.train_api import train_detector
    from ..train import checkpoint as ckpt
    from ..utils.config import Config
    from ..utils.device import resolve_device
    from .mask_placement import placement_rows, summarize

    device = resolve_device(None if args.device == "cuda" else args.device)
    # no TF32: float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(args.config)
    cfg.work_dir = args.workdir
    os.makedirs(args.workdir, exist_ok=True)

    t0 = time.perf_counter()
    (data_hash, ann_tr, dir_tr, ann_va, dir_va, ann_va2,
     dir_va2) = generate_pinned_data(
        args.workdir, cfg.get("upscale_factor", 1.5),
        SYNTHETIC if args.synthetic else None,
    )
    print(f"data ready in {time.perf_counter() - t0:.1f}s  "
          f"sha256={data_hash[:16]}  pinned={data_hash == PINNED_SHA256}",
          flush=True)

    train_s = None
    resume_step = None
    stats_train = {}
    if not args.skip_train:
        resume_step = ckpt.CheckpointManager(args.workdir).latest_step()
        dataset = train_dataset(cfg, ann_tr, dir_tr, args.train_seed)
        t0 = time.perf_counter()
        train_detector(cfg, dataset, work_dir=args.workdir,
                       seed=args.train_seed, max_iters=args.iters,
                       log_interval=100, device=device, stats=stats_train)
        train_s = time.perf_counter() - t0
        if resume_step is not None and train_s < 5.0:
            train_s = None

    model, step = load_detector(cfg, args.workdir, device)
    if step is None:
        raise SystemExit("no checkpoint after training")
    print(f"eval at step {step}" + (f" (train {train_s:.0f}s)"
                                    if train_s is not None else
                                    " (reused checkpoint)"), flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timers, passes = {}, {}
    stats, stats_single, seg_stats, quality = evaluate_protocol(
        cfg, model, ann_va, dir_va, ann_va2, dir_va2, timers, passes)
    placement = summarize(placement_rows(passes["segm_eval"]))

    losses = stats_train.get("losses", [])
    rec = dict(
        protocol=dict(
            data_seed_train=DATA_SEED_TRAIN,
            data_seed_val=DATA_SEED_VAL,
            train_seed=args.train_seed,
            hw=HW, depth=DEPTH,
            train_volumes=TRAIN_VOLUMES, val_volumes=VAL_VOLUMES,
            lesions=list(LESIONS),
            iters=args.iters,
            config=os.path.relpath(args.config, REPO),
            eval="double_test + segm (29-stat 3-D COCO)",
            synthetic=args.synthetic,
        ),
        data_sha256=data_hash,
        data_matches_pinned=data_hash == PINNED_SHA256,
        step=step,
        train_seconds=(round(train_s, 1) if train_s is not None else None),
        resume_from_step=resume_step,
        stats=round_stats(stats),
        stats_single_pass=round_stats(stats_single),
        segm_stats=round_stats(seg_stats),
        mask_quality=quality,
        placement=placement,
        port=dict(
            device=(torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
            torch=torch.__version__,
            dtype="float32 parameters and compute, autocast off",
            tf32=False,
            loader_wait_s=stats_train.get("loader_wait_s"),
            train_loop_s=stats_train.get("seconds"),
            loss_first_20=float(np.mean(losses[:20])) if losses else None,
            loss_last_20=float(np.mean(losses[-20:])) if losses else None,
            eval_timers=timers,
            eval_peak_memory_gib=(
                torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None),
        ),
    )
    out_path = args.json_out or os.path.join(args.workdir,
                                             "LEARNING_torch.json")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec["stats"].get(k) for k in
                      ("bbox_mAP", "bbox_mAP_0.5", "bbox_AR_100")}))
    print(json.dumps({k: rec["segm_stats"].get(k) for k in
                      ("segm_mAP", "segm_mAP_0.5")}))
    print(f"wrote {out_path}")
    return rec


if __name__ == "__main__":
    main()
