"""Inference/eval API (reference tools/test.py + apis/inference.py path).

Counterpart of `mrcnn3d/apis/test_api.py`.  Whole volumes run through
`entry.Flagship.simple_test`, whose anchor sets are cached per input
shape (the JAX package caches a jitted program per shape); detections
flow through the patch->global json writers and the 29-stat 3-D COCO
evaluator.  With world > 1 each rank runs its rank-strided shard and
the per-image results are all-gathered back into the dataset's order
(`gather_shards`) before the patch merge and the scoring: every rank
scores what one process would, and returns the full dataset's stats.
(The JAX package gathers the json entries, `allgather_entries`, and
merges after; one gather of the results does both jobs here.)

Masks: where the JAX package pastes each detection's mask into a full
(D, H, W) volume, `run_inference` returns the box-extent carrier
{box, mask, shape} of `eval.masks.get_box_masks_3d` (the same resize and
threshold); `eval.masks.paste_mask_3d` pastes it into the same volume,
and `CocoEval3D` takes it as it is.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..entry import Flagship
from ..eval.coco_eval3d import CocoEval3D
from ..eval.masks import get_box_masks_3d, segm_entries
from ..eval.results import results2json3d

logger = logging.getLogger("mrcnn3d_torch")


class InferenceRunner:
    """simple_test over full volumes, on the model's device and dtype."""

    def __init__(self, cfg, model):
        self.det = Flagship(cfg, model, next(model.parameters()).device)

    @property
    def cfg(self):
        return self.det.cfg

    @property
    def model(self):
        return self.det.model

    def _tensor(self, img):
        """(D, H, W, 3) numpy -> (1, 3, D, H, W) in the model's dtype."""
        dtype = next(self.model.parameters()).dtype
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        return x.to(self.det.device).permute(3, 0, 1, 2)[None].to(dtype)

    def __call__(self, sample):
        """(dets (M, 7), labels (M,), valid (M,) bool[, mask logits (V,
        Dm, Hm, Wm) of the V valid rows' predicted class, in row order])
        as numpy."""
        batch = dict(imgs=self._tensor(sample["imgs"]))
        if self.model.num_scales >= 2 and not self.model.rgb:
            # the 1.5x twin at most, as the JAX runner feeds
            # (`mrcnn3d/apis/test_api.py:66`, which asks the RGB types'
            # one image for a twin too); the RGB types' detections are
            # slice r's (`pipeline.rgb_simple_test`)
            batch["imgs_2"] = self._tensor(sample["imgs_2"])
        out = self.det.simple_test(batch)
        dets, labels, valid = out["dets"][0], out["labels"][0], out["valid"][0]
        result = (dets.float().cpu().numpy(), labels.cpu().numpy(),
                  valid.cpu().numpy().astype(bool))
        if "mask_logits" in out:
            rows = torch.nonzero(valid).flatten()
            ml = out["mask_logits"][rows, labels[rows].long() + 1]
            result += (ml.float().cpu().numpy(),)
        return result


def load_detector(cfg, work_dir, device=None, dtype=torch.float32):
    """The inference build of `cfg` on `device` (the card unless "cpu")
    with the weights of the newest checkpoint under `work_dir`:
    (model, its step), or (seed 0's random weights, None) when there is
    no checkpoint."""
    from ..entry import build
    from ..train import checkpoint as ckpt

    model = build(cfg, device=device, dtype=dtype).model
    restored = ckpt.restore_params(ckpt.CheckpointManager(work_dir))
    if restored is None:
        return model, None
    model.load_state_dict(restored["params"])
    return model, restored["step"]


def run_inference(cfg, model, dataset, progress=True, rank=0, world=1):
    """Returns (per-image per-class results, img_infos[, per-image
    per-class mask carriers]).  model: the port's detector (its weights
    loaded), on the device it runs on.  rank/world: this rank's shard,
    the images idx % world == rank (reference eval_hooks.py:111-149),
    which `gather_shards` puts back in the dataset's order."""
    runner = InferenceRunner(cfg, model)
    num_classes = model.num_classes
    results, infos, segms = [], [], []
    for idx in range(rank, len(dataset), world):
        sample = dataset.prepare_test(idx)
        out = runner(sample)
        dets, labels, valid = out[:3]
        results.append([dets[valid & (labels == c)]
                        for c in range(num_classes - 1)])
        infos.append(sample["img_info"])
        if len(out) > 3:
            cls_segms = [[] for _ in range(num_classes - 1)]
            for bm in get_box_masks_3d(
                out[3], dets[valid], labels[valid], valid[valid],
                cfg.test_cfg["rcnn"].get("mask_thr_binary", 0.25),
            ):
                cls_segms[bm["label"] - 1].append(dict(
                    box=bm["box"], mask=bm["mask"],
                    shape=tuple(sample["ori_shape"])))
            segms.append(cls_segms)
        if progress:
            logger.info("inference %d/%d: %d dets", idx + 1, len(dataset),
                        int(valid.sum()))
    if segms:
        return results, infos, segms
    return results, infos


def gather_shards(items, world):
    """The per-image lists of `run_inference`'s rank-strided shards
    (image idx on rank idx % world), all-gathered and put back in the
    dataset's order; `items` itself when world is 1."""
    if world == 1:
        return items
    parts = [None] * world
    torch.distributed.all_gather_object(parts, items)
    n = sum(len(p) for p in parts)
    return [parts[i % world][i // world] for i in range(n)]


def evaluate_dataset(cfg, model, dataset, iou_type="bbox", rank=0, world=1):
    """In-loop / offline evaluation: 29-stat 3-D COCO summary.

    iou_type 'segm' requires the model's mask path (test_cfg
    return_bbox_only=False); detections are scored with voxel IoU
    against lazily-loaded gt masks.  With world > 1 each rank runs its
    shard and the results are all-gathered before the patch merge and
    the scoring: every rank returns the same full-dataset stats.
    """
    out = run_inference(cfg, model, dataset, progress=False, rank=rank,
                        world=world)
    out = [gather_shards(items, world) for items in out]
    if len(out) == 3 and iou_type == "segm":
        results, infos, segms = out
        entries = []
        for cls_segms, per_class, info in zip(segms, results, infos):
            entries.extend(segm_entries(cls_segms, per_class, info))
        evaluator = CocoEval3D(dataset.coco, entries, iou_type="segm")
        return evaluator.named_stats(prefix="segm")
    results, infos = out[:2]
    entries = results2json3d(results, infos)
    evaluator = CocoEval3D(dataset.coco, entries, iou_type="bbox")
    return evaluator.named_stats(prefix="bbox")
