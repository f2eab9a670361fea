"""Entry point: the flagship two-scale detector, any 3-D two-stage
variant of it, or a single-stage or cascade family (RetinaNet3D,
CascadeRCNN3D, HybridTaskCascade3D; `detectors.build.TYPES`), ready to
run.

    from mrcnn3d_torch.entry import build
    cfg = Config.fromfile(DEFAULT_CONFIG)
    cfg.test_cfg["return_bbox_only"] = False             # boxes and masks
    det = build(cfg, dtype=torch.bfloat16, budgets=2000)  # on the card
    dets, labels, valid, mask_logits = det.run(imgs, imgs_2)

`imgs` is a (B, 3, D, H, W) volume, `imgs_2` its 1.5x twin (`imgs_3`
the 2.25x one of a three-scale type; a single-scale type, every family
among them, takes `imgs` alone; `mask_logits` of HTC are the stages'
mean mask probability as a logit).  `build` and `build_trainer` take a config file or a loaded
config of any type in the table.  The
config's `test_cfg.return_bbox_only` decides whether masks are computed
(the flagship config asks for boxes only).  `build` runs on CUDA unless
`device="cpu"` is passed, and raises when CUDA is missing rather than
falling back to the CPU.  Weights are random, drawn from `seed`;
`load_state_dict` on `det.model` replaces them.

A whole volume, tiled (`apis/tiled.py`), from a normalised (D, H, W, 3)
numpy volume (its 1.5x twin is derived on the card unless given as
`imgs_2`):

    per_class, segms = det.tiled(dict(imgs=volume), patch_hw=512,
                                 patch_d=64)

and scored with `eval.coco_eval3d.CocoEval3D`.

Training, on the same terms:

    from mrcnn3d_torch.entry import build_trainer
    trainer = build_trainer(compute_dtype=torch.bfloat16)  # on the card
    losses = trainer.step(batch)   # dict of 0-d tensors, "loss" the total

`batch` holds imgs / imgs_2 (B, 3, D, H, W), gt_boxes{,_2} (B, G, 6),
gt_labels{,_2} (B, G), gt_valid{,_2} (B, G) and gt_masks (B, G, D, H, W)
at 1.0x (`detectors.pipeline.forward_train`; HTC also takes
gt_semantic_seg (B, D, H, W), resized nearest to its semantic grid).
Training anchors honour train_cfg.rpn.allowed_border.  The samplers
draw from a torch.Generator seeded with `seed`; `trainer.state` is the
`train.step.TrainState` that `train.checkpoint` saves and restores.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from .apis.tiled import tiled_inference
from .core.targets import KeyedDraws, TorchDraws
from .detectors.aug import aug_test
from .detectors.build import anchor_cfgs, build_detector
from .detectors.pipeline import anchor_sets_for, scale_shapes, simple_test
from .train.step import create_train_state, train_step
from .utils.config import Config
from .utils.device import resolve_device

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "mask_rcnn_3d_2scales.py",
)


class Flagship:
    """A built detector plus its config; anchors are cached per shape."""

    def __init__(self, cfg, model, device):
        self.cfg = cfg
        self.model = model
        self.device = device
        self._anchor_sets = {}

    def anchor_sets(self, shapes):
        """Anchor sets for the (D, H, W) input of each scale."""
        key = tuple(tuple(s) for s in shapes)
        if key not in self._anchor_sets:
            self._anchor_sets[key] = anchor_sets_for(
                self.model, anchor_cfgs(self.cfg), key, self.device)
        return self._anchor_sets[key]

    def simple_test(self, batch, mark=None):
        """`pipeline.simple_test` on this detector; batch as there, with
        the imgs_* of each of the model's scales."""
        sets = self.anchor_sets(scale_shapes(self.model, batch))
        with torch.inference_mode():
            return simple_test(self.model, batch, self.cfg, sets, mark=mark)

    def aug_test(self, aug_batches, metas):
        """`detectors.aug.aug_test` on this detector: test-time
        augmentation over the views in `aug_batches` (each dict(imgs=
        (B, 3, D, H, W))), described by `metas` (each dict(scale_factor,
        flip)); detections in the original frame."""
        sets = [self.anchor_sets([tuple(ab["imgs"].shape[2:])])[0]
                for ab in aug_batches]
        with torch.inference_mode():
            return aug_test(self.model, aug_batches, metas, self.cfg, sets)

    def tiled(self, volume_sample, **kw):
        """`apis.tiled.tiled_inference` on this detector: per-class
        detections in volume coordinates (and their masks)."""
        return tiled_inference(self, volume_sample, **kw)

    def run(self, imgs, imgs_2=None, imgs_3=None):
        """Returns dets (B, max_per_img, 7), labels (B, max_per_img),
        valid (B, max_per_img), mask_logits (B*max_per_img, num_classes,
        Dm, Hm, Wm) -- None when the config asks for boxes only or the
        type has no mask head.  Give the volumes of the model's scales."""
        given = dict(imgs=imgs, imgs_2=imgs_2, imgs_3=imgs_3)
        out = self.simple_test({k: v for k, v in given.items()
                                if v is not None})
        return (out["dets"], out["labels"], out["valid"],
                out.get("mask_logits"))


def build(cfg_path=DEFAULT_CONFIG, device=None, dtype=torch.float32,
          budgets=None, seed=0):
    """The config's detector on `device` (the card unless "cpu").

    cfg_path: a config file, or a loaded config (copied, not changed).
    budgets: when given, nms_pre / nms_post / max_num / max_per_img.
    """
    device = resolve_device(device)
    cfg = _load_config(cfg_path)
    if budgets is not None:
        for k in ("nms_pre", "nms_post", "max_num"):
            cfg.test_cfg["rpn"][k] = int(budgets)
        cfg.test_cfg["rcnn"]["max_per_img"] = int(budgets)
    model = build_detector(cfg, dtype=dtype, device=device, seed=seed)
    return Flagship(cfg, model, device)


def _load_config(cfg_path):
    """A config file, or a loaded config (copied, not changed)."""
    if isinstance(cfg_path, dict):
        return copy.deepcopy(cfg_path)
    return Config.fromfile(cfg_path)


class Trainer:
    """A training build of a detector, its train state and the samplers'
    draws."""

    def __init__(self, state, draws):
        self.state = state
        self.draws = draws

    @property
    def model(self):
        return self.state.model

    def step(self, batch, mark=None):
        """One train step; returns the loss dict plus "loss"."""
        draws = self.draws
        if isinstance(draws, KeyedDraws):
            draws = draws.at(self.state.step)
        return train_step(self.state, batch, draws, mark=mark)


def build_trainer(cfg_path=DEFAULT_CONFIG, device=None, seed=0,
                  compute_dtype=None, iters_per_epoch=None, mesh=None,
                  keyed_draws=False):
    """The config's trainer on `device` (the card unless "cpu");
    cfg_path: a config file or a loaded config (copied).

    Weights and the samplers' draws come from `seed`; compute_dtype
    torch.bfloat16 runs the step under autocast over float32
    parameters (None: float32 throughout).  iters_per_epoch (the
    dataset's length over the batch size) places the config's lr steps;
    None keeps the warmup alone (`train.step.create_train_state`).

    mesh (`parallel.mesh.make_mesh` / `make_mesh2`): the step is then
    data-parallel (each rank steps on its rows of the global batch),
    rank 0's weights are broadcast to every rank, and the draws are
    keyed by site (`core.targets.KeyedDraws`), as they are with
    keyed_draws in one process."""
    device = resolve_device(device)
    cfg = _load_config(cfg_path)
    model = build_detector(cfg, device=device, seed=seed, train=True)
    state = create_train_state(model, cfg, compute_dtype, iters_per_epoch)
    if mesh is not None:
        from .parallel.mesh import broadcast_params

        broadcast_params(model)
        state.mesh = mesh
    if mesh is not None or keyed_draws:
        return Trainer(state, KeyedDraws(seed))
    gen = torch.Generator(device=device).manual_seed(seed)
    return Trainer(state, TorchDraws(gen))


def narrow_config(cfg_path=DEFAULT_CONFIG, budget=64):
    """A config at narrow widths (backbone base 4, FPN 8, fc 32; depth
    kept) with the training budgets cut to `budget` proposals, RPN
    sampler 64 and R-CNN sampler 32: what a CPU run of several processes
    can afford."""
    cfg = _load_config(cfg_path)
    cfg.model["backbone"]["base_width"] = 4
    cfg.model["neck"]["out_channels"] = 8
    for head in ("bbox_head", "refinement_head"):
        if head in cfg.model:
            cfg.model[head]["fc_out_channels"] = 32
    tc = cfg.train_cfg
    for k in ("nms_pre", "nms_post", "max_num"):
        tc["rpn_proposal"][k] = budget
    tc["rpn"]["sampler"]["num"] = 64
    tc["rcnn"]["sampler"]["num"] = 32
    return cfg


def synthetic_train_batch(rows, device, seed=0, shape=(8, 32, 32),
                          max_gt=4):
    """A generated two-scale training batch of `rows` volumes (B, 3, D,
    H, W) and their 1.5x twins, with `max_gt` boxes an image (the last
    invalid) whose central parts are the masks, on `device`."""
    rng = np.random.RandomState(seed)
    d, h, w = shape
    xy = rng.uniform(0, 0.55 * h, (rows, max_gt, 2))
    size = rng.uniform(0.2 * h, 0.4 * h, (rows, max_gt, 2))
    z = rng.uniform(0, d / 2, (rows, max_gt, 1))
    boxes = np.concatenate([xy, xy + size, z, z + d / 3], -1).astype(
        np.float32)
    valid = np.ones((rows, max_gt), bool)
    valid[:, -1] = False
    masks = np.zeros((rows, max_gt, d, h, w), np.uint8)
    for i, j in np.ndindex(rows, max_gt):
        x1, y1, x2, y2, z1, z2 = np.round(boxes[i, j]).astype(int)
        masks[i, j, z1:z2, y1 + 1:y2, x1 + 1:x2] = 1
    labels = np.ones((rows, max_gt), np.int32)
    up = tuple(int(v * 1.5) for v in shape)
    batch = dict(
        imgs=rng.randn(rows, 3, d, h, w).astype(np.float32),
        imgs_2=rng.randn(rows, 3, *up).astype(np.float32),
        gt_boxes=boxes, gt_boxes_2=boxes * np.float32(1.5),
        gt_labels=labels, gt_labels_2=labels, gt_valid=valid,
        gt_valid_2=valid, gt_masks=masks)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _dryrun_rank(rank, world, device):
    """One data-parallel step over `world` ranks, then one hybrid step
    (data x depth, depth 2) from fresh weights, on `device` (a card's
    ranks spread over its cards); the losses."""
    from .parallel.mesh import local_rows, make_mesh, make_mesh2

    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    cfg = narrow_config()
    losses = []
    for mesh in (make_mesh(world), make_mesh2(world // 2, 2)):
        trainer = build_trainer(cfg, device=device, mesh=mesh)
        batch = local_rows(synthetic_train_batch(mesh.n_data, device),
                           mesh.data_rank, mesh.n_data)
        losses.append(float(trainer.step(batch)["loss"]))
    return losses


def dryrun_multichip(n=2, device=None):
    """The multi-process paths at a narrow width
    (`__graft_entry__.py:dryrun_multichip`): `n` (even) gloo processes
    take one data-parallel step over n images, then one hybrid step (n/2
    data x 2 depth ranks) over n/2 images; prints one line.  Runs on the
    card (rank r on card r mod the count; gloo lets ranks share one)
    unless `device="cpu"`.  Raises if a rank fails or the ranks' losses
    disagree."""
    from .parallel.launch import spawn

    if n < 2 or n % 2:
        raise ValueError(f"dryrun_multichip needs an even n >= 2, got {n}")
    device = resolve_device(device)
    losses = spawn(_dryrun_rank, n, (device.type,))
    if any(l_ != losses[0] for l_ in losses) or not np.isfinite(
            losses[0]).all():
        raise AssertionError(f"dryrun_multichip: rank losses {losses}")
    dp, hybrid = losses[0]
    print(f"dryrun_multichip({n}) OK - loss {dp:.6f} data-parallel over "
          f"{n} processes, {hybrid:.6f} hybrid {n // 2}x2", flush=True)
    return dp, hybrid
