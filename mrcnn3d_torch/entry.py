"""Entry point: the flagship two-scale detector, ready to run.

    from mrcnn3d_torch.entry import build
    cfg = Config.fromfile(DEFAULT_CONFIG)
    cfg.test_cfg["return_bbox_only"] = False             # boxes and masks
    det = build(cfg, dtype=torch.bfloat16, budgets=2000)  # on the card
    dets, labels, valid, mask_logits = det.run(imgs, imgs_2)

`imgs` is a (B, 3, D, H, W) volume, `imgs_2` its 1.5x twin.  The
config's `test_cfg.return_bbox_only` decides whether masks are computed
(the flagship config asks for boxes only).  `build` runs on CUDA unless
`device="cpu"` is passed, and raises when CUDA is missing rather than
falling back to the CPU.  Weights are random, drawn from `seed`;
`load_state_dict` on `det.model` replaces them.

Training, on the same terms:

    from mrcnn3d_torch.entry import build_trainer
    trainer = build_trainer(compute_dtype=torch.bfloat16)  # on the card
    losses = trainer.step(batch)   # dict of 0-d tensors, "loss" the total

`batch` holds imgs / imgs_2 (B, 3, D, H, W), gt_boxes{,_2} (B, G, 6),
gt_labels{,_2} (B, G), gt_valid{,_2} (B, G) and gt_masks (B, G, D, H, W)
at 1.0x (`detectors.pipeline.forward_train`).  The samplers draw from a
torch.Generator seeded with `seed`; `trainer.state` is the
`train.step.TrainState` that `train.checkpoint` saves and restores.
"""
from __future__ import annotations

import copy
import os

import torch

from .core.targets import TorchDraws
from .detectors.build import anchor_cfgs, build_detector
from .detectors.pipeline import anchor_sets_for, simple_test
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
        """`pipeline.simple_test` on this detector; batch as there."""
        sets = self.anchor_sets(
            [batch["imgs"].shape[2:], batch["imgs_2"].shape[2:]]
        )
        with torch.inference_mode():
            return simple_test(self.model, batch, self.cfg, sets, mark=mark)

    def run(self, imgs, imgs_2):
        """Returns dets (B, max_per_img, 7), labels (B, max_per_img),
        valid (B, max_per_img), mask_logits (B*max_per_img, num_classes,
        Dm, Hm, Wm) -- None when the config asks for boxes only."""
        out = self.simple_test(dict(imgs=imgs, imgs_2=imgs_2))
        return (out["dets"], out["labels"], out["valid"],
                out.get("mask_logits"))


def build(cfg_path=DEFAULT_CONFIG, device=None, dtype=torch.float32,
          budgets=None, seed=0):
    """Flagship detector on `device` (the card unless "cpu").

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
    """A training build of the flagship, its train state and the
    samplers' draws."""

    def __init__(self, state, draws):
        self.state = state
        self.draws = draws

    @property
    def model(self):
        return self.state.model

    def step(self, batch, mark=None):
        """One train step; returns the loss dict plus "loss"."""
        return train_step(self.state, batch, self.draws, mark=mark)


def build_trainer(cfg_path=DEFAULT_CONFIG, device=None, seed=0,
                  compute_dtype=None, iters_per_epoch=None):
    """The flagship's trainer on `device` (the card unless "cpu").

    Weights and the samplers' draws come from `seed`; compute_dtype
    torch.bfloat16 runs the step under autocast over float32
    parameters (None: float32 throughout).  iters_per_epoch (the
    dataset's length over the batch size) places the config's lr steps;
    None keeps the warmup alone (`train.step.create_train_state`)."""
    device = resolve_device(device)
    cfg = _load_config(cfg_path)
    model = build_detector(cfg, device=device, seed=seed, train=True)
    state = create_train_state(model, cfg, compute_dtype, iters_per_epoch)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Trainer(state, TorchDraws(gen))
