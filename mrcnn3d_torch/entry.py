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
"""
from __future__ import annotations

import copy
import os

import torch

from .detectors.build import anchor_cfgs, build_detector
from .detectors.pipeline import build_anchor_set, simple_test
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
            self._anchor_sets[key] = [
                build_anchor_set(
                    self.model.featmap_sizes((d, h, w)), (h, w, 3, d), ac,
                    self.device,
                )
                for (d, h, w), ac in zip(key, anchor_cfgs(self.cfg))
            ]
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
    if isinstance(cfg_path, dict):
        cfg = copy.deepcopy(cfg_path)
    else:
        cfg = Config.fromfile(cfg_path)
    if budgets is not None:
        for k in ("nms_pre", "nms_post", "max_num"):
            cfg.test_cfg["rpn"][k] = int(budgets)
        cfg.test_cfg["rcnn"]["max_per_img"] = int(budgets)
    model = build_detector(cfg, dtype=dtype, device=device, seed=seed)
    return Flagship(cfg, model, device)
