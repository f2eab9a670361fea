"""Detector builder: reference config dict -> Detector3D module.

The port builds the flagship `MaskRCNN3D2Scales` only; the config keys
read here are the ones `mrcnn3d/detectors/build.py` reads, so narrowed
widths (`backbone.base_width`, `neck.out_channels`, `fc_out_channels`)
build the same shapes in both packages.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..models.detector import Detector3D
from ..models.layers import FrozenBatchNorm
from ..utils.device import resolve_device

SUPPORTED = ("MaskRCNN3D2Scales",)


def build_detector(cfg, dtype=torch.float32, device=None, seed=0):
    """cfg: full ConfigDict (uses cfg.model).  Returns a Detector3D in
    eval mode on `device` (the card unless "cpu" is asked for), its
    weights drawn from `seed`."""
    device = resolve_device(device)
    m = cfg.model
    kind = m["type"]
    if kind not in SUPPORTED:
        raise NotImplementedError(
            f"detector type {kind!r} is not ported yet: the port builds "
            f"{SUPPORTED} (ROADMAP Queue A item 11 ports the variants)"
        )
    rpn_head = m["rpn_head"]
    bbox_roi = m["bbox_roi_extractor"]["roi_layer"]
    model = Detector3D(
        depth=m["backbone"].get("depth", 50),
        base_width=m["backbone"].get("base_width", 16),
        fpn_channels=m["neck"].get("out_channels", 64),
        num_outs=m["neck"].get("num_outs", 5),
        num_classes=m["bbox_head"].get("num_classes", 2),
        num_anchors=max(
            1,
            len(rpn_head.get("anchor_scales", [1]))
            * len(rpn_head.get("anchor_ratios", [1.0])),
        ),
        num_scales=2,
        share_heads=True,
        with_refinement=True,
        with_refinement_mask="refinement_mask_head" in m,
        fc_out_channels=m["bbox_head"].get("fc_out_channels", 1024),
        mask_convs=m["mask_head"].get("num_convs", 4),
        roi_size=bbox_roi.get("out_size", 7),
        roi_size_depth=bbox_roi.get("out_size_depth", 3),
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(
        device=device, dtype=dtype, memory_format=torch.channels_last_3d
    )
    return model.eval().requires_grad_(False)


def init_weights(model, generator):
    """Seeded random weights: LeCun-normal kernels (the flax default),
    zero biases, frozen-BN statistics near identity."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel() if not isinstance(
                mod, nn.ConvTranspose3d) else w.shape[0] * w[0, 0].numel()
            with torch.no_grad():
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            n = mod.weight.shape[0]
            mod.running_mean.copy_(
                torch.randn(n, generator=generator) * 0.1
            )
            mod.running_var.copy_(
                torch.rand(n, generator=generator) * 0.4 + 0.8
            )


def anchor_cfgs(cfg):
    """Per-scale anchor config dicts (rpn_head, rpn_head_2)."""
    return [cfg.model["rpn_head"], cfg.model["rpn_head_2"]]
