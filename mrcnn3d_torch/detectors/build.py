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


def build_detector(cfg, dtype=torch.float32, device=None, seed=0,
                   train=False):
    """cfg: full ConfigDict (uses cfg.model).  Returns a Detector3D on
    `device` (the card unless "cpu" is asked for), its weights drawn from
    `seed`, in channels_last_3d storage.

    train=False: eval mode, no gradients, in `dtype`, frozen-BN
    statistics drawn near identity (`init_weights`).  train=True: the
    training build, float32 parameters that require gradients (bf16
    compute comes from autocast), started where the JAX package's
    `model.init` starts (`init_train_weights`); the frozen-BN statistics
    stay buffers and are never updated."""
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
    gen = torch.Generator().manual_seed(seed)
    if train:
        init_train_weights(model, gen)
    else:
        init_weights(model, gen)
    model = model.to(
        device=device, dtype=torch.float32 if train else dtype,
        memory_format=torch.channels_last_3d,
    )
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)


# flax's variance_scaling draws a standard normal truncated to [-2, 2]
# and divides by that distribution's std, so the kernel's std is the
# target 1 / sqrt(fan_in)
TRUNC_NORMAL_STD = 0.87962566103423978


def fan_in(mod):
    """A conv, transposed conv or linear layer's fan_in as flax counts
    it (receptive field times input features); None for other modules."""
    if not isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
        return None
    w = mod.weight
    if isinstance(mod, nn.ConvTranspose3d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def init_train_weights(model, generator):
    """Where the JAX package's `model.init` starts training: flax's
    lecun_normal kernels (a truncated normal of std 1 / sqrt(fan_in)),
    zero biases, frozen BN at identity (mean 0, var 1, weight 1, bias 0,
    `mrcnn3d/models/layers.py:FrozenBatchNorm`)."""
    with torch.no_grad():
        for mod in model.modules():
            n = fan_in(mod)
            if n is not None:
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                mod.weight.mul_(1.0 / math.sqrt(n) / TRUNC_NORMAL_STD)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, FrozenBatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def init_weights(model, generator):
    """Seeded random weights for the inference build: plain-normal
    kernels of std 1 / sqrt(fan_in), zero biases, frozen-BN statistics
    near identity (drawn, so that the parity checks exercise them)."""
    for mod in model.modules():
        n = fan_in(mod)
        if n is not None:
            with torch.no_grad():
                mod.weight.normal_(0.0, 1.0 / math.sqrt(n),
                                   generator=generator)
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
