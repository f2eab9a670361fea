"""Detector builder: reference config dict -> Detector3D module.

Port of `mrcnn3d/detectors/build.py` for its 3-D rows: the flagship
`MaskRCNN3D2Scales` and its ablation arms, which differ only in pathway
count, head sharing and which heads exist (SURVEY.md section 2.4), so
each is a row of flags; the single-stage and cascade families
(RetinaNet3D, CascadeRCNN3D, HybridTaskCascade3D); and the 2-D legacy
family (RPN, FasterRCNN, FastRCNN, MaskRCNN, RetinaNet, CascadeRCNN,
HybridTaskCascade), the same flags with `two_d`: depth-1 volumes through
(1, k, k) kernels, a base width of 64 unless the config gives one
(`build.py:113-115`); SSD, whose head lives under `bbox_head` and which
has no neck (`build.py:40-43, :97-103`); and the RGB 2.5-D family
(MaskRCNNRGB, MaskRCNNRGB2: three unshared head sets on one image,
`build.py:44-48`).  Every type of the JAX package's `_TYPES` is here.
`backbone.with_cp` is read where the JAX package reads it
(`build.py:137`).  The config keys read
here are the ones `mrcnn3d/detectors/build.py` reads, so narrowed widths
(`backbone.base_width`, `neck.out_channels`, `fc_out_channels`) build
the same shapes in both packages.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..models.detector import Detector3D
from ..models.layers import FrozenBatchNorm
from ..utils.device import resolve_device

# model.type -> Detector3D flags (`mrcnn3d/detectors/build.py:16-57`)
TYPES = {
    "RPN3D": dict(num_scales=1, with_bbox=False, with_mask=False),
    "FasterRCNN3D": dict(num_scales=1, with_mask=False),
    "MaskRCNN3D": dict(num_scales=1),
    "MaskRCNN3DParcel": dict(num_scales=1),
    "MaskRCNN3D2Scales": dict(num_scales=2, with_refinement=True),
    "MaskRCNN3D2ScalesHeads": dict(num_scales=2, share_heads=False),
    "MaskRCNN3D2ScalesHeadsRefinementHead": dict(
        num_scales=2, share_heads=False, with_refinement=True,
        with_mask=False),
    "MaskRCNN3D3ScalesHeads": dict(num_scales=3, share_heads=False),
    "MaskRCNN3D3ScalesOnePathway": dict(num_scales=3, share_heads=True),
    "MaskRCNN3D2ScalesOnePathwayOneRPN": dict(
        num_scales=2, share_heads=True, with_refinement=True, one_rpn=True),
    "RetinaNet3D": dict(num_scales=1, with_bbox=False, with_mask=False,
                        single_stage=True),
    "CascadeRCNN3D": dict(num_scales=1, with_mask=False, cascade=True),
    "HybridTaskCascade3D": dict(num_scales=1, with_mask=True, cascade=True,
                                htc=True),
    # the 2-D legacy family: depth-1 volumes, (1, k, k) kernels
    "RPN": dict(num_scales=1, with_bbox=False, with_mask=False, two_d=True),
    "FasterRCNN": dict(num_scales=1, with_mask=False, two_d=True),
    "FastRCNN": dict(num_scales=1, with_mask=False, two_d=True),
    "MaskRCNN": dict(num_scales=1, two_d=True),
    "RetinaNet": dict(num_scales=1, with_bbox=False, with_mask=False,
                      single_stage=True, two_d=True),
    "CascadeRCNN": dict(num_scales=1, with_mask=False, two_d=True,
                        cascade=True),
    "HybridTaskCascade": dict(num_scales=1, with_mask=True, two_d=True,
                              cascade=True, htc=True),
    "SSD": dict(num_scales=1, with_bbox=False, with_mask=False,
                single_stage=True, two_d=True, ssd=True),
    # one RGB image of adjacent slices, a head set per slice
    "MaskRCNNRGB": dict(num_scales=3, share_heads=False, two_d=True,
                        rgb=True),
    "MaskRCNNRGB2": dict(num_scales=3, share_heads=False, two_d=True,
                         rgb=True),
}
SUPPORTED = tuple(TYPES)

# parcellation classes when the config names none (`build.py:83-85`)
DEFAULT_PARCELLATIONS = 15


def detector_flags(cfg):
    """The Detector3D flags of cfg.model's type, defaults filled in as
    `mrcnn3d/detectors/build.py:64-105` fills them: a cascade's stage
    count is len(train_cfg.rcnn) when that is a list, else 3; HTC's
    semantic flags come from model.semantic_head; SSD's input size from
    model.backbone and its anchors a level, 2 * len(ratios) + 2, from
    model.bbox_head."""
    m = cfg.model
    kind = m["type"]
    if kind not in TYPES:
        raise KeyError(f"unknown detector type {kind!r}")
    flags = dict(TYPES[kind])
    flags.setdefault("with_bbox", True)
    flags.setdefault("with_mask", "mask_head" in m)
    flags.setdefault("share_heads", True)
    flags.setdefault("with_refinement", False)
    flags.setdefault("one_rpn", False)
    flags["with_refinement_mask"] = (
        flags["with_refinement"] and "refinement_mask_head" in m)
    parcels = m.get("bbox_head", {}).get("num_parcellations", 0)
    if kind == "MaskRCNN3DParcel" and not parcels:
        parcels = DEFAULT_PARCELLATIONS
    flags["num_parcellations"] = parcels
    flags.setdefault("single_stage", False)
    stages = 0
    if flags.pop("cascade", False):
        rcnn = cfg.train_cfg.get("rcnn") if "train_cfg" in cfg else None
        stages = len(rcnn) if isinstance(rcnn, (list, tuple)) else 3
    flags["cascade_stages"] = stages
    flags.setdefault("htc", False)
    flags.setdefault("two_d", False)
    flags.setdefault("rgb", False)
    if flags.setdefault("ssd", False):
        flags["ssd_input_size"] = m["backbone"].get("input_size", 300)
        flags["ssd_num_anchors"] = tuple(
            len(r) * 2 + 2 for r in m["bbox_head"]["anchor_ratios"])
    flags["with_cp"] = bool(m.get("backbone", {}).get("with_cp", False))
    sem = m.get("semantic_head") if flags["htc"] else None
    flags["with_semantic"] = sem is not None
    if sem is not None:
        flags["semantic_num_classes"] = sem.get("num_classes", 2)
        flags["semantic_fusion_level"] = sem.get("fusion_level", 1)
    return flags


def num_scales(cfg):
    """The pathway count of cfg.model's type."""
    return detector_flags(cfg)["num_scales"]


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
    flags = detector_flags(cfg)
    device = resolve_device(device)
    m = cfg.model
    rpn_head = m.get("rpn_head") or {}
    bbox_head = m.get("bbox_head", {})
    bbox_roi = m.get("bbox_roi_extractor", {}).get("roi_layer", {})
    neck = m.get("neck") or {}
    model = Detector3D(
        depth=m["backbone"].get("depth", 50),
        base_width=m["backbone"].get("base_width",
                                     64 if flags["two_d"] else 16),
        backbone_type=m["backbone"].get("type", "ResNet3D"),
        fpn_channels=neck.get("out_channels", 64),
        num_outs=neck.get("num_outs", 5),
        num_classes=bbox_head.get("num_classes", 2),
        num_anchors=max(
            1,
            len(rpn_head.get("anchor_scales", [1]))
            * len(rpn_head.get("anchor_ratios", [1.0])),
        ),
        fc_out_channels=bbox_head.get("fc_out_channels", 1024),
        mask_convs=m.get("mask_head", {}).get("num_convs", 4),
        roi_size=bbox_roi.get("out_size", 7),
        roi_size_depth=bbox_roi.get("out_size_depth", 3),
        **flags,
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
    `mrcnn3d/models/layers.py:FrozenBatchNorm`); SSD's L2Norm keeps its
    scale of 20."""
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
    near identity (drawn, so that the parity checks exercise them);
    SSD's L2Norm keeps its scale of 20."""
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
    """Per-scale anchor config dicts (rpn_head, rpn_head_2, rpn_head_3;
    bbox_head for a head that lives there, SSD's), padded to the type's
    scale count with the last one given: the one-RPN variant configures
    one rpn_head for every pathway (reference
    two_stage_3d_onepathway_onerpn.py:142-143; `build.py:144-159`).  The
    RGB family's slices share one image and its anchors: not padded."""
    out = [cfg.model.get("rpn_head") or cfg.model["bbox_head"]]
    for key in ("rpn_head_2", "rpn_head_3"):
        if key in cfg.model:
            out.append(cfg.model[key])
    kind = TYPES.get(cfg.model.get("type"), {})
    if not kind.get("rgb"):
        while len(out) < kind.get("num_scales", 1):
            out.append(out[-1])
    return out
