"""The 3-D two-stage detector module (NCDHW).

Counterpart of `mrcnn3d/models/detector.py` for its 3-D two-stage flags:
a shared backbone + FPN; one RPN head per scale (or one for every scale,
`one_rpn`, reference two_stage_3d_onepathway_onerpn.py:142-143); a bbox
head and a mask head, one shared across the scales or one per scale when
`share_heads` is False (reference two_stage_3d_2scales_heads.py:64,82);
the refinement head and the refinement mask head.  `with_bbox=False` is
the RPN-only detector, `with_mask=False` the detection-only one, and
`num_parcellations` adds the bbox head's brain-region branch.  Module
names are the reference mmdet state_dict names (`rpn_head`,
`rpn_head_2`, `bbox_head`, `mask_head_3`, ...).

The single-stage and cascade families (`mrcnn3d/models/detector.py`
:132-227): `single_stage` makes a RetinaHead3D the anchor head, named
`bbox_head` as in mmdet's RetinaNet; `cascade_stages` > 0 makes one
class-agnostic bbox head per stage (`bbox_head.{t}`), and with `htc` one
HTCMaskHead3D per stage (`mask_head.{t}`) and, with `with_semantic`, the
fused semantic head (`semantic_head`), whose `num_convs` is 4 whatever
the config says, as the JAX package builds it.

The backbone is `backbone_type`'s (`build_backbone`): ResNet3D at depth
18, 34, 50, 101 or 152, ResNeXt3D or UNet3D; the FPN's in-channels
follow its outputs.  `with_cp` recomputes ResNet3D's blocks in the
backward pass (ResNeXt3D and UNet3D ignore it, as the JAX package's do).

`two_d` is the 2-D legacy family (`mrcnn3d/detectors/build.py:17-37`):
depth-1 volumes through ResNet3D's or ResNeXt3D's (1, k, k) mode and the
2-D mode of the mask, HTC mask, semantic and RetinaNet heads; the FPN,
the RPN head, the bbox heads and the refinement mask head keep their
3x3x3 kernels, as the JAX package builds them.

`ssd` is SSD (`mrcnn3d/models/detector.py:93-105`): SSD's VGG16
backbone (`backbone.features`, `.extra`, `.l2_norm`) and SSDHead
(`bbox_head`), no neck; its level sizes come from the VGG's own
arithmetic.  `rgb` is the RGB 2.5-D family (reference two_stage_rgb.py):
one RGB image of three adjacent slices through one backbone and FPN,
with a head set per slice -- three scales' unshared heads (`rpn_head`,
`rpn_head_2`, `rpn_head_3`, `bbox_head`, ...) over the same features.

The module owns the parameters only; proposal decoding, RoIAlign, NMS
and the stage logic live in `detectors/pipeline.py`.  Features run in
`channels_last_3d` storage, so a level permuted to (B, D, H, W, C) is a
view that the RoIAlign kernel reads channel-contiguously.
"""
from __future__ import annotations

import torch
from torch import nn

from .backbones_extra import ResNeXt3D, SSDVGG, UNet3D
from .fpn3d import FPN3D
from .heads import (
    FCNMaskHead3D,
    FusedSemanticHead3D,
    HTCMaskHead3D,
    RetinaHead3D,
    RPNHead3D,
    SharedFCBBoxHead3D,
    SharedFCBBoxHead3DRefinement,
    SSDHead,
)
from .resnet3d import ResNet3D


BACKBONES = ("ResNet3D", "ResNeXt3D", "UNet3D")
# the 2-D configs' name of ResNet3D (configs/faster_rcnn_2d.py)
RESNET_NAMES = ("ResNet3D", "ResNet")


def build_backbone(backbone_type, depth=50, base_width=16, two_d=False,
                   with_cp=False):
    """The backbone of `backbone_type`, as `mrcnn3d/models/detector.py:
    106-121` builds it: ResNeXt3D takes the stem width from base_width
    (groups 32, 4 channels a group at 64 planes); UNet3D its defaults
    (base_channels 16, 4 levels) whatever the config says."""
    if backbone_type in RESNET_NAMES:
        return ResNet3D(depth=depth, base_width=base_width, two_d=two_d,
                        with_cp=with_cp)
    if backbone_type == "ResNeXt3D":
        return ResNeXt3D(depth=depth, width=base_width, two_d=two_d)
    if backbone_type == "UNet3D":
        return UNet3D()
    raise KeyError(f"unknown backbone type {backbone_type!r}; the port "
                   f"builds {BACKBONES}")


def _scale_name(base, s):
    return base if s == 0 else f"{base}_{s + 1}"


class Detector3D(nn.Module):
    def __init__(
        self,
        depth=50,
        base_width=16,
        backbone_type="ResNet3D",
        fpn_channels=64,
        num_outs=5,
        num_classes=2,
        num_anchors=1,
        num_scales=2,
        share_heads=True,
        one_rpn=False,
        with_bbox=True,
        with_mask=True,
        with_refinement=True,
        with_refinement_mask=True,
        num_parcellations=0,
        fc_out_channels=1024,
        mask_convs=4,
        roi_size=7,
        roi_size_depth=3,
        single_stage=False,
        stacked_convs=4,
        cascade_stages=0,
        htc=False,
        with_semantic=False,
        semantic_num_classes=2,
        semantic_fusion_level=1,
        two_d=False,
        with_cp=False,
        ssd=False,
        ssd_input_size=300,
        ssd_num_anchors=(),
        rgb=False,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.num_scales = num_scales
        self.share_heads = share_heads
        self.one_rpn = one_rpn
        self.with_bbox = with_bbox
        self.with_mask = with_mask
        self.with_refinement = with_refinement
        self.with_refinement_mask = with_refinement_mask
        self.num_parcellations = num_parcellations
        self.single_stage = single_stage
        self.cascade_stages = cascade_stages
        self.htc = htc
        self.with_semantic = with_semantic
        self.two_d = two_d
        self.ssd = ssd
        self.rgb = rgb
        if ssd:
            self.backbone = SSDVGG(ssd_input_size)
            self.bbox_head = SSDHead(self.backbone.out_channels,
                                     ssd_num_anchors, num_classes, two_d)
            return
        self.backbone = build_backbone(backbone_type, depth, base_width,
                                       two_d, with_cp)
        self.neck = FPN3D(self.backbone.out_channels, fpn_channels, num_outs)
        roi_features = fpn_channels * roi_size_depth * roi_size * roi_size
        if single_stage:
            self.bbox_head = RetinaHead3D(fpn_channels, stacked_convs,
                                          num_anchors, num_classes - 1,
                                          two_d=two_d)
            return
        for s in range(1 if one_rpn else num_scales):
            setattr(self, _scale_name("rpn_head", s),
                    RPNHead3D(fpn_channels, num_anchors))
        if cascade_stages > 0:
            self.bbox_head = nn.ModuleList([
                SharedFCBBoxHead3D(roi_features, fc_out_channels,
                                   num_classes, reg_class_agnostic=True)
                for _ in range(cascade_stages)])
            if with_mask and htc:
                self.mask_head = nn.ModuleList([
                    HTCMaskHead3D(fpn_channels, num_classes, mask_convs,
                                  with_conv_res=t > 0, two_d=two_d)
                    for t in range(cascade_stages)])
            if with_semantic:
                self.semantic_head = FusedSemanticHead3D(
                    fpn_channels, num_outs, semantic_fusion_level,
                    num_classes=semantic_num_classes, two_d=two_d)
            return
        for s in range(1 if share_heads else num_scales):
            if with_bbox:
                setattr(
                    self,
                    _scale_name("bbox_head", s),
                    SharedFCBBoxHead3D(
                        roi_features, fc_out_channels, num_classes,
                        num_parcellations=num_parcellations),
                )
            if with_mask:
                setattr(
                    self,
                    _scale_name("mask_head", s),
                    FCNMaskHead3D(fpn_channels, num_classes, mask_convs,
                                  two_d=two_d),
                )
        if with_refinement:
            self.refinement_head = SharedFCBBoxHead3DRefinement(
                roi_features, fc_out_channels, num_classes
            )
        if with_refinement_mask:
            self.refinement_mask_head = FCNMaskHead3D(
                fpn_channels, num_classes, mask_convs
            )

    def _head(self, base, scale):
        return getattr(self, _scale_name(base, 0 if self.share_heads else scale))

    def extract_feat(self, x):
        """(B, 3, D, H, W) -> list of FPN levels (B, C, d, h, w)."""
        x = x.contiguous(memory_format=torch.channels_last_3d)
        if self.ssd:
            return self.backbone(x)
        return self.neck(self.backbone(x))

    def rpn(self, feats, scale=0):
        """Per level (cls, reg) of scale's anchor head (RetinaHead3D for
        a single-stage model; SSD's head runs on every level at once)."""
        if self.ssd:
            return self.bbox_head(feats)
        if self.single_stage:
            head = self.bbox_head
        else:
            head = getattr(self, _scale_name("rpn_head",
                                             0 if self.one_rpn else scale))
        return [head(f) for f in feats]

    def bbox_forward(self, roi_feats, scale=0):
        """(cls, reg[, parcellation logits]) of scale's bbox head (of
        stage `scale` in a cascade)."""
        if self.cascade_stages > 0:
            return self.bbox_head[scale](roi_feats)
        return self._head("bbox_head", scale)(roi_feats)

    def htc_mask_forward(self, roi_feats, res_feat, stage,
                         return_logits=True):
        """Stage's HTC mask head with information flow: (logits or None,
        features) (reference htc.py:98-105, 141-154)."""
        return self.mask_head[stage](roi_feats, res_feat, return_logits)

    def semantic_forward(self, feats):
        """(logits, embedding) of the fused semantic head."""
        return self.semantic_head(feats)

    def refinement_forward(self, roi_feats):
        return self.refinement_head(roi_feats)

    def mask_forward(self, roi_feats, scale=0):
        return self._head("mask_head", scale)(roi_feats)

    def refinement_mask_forward(self, roi_feats):
        return self.refinement_mask_head(roi_feats)

    def mask_size(self, out_d, out):
        """The mask heads' (Dm, Hm, Wm) for RoI features of (out_d, out,
        out): the upsample's factor per axis."""
        head = (self.mask_head[0] if self.cascade_stages > 0
                else self._head("mask_head", 0))
        fd, fh, fw = head.upsample_factor
        return out_d * fd, out * fh, out * fw

    def featmap_sizes(self, shape):
        """FPN level (d, h, w) sizes for an input volume of (D, H, W)
        (SSD's: the VGG's output sizes)."""
        if self.ssd:
            return self.backbone.featmap_sizes(shape)
        return self.neck.featmap_sizes(self.backbone.featmap_sizes(shape))
