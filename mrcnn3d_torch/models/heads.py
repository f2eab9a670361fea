"""Detection heads (NCDHW).

  * RPNHead3D -- reference rpn_head_3d.py:15-35: 3x3x3 conv + ReLU, then
    1x1x1 cls (A sigmoid logits) and reg (A*6) convs.
  * SharedFCBBoxHead3D -- reference convfc_bbox_head_3d.py (SharedFC):
    flatten the RoI features in C*D*H*W order, fcs + ReLU, fc_cls and
    fc_reg (6 per class); with `num_parcellations`, fc_parcellations,
    the brain-region logits (reference bbox_head_3d_parcel.py:52,72-73).
  * SharedFCBBoxHead3DRefinement -- the regression-only twin.
  * FCNMaskHead3D -- reference fcn_mask_head_3d.py:16-98: 3x3x3 convs
    (+bias +ReLU), a 2x transposed-conv upsample + ReLU, 1x1x1 per-class
    logits.  Output (N, num_classes, Dm, Hm, Wm).
  * HTCMaskHead3D -- reference htc_mask_head.py:7-38: an FCN mask head
    whose input adds the previous stage's mask features through a 1x1x1
    `conv_res` (mask information flow).
  * FusedSemanticHead3D -- reference fused_semantic_head.py: per-level
    1x1x1 laterals summed at the fusion level's size, 3x3x3 convs, then
    the class logits and the embedding that HTC fuses into its rois.
  * RetinaHead3D -- reference retina_head.py lifted to 6-DoF: cls and reg
    towers of 3x3x3 convs + ReLU, then per-anchor sigmoid class logits
    and deltas.
  * SSDHead -- reference ssd_head.py:14-47: per level one 3x3 conv to the
    level's anchors' softmax class logits (background included) and one
    to their deltas (`cls_convs.{i}`, `reg_convs.{i}`, mmdet's names).

`two_d` (the 2-D legacy family on depth-1 maps, `mrcnn3d/models/heads.py
:114-133, :161-189, :216-222, :307-313`): the mask, HTC mask, semantic
and RetinaNet heads' 3x3x3 convs become (1, 3, 3) and the mask heads'
2x upsample (1, 2, 2); SSD's head is (1, 3, 3) in the 2-D family.  The RPN head and the bbox heads have no 2-D mode,
as in the JAX package: their 3x3x3 conv sees only its centre depth tap
on a depth-1 map.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize3d import jax_resize
from .layers import ConvModule3D


def conv3(two_d):
    """(kernel, padding) of a head's 3x3 conv."""
    return ((1, 3, 3), (0, 1, 1)) if two_d else (3, 1)


class RPNHead3D(nn.Module):
    def __init__(self, channels=64, num_anchors=1):
        super().__init__()
        self.rpn_conv = nn.Conv3d(channels, channels, 3, padding=1)
        self.rpn_cls = nn.Conv3d(channels, num_anchors, 1)
        self.rpn_reg = nn.Conv3d(channels, num_anchors * 6, 1)

    def forward(self, x):
        x = torch.relu(self.rpn_conv(x))
        return self.rpn_cls(x), self.rpn_reg(x)


class SharedFCBBoxHead3D(nn.Module):
    """Shared-FC bbox head; `with_cls=False` is the refinement head.
    Returns (cls, reg), or (cls, reg, parcellation logits) when
    `num_parcellations` > 0.  `reg_class_agnostic`: 6 deltas, not 6 per
    class (the cascade stages' heads)."""

    def __init__(self, in_features, fc_out_channels=1024, num_classes=2,
                 num_fcs=2, with_cls=True, num_parcellations=0,
                 reg_class_agnostic=False):
        super().__init__()
        dims = [in_features] + [fc_out_channels] * num_fcs
        self.shared_fcs = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
        )
        self.fc_cls = (
            nn.Linear(fc_out_channels, num_classes) if with_cls else None
        )
        self.fc_reg = nn.Linear(
            fc_out_channels, 6 if reg_class_agnostic else 6 * num_classes)
        self.fc_parcellations = (
            nn.Linear(fc_out_channels, num_parcellations)
            if num_parcellations > 0 else None
        )

    def trunk(self, x):
        x = x.flatten(1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return x

    def forward(self, x):
        x = self.trunk(x)
        if self.fc_parcellations is not None:
            return self.fc_cls(x), self.fc_reg(x), self.fc_parcellations(x)
        return self.fc_cls(x), self.fc_reg(x)


class SharedFCBBoxHead3DRefinement(SharedFCBBoxHead3D):
    """Regression-only refinement head (no classification branch)."""

    def __init__(self, in_features, fc_out_channels=1024, num_classes=2,
                 num_fcs=2):
        super().__init__(in_features, fc_out_channels, num_classes,
                         num_fcs, with_cls=False)

    def forward(self, x):
        return self.fc_reg(self.trunk(x))


class FCNMaskHead3D(nn.Module):
    def __init__(self, channels=64, num_classes=2, num_convs=4,
                 upsample_ratio=2, two_d=False):
        super().__init__()
        k, p = conv3(two_d)
        self.convs = nn.ModuleList(
            [
                ConvModule3D(channels, channels, k, padding=p, relu=True)
                for _ in range(num_convs)
            ]
        )
        r = upsample_ratio
        self.upsample_factor = (1, r, r) if two_d else (r, r, r)
        self.upsample = nn.ConvTranspose3d(
            channels, channels, self.upsample_factor,
            stride=self.upsample_factor
        )
        self.conv_logits = nn.Conv3d(channels, num_classes, 1)

    def forward(self, x):
        for m in self.convs:
            x = m(x)
        x = torch.relu(self.upsample(x))
        return self.conv_logits(x)


class HTCMaskHead3D(FCNMaskHead3D):
    """An FCN mask head with mask information flow: with `res_feat` (the
    previous stage's features after its convs), the input first adds
    `conv_res(res_feat)`.  The first stage never receives one and has no
    `conv_res` (`with_conv_res=False`), as the JAX package's stage 0 has
    no such parameters.  forward returns (logits, features); logits are
    None with `return_logits=False` (an info-flow-only pass)."""

    def __init__(self, channels=64, num_classes=2, num_convs=4,
                 upsample_ratio=2, with_conv_res=True, two_d=False):
        super().__init__(channels, num_classes, num_convs, upsample_ratio,
                         two_d)
        self.conv_res = (ConvModule3D(channels, channels, 1)
                         if with_conv_res else None)

    def forward(self, x, res_feat=None, return_logits=True):
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for m in self.convs:
            x = m(x)
        if not return_logits:
            return None, x
        return self.conv_logits(torch.relu(self.upsample(x))), x


class FusedSemanticHead3D(nn.Module):
    """The fused semantic branch.  Level `fusion_level`'s 1x1x1 lateral
    sets the size; every other level's lateral is resized to it as
    `jax.image.resize(..., "trilinear")` does (antialiased when it
    downsamples, `ops.resize3d.jax_resize`) and added; then `num_convs`
    3x3x3 convs + ReLU, and 1x1x1 convs to the class logits and to the
    embedding.  forward(levels) -> (logits (B, num_classes, d, h, w),
    embedding (B, C, d, h, w)) at the fusion level's size."""

    def __init__(self, channels=64, num_ins=5, fusion_level=1, num_convs=4,
                 num_classes=2, two_d=False):
        super().__init__()
        self.fusion_level = fusion_level
        self.lateral_convs = nn.ModuleList(
            [ConvModule3D(channels, channels, 1) for _ in range(num_ins)])
        k, p = conv3(two_d)
        self.convs = nn.ModuleList(
            [ConvModule3D(channels, channels, k, padding=p, relu=True)
             for _ in range(num_convs)])
        self.conv_logits = nn.Conv3d(channels, num_classes, 1)
        self.conv_embedding = ConvModule3D(channels, channels, 1)

    def forward(self, feats):
        fl = self.fusion_level
        x = self.lateral_convs[fl](feats[fl])
        size = x.shape[2:]
        for i, (f, lateral) in enumerate(zip(feats, self.lateral_convs)):
            if i != fl:
                x = x + jax_resize(lateral(f), size, "trilinear")
        for m in self.convs:
            x = m(x)
        return self.conv_logits(x), self.conv_embedding(x)


class RetinaHead3D(nn.Module):
    """forward(level) -> (cls (B, A * cls_out, d, h, w) sigmoid logits,
    reg (B, A * 6, d, h, w)); `cls_out` is num_classes - 1."""

    def __init__(self, channels=64, stacked_convs=4, num_anchors=1,
                 cls_out_channels=1, two_d=False):
        super().__init__()
        k, p = conv3(two_d)

        def tower():
            return nn.ModuleList(
                [ConvModule3D(channels, channels, k, padding=p, relu=True)
                 for _ in range(stacked_convs)])

        self.cls_convs = tower()
        self.reg_convs = tower()
        self.retina_cls = nn.Conv3d(channels, num_anchors * cls_out_channels,
                                    k, padding=p)
        self.retina_reg = nn.Conv3d(channels, num_anchors * 6, k, padding=p)

    def forward(self, x):
        c, r = x, x
        for cls_conv, reg_conv in zip(self.cls_convs, self.reg_convs):
            c = cls_conv(c)
            r = reg_conv(r)
        return self.retina_cls(c), self.retina_reg(r)


class SSDHead(nn.Module):
    """forward(levels) -> per level (cls (B, A_l * num_classes, d, h, w)
    softmax logits, reg (B, A_l * 6, d, h, w)); `num_anchors` lists A_l
    per level (`mrcnn3d/models/heads.py:265-296`)."""

    def __init__(self, in_channels, num_anchors=(4, 6, 6, 6, 4, 4),
                 num_classes=2, two_d=True):
        super().__init__()
        k, p = conv3(two_d)
        self.cls_convs = nn.ModuleList(
            [nn.Conv3d(c, a * num_classes, k, padding=p)
             for c, a in zip(in_channels, num_anchors)])
        self.reg_convs = nn.ModuleList(
            [nn.Conv3d(c, a * 6, k, padding=p)
             for c, a in zip(in_channels, num_anchors)])

    def forward(self, feats):
        return [(cls(f), reg(f)) for f, cls, reg in
                zip(feats, self.cls_convs, self.reg_convs)]
