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
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import ConvModule3D


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
    `num_parcellations` > 0."""

    def __init__(self, in_features, fc_out_channels=1024, num_classes=2,
                 num_fcs=2, with_cls=True, num_parcellations=0):
        super().__init__()
        dims = [in_features] + [fc_out_channels] * num_fcs
        self.shared_fcs = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
        )
        self.fc_cls = (
            nn.Linear(fc_out_channels, num_classes) if with_cls else None
        )
        self.fc_reg = nn.Linear(fc_out_channels, 6 * num_classes)
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
                 upsample_ratio=2):
        super().__init__()
        self.convs = nn.ModuleList(
            [
                ConvModule3D(channels, channels, 3, padding=1, relu=True)
                for _ in range(num_convs)
            ]
        )
        self.upsample = nn.ConvTranspose3d(
            channels, channels, upsample_ratio, stride=upsample_ratio
        )
        self.conv_logits = nn.Conv3d(channels, num_classes, 1)

    def forward(self, x):
        for m in self.convs:
            x = m(x)
        x = torch.relu(self.upsample(x))
        return self.conv_logits(x)
