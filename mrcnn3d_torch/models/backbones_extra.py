"""The other 3-D backbones (NCDHW): UNet3D and ResNeXt3D.

Port of the 3-D half of `mrcnn3d/models/backbones_extra.py`:
  * UNet3D -- a 3-D U-Net of `num_levels` levels (two biased 3x3x3 convs
    with ReLU per level, 2x2x2 max pooling down, a repeat by 2 along
    each axis cropped to the skip's size up, `enc{i}_conv{j}` and
    `dec{i}_conv{j}`) whose decoder taps, fine to coarse, feed the FPN
    (the reference's unet3d.py returns one fused map; the JAX package
    exposes the taps, so the FPN and heads apply unchanged).  Its finest
    tap has stride 1.
  * ResNeXt3D -- ResNet3D with grouped 3x3x3 convs (reference
    resnext3d.py): BottleneckX3D's conv2 has `groups` groups of width
    max(int(planes * base_width / 64) * groups, groups).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet3d import ARCH_SETTINGS, Bottleneck3D, ResNet3D


class UNet3D(nn.Module):
    """Returns `num_levels` maps, fine to coarse: level i has
    base_channels * 2**i channels at stride 2**i."""

    def __init__(self, base_channels=16, num_levels=4):
        super().__init__()
        self.num_levels = num_levels
        widths = [base_channels * 2**i for i in range(num_levels)]
        cin = 3
        for i, c in enumerate(widths):
            for j in range(2):
                setattr(self, f"enc{i}_conv{j}",
                        nn.Conv3d(cin, c, 3, padding=1))
                cin = c
        for i in range(num_levels - 2, -1, -1):
            # the up-sampled coarser map, then the skip
            cin = widths[i + 1] + widths[i]
            for j in range(2):
                setattr(self, f"dec{i}_conv{j}",
                        nn.Conv3d(cin, widths[i], 3, padding=1))
                cin = widths[i]
        self.pool = nn.MaxPool3d(2, stride=2)
        self.out_channels = widths

    def _convs(self, x, prefix):
        for j in range(2):
            x = torch.relu(getattr(self, f"{prefix}_conv{j}")(x))
        return x

    def forward(self, x):
        skips = []
        for i in range(self.num_levels):
            x = self._convs(x, f"enc{i}")
            skips.append(x)
            if i < self.num_levels - 1:
                x = self.pool(x)
        outs = [x]
        for i in range(self.num_levels - 2, -1, -1):
            d, h, w = skips[i].shape[2:]
            # nearest at scale 2 is the repeat by 2 along each axis
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            x = torch.cat([up[:, :, :d, :h, :w], skips[i]], dim=1)
            x = self._convs(x, f"dec{i}")
            outs.append(x)
        return outs[::-1]

    def featmap_sizes(self, shape):
        """Tap (d, h, w) sizes, fine to coarse, for an input of (D, H, W)."""
        sizes = [tuple(shape)]
        for _ in range(self.num_levels - 1):
            sizes.append(tuple(n // 2 for n in sizes[-1]))
        return sizes


class BottleneckX3D(Bottleneck3D):
    """The ResNeXt bottleneck: Bottleneck3D with a grouped conv2."""

    def __init__(self, cin, planes, stride=1, with_downsample=False,
                 groups=32, base_width=4):
        width = max(int(planes * (base_width / 64.0)) * groups, groups)
        super().__init__(cin, planes, stride, with_downsample,
                         groups=groups, width=width)


class ResNeXt3D(ResNet3D):
    """ResNet3D of BottleneckX3D blocks at the depth's stage counts (at
    every depth, as the JAX package builds it); `width` is the stem's
    channels (ResNet3D's base_width), `base_width` the ResNeXt width per
    group at 64 planes."""

    def __init__(self, depth=50, groups=32, base_width=4, width=16):
        self.groups = groups
        self.group_width = base_width
        super().__init__(depth=depth, base_width=width)

    @staticmethod
    def arch(depth):
        return "bottleneck", ARCH_SETTINGS[depth][1]

    def make_block(self, kind, cin, planes, stride, with_downsample):
        return BottleneckX3D(cin, planes, stride, with_downsample,
                             self.groups, self.group_width)
