"""FPN3D neck (NCDHW), reference mmdet/models/necks/fpn3d.py:10-134.

  * 1x1x1 lateral convs (bias, no norm), then top-down nearest
    interpolation to the explicit lateral size (odd sizes included);
  * 3x3x3 output convs;
  * extra levels by stride-2 subsampling -- the reference's
    max_pool3d(kernel=1, stride=2) is exactly x[:, :, ::2, ::2, ::2].
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import ConvModule3D


class FPN3D(nn.Module):
    def __init__(self, in_channels, out_channels=64, num_outs=5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule3D(c, out_channels, 1) for c in in_channels]
        )
        self.fpn_convs = nn.ModuleList(
            [
                ConvModule3D(out_channels, out_channels, 3, padding=1)
                for _ in in_channels
            ]
        )

    def forward(self, inputs):
        laterals = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest"
            )
        outs = [m(x) for m, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2, ::2])
        return outs

    def featmap_sizes(self, stage_sizes):
        sizes = list(stage_sizes)
        while len(sizes) < self.num_outs:
            sizes.append(tuple((n + 1) // 2 for n in sizes[-1]))
        return sizes


class FPN3D2Scales(nn.Module):
    """The fused two-resolution FPN (reference necks/fpn3d_2scales.py;
    `mrcnn3d/models/fpn3d.py:85-141`): the two pathways' stages
    interleaved into one top-down chain, coarse to fine by resolution --
    laterals [lat2_0, lat_0, lat2_1, lat_1, ...], lat2_i from the 1.5x
    inputs -- with one 1x1x1 lateral and one 3x3x3 output conv per slot,
    nearest top-down resizes to the next lateral's size, and extra
    levels subsampled from outs[-2], not outs[-1].  No detector type
    builds it."""

    def __init__(self, in_channels, in_channels_2, out_channels=64,
                 num_outs=8, start_level=0):
        super().__init__()
        self.num_outs = num_outs
        self.start_level = start_level
        chans = []
        for c1, c2 in zip(in_channels[start_level:],
                          in_channels_2[start_level:]):
            chans += [c2, c1]
        self.lateral_convs = nn.ModuleList(
            [ConvModule3D(c, out_channels, 1) for c in chans])
        self.fpn_convs = nn.ModuleList(
            [ConvModule3D(out_channels, out_channels, 3, padding=1)
             for _ in chans])

    def forward(self, inputs, inputs_2):
        srcs = []
        for x1, x2 in zip(inputs[self.start_level:],
                          inputs_2[self.start_level:]):
            srcs += [x2, x1]
        laterals = [m(x) for m, x in zip(self.lateral_convs, srcs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest"
            )
        outs = [m(x) for m, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-2][:, :, ::2, ::2, ::2])
        return outs
