"""ResNet3D backbone (NCDHW), reference mmdet/models/backbones/resnet3d.py.

  * width-16 base: stage planes 16/32/64/128, Bottleneck x4 expansion,
    stage outputs 64/128/256/512 channels;
  * stem Conv3d(3, 16, 7, stride (1, 2, 2), padding 3): no depth
    downsampling;
  * isotropic MaxPool3d(3, stride 2, padding 1);
  * pytorch-style Bottleneck (stride on the 3x3x3 conv);
  * frozen BatchNorm.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import FrozenBatchNorm

STAGE_BLOCKS = {50: (3, 4, 6, 3)}


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, with_downsample=False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = nn.Conv3d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv3d(
            planes, planes, 3, stride=stride, padding=1, bias=False
        )
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv3d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm(cout)
        self.downsample = (
            nn.Sequential(
                nn.Conv3d(cin, cout, 1, stride=stride, bias=False),
                FrozenBatchNorm(cout),
            )
            if with_downsample
            else None
        )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


class ResNet3D(nn.Module):
    """Returns the four stage outputs."""

    strides = (1, 2, 2, 2)

    def __init__(self, depth=50, base_width=16):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise NotImplementedError(
                f"ResNet3D depth {depth}: the port has depth 50 only "
                "(ROADMAP Queue A item 11 ports the other depths)"
            )
        self.base_width = base_width
        self.conv1 = nn.Conv3d(
            3, base_width, 7, stride=(1, 2, 2), padding=3, bias=False
        )
        self.bn1 = FrozenBatchNorm(base_width)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)
        cin = base_width
        for i, n in enumerate(STAGE_BLOCKS[depth]):
            planes = base_width * 2**i
            blocks = []
            for j in range(n):
                stride = self.strides[i] if j == 0 else 1
                blocks.append(
                    Bottleneck3D(
                        cin,
                        planes,
                        stride,
                        with_downsample=(
                            j == 0 and (stride != 1 or cin != planes * 4)
                        ),
                    )
                )
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = [base_width * 4 * 2**i for i in range(4)]

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs

    def featmap_sizes(self, shape):
        """Stage output (d, h, w) sizes for an input of (D, H, W)."""

        def conv(n, k, s, p):
            return (n + 2 * p - k) // s + 1

        d, h, w = shape
        h, w = conv(h, 7, 2, 3), conv(w, 7, 2, 3)
        d, h, w = (conv(n, 3, 2, 1) for n in (d, h, w))
        sizes = []
        for s in self.strides:
            d, h, w = (conv(n, 3, s, 1) for n in (d, h, w))
            sizes.append((d, h, w))
        return sizes
