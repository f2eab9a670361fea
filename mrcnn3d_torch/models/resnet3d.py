"""ResNet3D backbone (NCDHW), reference mmdet/models/backbones/resnet3d.py.

  * width-16 base: stage planes 16/32/64/128, Bottleneck x4 expansion,
    stage outputs 64/128/256/512 channels;
  * stem Conv3d(3, 16, 7, stride (1, 2, 2), padding 3): no depth
    downsampling;
  * isotropic MaxPool3d(3, stride 2, padding 1);
  * pytorch-style Bottleneck (stride on the 3x3x3 conv);
  * frozen BatchNorm.

Depth sharding (`parallel/spatial.py`, the counterpart of
`mrcnn3d/models/resnet3d.py:306-340`): with `depth_slabs` set, each rank
of its group runs the backbone on a depth slab of the volume; every conv
and pool with a depth extent goes through `depth_slabs.apply` (the halo
exchange), a stage falls back to the whole volume once its depth stops
dividing the group, and the stage outputs come back whole.
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

    def forward(self, x, run=None):
        """run(op, x): how a conv with a depth extent is applied (the
        depth slabs' halo exchange); op(x) by default."""
        run = run or _call
        identity = x if self.downsample is None else self.downsample[1](
            run(self.downsample[0], x))
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(run(self.conv2, out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


def _call(op, x):
    return op(x)


class _Whole:
    """The backbone's pass when it is not depth-sharded: every
    activation whole, each op applied as it is (the interface of
    `parallel.spatial.DepthSlabs`)."""

    @staticmethod
    def split(x):
        return x

    @staticmethod
    def settle(x, op):
        return x

    @staticmethod
    def whole(x):
        return x

    apply = staticmethod(_call)


class ResNet3D(nn.Module):
    """Returns the four stage outputs."""

    strides = (1, 2, 2, 2)
    # a `parallel.spatial.DepthSlabs` while the backbone runs depth-sharded
    depth_slabs = None

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
        """The four stage outputs of `x`; with `depth_slabs` set, each
        rank of its group runs on its depth slab of `x` (the whole
        volume on every rank) and the outputs come back whole."""
        slabs = self.depth_slabs or _Whole
        x = slabs.split(x)
        x = torch.relu(self.bn1(slabs.apply(self.conv1, x)))
        x = slabs.settle(x, self.maxpool)
        x = slabs.apply(self.maxpool, x)
        outs = []
        for i in range(4):
            layer = getattr(self, f"layer{i + 1}")
            x = slabs.settle(x, layer[0].conv2)
            for block in layer:
                x = block(x, slabs.apply)
            outs.append(slabs.whole(x))
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
