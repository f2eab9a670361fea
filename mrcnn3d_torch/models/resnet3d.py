"""ResNet3D backbone (NCDHW), reference mmdet/models/backbones/resnet3d.py.

  * width-16 base: stage planes 16/32/64/128; Bottleneck x4 expansion
    (depths 50, 101, 152: stage outputs 64/128/256/512 channels) or
    BasicBlock x1 (depths 18, 34: 16/32/64/128), `ARCH_SETTINGS` as in
    `mrcnn3d/models/resnet3d.py:29-35`;
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

# depth -> (block, blocks per stage)
ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(cin, cout, stride):
    return nn.Sequential(nn.Conv3d(cin, cout, 1, stride=stride, bias=False),
                         FrozenBatchNorm(cout))


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, with_downsample=False,
                 groups=1, width=None):
        super().__init__()
        cout = planes * self.expansion
        width = width or planes
        self.conv1 = nn.Conv3d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv3d(
            width, width, 3, stride=stride, padding=1, groups=groups,
            bias=False
        )
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv3d(width, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm(cout)
        self.downsample = (
            _downsample(cin, cout, stride) if with_downsample else None
        )

    @property
    def strided(self):
        """The conv that carries the block's stride."""
        return self.conv2

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


class BasicBlock3D(nn.Module):
    """Two 3x3x3 convs, the stride on the first (`mrcnn3d/models/
    resnet3d.py:209-250`; its conv2 pads "SAME", at stride 1 padding 1)."""

    expansion = 1

    def __init__(self, cin, planes, stride=1, with_downsample=False):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = (
            _downsample(cin, planes, stride) if with_downsample else None
        )

    @property
    def strided(self):
        return self.conv1

    def forward(self, x, run=None):
        run = run or _call
        identity = x if self.downsample is None else self.downsample[1](
            run(self.downsample[0], x))
        out = torch.relu(self.bn1(run(self.conv1, x)))
        out = self.bn2(run(self.conv2, out))
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
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"{type(self).__name__} depth {depth}: the "
                           f"depths are {sorted(ARCH_SETTINGS)}")
        kind, stage_blocks = self.arch(depth)
        self.base_width = base_width
        self.conv1 = nn.Conv3d(
            3, base_width, 7, stride=(1, 2, 2), padding=3, bias=False
        )
        self.bn1 = FrozenBatchNorm(base_width)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)
        expansion = 4 if kind == "bottleneck" else 1
        cin = base_width
        for i, n in enumerate(stage_blocks):
            planes = base_width * 2**i
            blocks = []
            for j in range(n):
                stride = self.strides[i] if j == 0 else 1
                # the downsample's rule of the JAX stage loop (:393)
                down = j == 0 and (stride != 1 or cin != planes * expansion)
                blocks.append(self.make_block(kind, cin, planes, stride,
                                              down))
                cin = planes * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = [base_width * expansion * 2**i for i in range(4)]

    @staticmethod
    def arch(depth):
        """(block kind, blocks per stage) of `depth`."""
        return ARCH_SETTINGS[depth]

    def make_block(self, kind, cin, planes, stride, with_downsample):
        block = Bottleneck3D if kind == "bottleneck" else BasicBlock3D
        return block(cin, planes, stride, with_downsample)

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
            x = slabs.settle(x, layer[0].strided)
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
