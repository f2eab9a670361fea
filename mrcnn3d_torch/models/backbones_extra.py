"""The other backbones (NCDHW): UNet3D, ResNeXt3D and SSD's VGG16.

Port of `mrcnn3d/models/backbones_extra.py`:
  * UNet3D -- a 3-D U-Net of `num_levels` levels (two biased 3x3x3 convs
    with ReLU per level, 2x2x2 max pooling down, a repeat by 2 along
    each axis cropped to the skip's size up, `enc{i}_conv{j}` and
    `dec{i}_conv{j}`) whose decoder taps, fine to coarse, feed the FPN
    (the reference's unet3d.py returns one fused map; the JAX package
    exposes the taps, so the FPN and heads apply unchanged).  Its finest
    tap has stride 1.
  * ResNeXt3D -- ResNet3D with grouped 3x3x3 convs (reference
    resnext3d.py): BottleneckX3D's conv2 has `groups` groups of width
    max(int(planes * base_width / 64) * groups, groups).  `two_d` is
    ResNet3D's 2-D mode (`mrcnn3d/models/backbones_extra.py:73-82,
    :131-170`); neither backbone reads `with_cp`, as in the JAX package.
  * SSDVGG -- SSD's VGG16 on depth-1 maps (`:183-319`; reference
    ssd_vgg.py): (1, 3, 3) convs with ceil-mode (1, 2, 2) pools, a
    (1, 3, 3) stride-1 pool5, the dilated fc6 and fc7, then the extra
    pyramid; outputs L2Norm(conv4_3), fc7 and every second extra layer:
    6 maps (38/19/10/5/3/1) for input 300, 7 for input 512.  Named as
    mmdet names them: `features.{i}` at the torch Sequential's indices
    (fc6 `features.31`, fc7 `features.33`), `extra.{i}`, `l2_norm`.
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
                 groups=32, base_width=4, two_d=False):
        width = max(int(planes * (base_width / 64.0)) * groups, groups)
        super().__init__(cin, planes, stride, with_downsample,
                         groups=groups, width=width, two_d=two_d)


class ResNeXt3D(ResNet3D):
    """ResNet3D of BottleneckX3D blocks at the depth's stage counts (at
    every depth, as the JAX package builds it); `width` is the stem's
    channels (ResNet3D's base_width), `base_width` the ResNeXt width per
    group at 64 planes."""

    def __init__(self, depth=50, groups=32, base_width=4, width=16,
                 two_d=False):
        self.groups = groups
        self.group_width = base_width
        super().__init__(depth=depth, base_width=width, two_d=two_d)

    @staticmethod
    def arch(depth):
        return "bottleneck", ARCH_SETTINGS[depth][1]

    def make_block(self, kind, cin, planes, stride, with_downsample):
        return BottleneckX3D(cin, planes, stride, with_downsample,
                             self.groups, self.group_width, self.two_d)


class L2Norm(nn.Module):
    """Per-channel L2 normalisation with a learned scale (reference
    ssd_vgg.py:119-134, init 20): the norm over channels taken in float32,
    then cast to the input's type, as the JAX package takes it."""

    def __init__(self, channels, scale=20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        norm = torch.sqrt(x.float().square().sum(1, keepdim=True) + 1e-10)
        w = self.weight.to(x.dtype)[None, :, None, None, None]
        return x / norm.to(x.dtype) * w


# extra-layer channel plans per input size (reference ssd_vgg.py:16-17)
SSD_EXTRA = {
    300: (256, "S", 512, 128, "S", 256, 128, 256, 128, 256),
    512: (256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256),
}
VGG16_PLAN = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _conv2d(cin, cout, k, stride=1, pad=0, dilation=1):
    """A (1, k, k) conv: an exact 2-D conv on depth-1 maps."""
    return nn.Conv3d(cin, cout, (1, k, k), (1, stride, stride),
                     (0, pad, pad), (1, dilation, dilation))


class SSDVGG(nn.Module):
    """SSD's VGG16 backbone and extra pyramid (see the module's
    docstring).  The pools are nn.MaxPool3d modules, as the ResNets'
    stem pools are."""

    def __init__(self, input_size=300):
        super().__init__()
        self.input_size = input_size
        layers, cin = [], 3
        for si, (n_convs, ch) in enumerate(VGG16_PLAN):
            for _ in range(n_convs):
                layers += [_conv2d(cin, ch, 3, pad=1), nn.ReLU()]
                cin = ch
            if si < 4:
                # ceil mode: an odd extent's last row is pooled alone, as
                # the JAX package's -inf padding on the right pools it
                layers.append(nn.MaxPool3d((1, 2, 2), (1, 2, 2),
                                           ceil_mode=True))
            else:
                layers.append(nn.MaxPool3d((1, 3, 3), 1, (0, 1, 1)))
        # conv4_3's relu output, taken before its pool
        self.conv4_3 = 22
        layers += [_conv2d(512, 1024, 3, pad=6, dilation=6), nn.ReLU(),
                   _conv2d(1024, 1024, 1), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        self.extra = nn.ModuleList()
        self.extra_out = []
        cin, i = 1024, 0
        plan = SSD_EXTRA[input_size]
        while i < len(plan):
            ei = len(self.extra)
            if plan[i] == "S":
                self.extra.append(_conv2d(cin, plan[i + 1], 3, 2, 1))
                cin = plan[i + 1]
                i += 2
            else:
                self.extra.append(_conv2d(cin, plan[i],
                                          1 if ei % 2 == 0 else 3))
                cin = plan[i]
                i += 1
            if ei % 2 == 1:
                self.extra_out.append(ei)
        if input_size == 512:
            self.extra_out.append(len(self.extra))
            self.extra.append(_conv2d(cin, 256, 4, pad=1))
        self.l2_norm = L2Norm(512)
        self.out_channels = [512, 1024] + [
            self.extra[ei].out_channels for ei in self.extra_out]

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == self.conv4_3:
                outs.append(self.l2_norm(x))
        outs.append(x)
        for ei, conv in enumerate(self.extra):
            x = torch.relu(conv(x))
            if ei in self.extra_out:
                outs.append(x)
        return outs

    def featmap_sizes(self, shape):
        """Output (d, h, w) sizes for an input of (D, H, W): conv4_3 after
        three ceil-mode halvings, fc7 after four, then each extra conv's
        arithmetic."""
        d, h, w = shape
        sizes = []
        for k in range(4):
            if k == 3:
                sizes.append((d, h, w))
            h, w = -(-h // 2), -(-w // 2)
        sizes.append((d, h, w))
        for ei, conv in enumerate(self.extra):
            (kh, kw), (sh, sw), (ph, pw) = (conv.kernel_size[1:],
                                            conv.stride[1:], conv.padding[1:])
            h = (h + 2 * ph - kh) // sh + 1
            w = (w + 2 * pw - kw) // sw + 1
            if ei in self.extra_out:
                sizes.append((d, h, w))
        return sizes
