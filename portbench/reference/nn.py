"""Plain PyTorch modules of the benchmark's detectors (NCDHW).

A frozen copy of the published architecture as the port builds it
(ResNet3D-50 at base width 16, FPN3D, the RPN, shared-FC bbox, FCN mask,
HTC mask and fused semantic heads), with the port's parameter names, so
one state dict loads into both.  It imports nothing of the program.

Every layer that multiplies (Conv3d, ConvTranspose3d, Linear) passes its
input and weight through `round_operand` first: the identity for the
float32 reference, `fp8` for the control (`set_operand_rounding`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def fp8(x):
    """`x` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude maps to 448), returned in float32."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _same(x):
    return x


class Conv3d(nn.Conv3d):
    round_operand = staticmethod(_same)

    def forward(self, x):
        r = self.round_operand
        return F.conv3d(r(x), r(self.weight), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose3d(nn.ConvTranspose3d):
    round_operand = staticmethod(_same)

    def forward(self, x):
        r = self.round_operand
        return F.conv_transpose3d(r(x), r(self.weight), self.bias,
                                  self.stride, self.padding)


class Linear(nn.Linear):
    round_operand = staticmethod(_same)

    def forward(self, x):
        r = self.round_operand
        return F.linear(r(x), r(self.weight), self.bias)


MULTIPLYING = (Conv3d, ConvTranspose3d, Linear)


def set_operand_rounding(model, fn):
    """Round the operands of every multiplying layer of `model` by fn."""
    for mod in model.modules():
        if isinstance(mod, MULTIPLYING):
            mod.round_operand = fn
    return model


class FrozenBN(nn.Module):
    """BatchNorm with stored statistics: (x - mean) / sqrt(var + eps) *
    weight + bias."""

    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.view(shape) + shift.view(shape)


class ConvModule(nn.Module):
    """Conv3d with bias [+ ReLU], under the name `conv`."""

    def __init__(self, cin, cout, k, padding=0, relu=False):
        super().__init__()
        self.conv = Conv3d(cin, cout, k, padding=padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return torch.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """pytorch-style bottleneck, x4 expansion, the stride on conv2."""

    def __init__(self, cin, planes, stride, with_downsample):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv3d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv3d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv3d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBN(cout)
        self.downsample = nn.Sequential(
            Conv3d(cin, cout, 1, stride=stride, bias=False),
            FrozenBN(cout)) if with_downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STAGE_STRIDES = (1, 2, 2, 2)


class ResNet3D(nn.Module):
    """Stem Conv3d(3, w, 7, stride (1, 2, 2), pad 3), max-pool 3 stride
    2, four bottleneck stages; returns the four stage outputs."""

    def __init__(self, depth=50, base_width=16):
        super().__init__()
        self.conv1 = Conv3d(3, base_width, 7, stride=(1, 2, 2), padding=3,
                            bias=False)
        self.bn1 = FrozenBN(base_width)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)
        cin = base_width
        for i, n in enumerate(DEPTH_BLOCKS[depth]):
            planes = base_width * 2**i
            blocks = []
            for j in range(n):
                stride = STAGE_STRIDES[i] if j == 0 else 1
                down = j == 0 and (stride != 1 or cin != planes * 4)
                blocks.append(Bottleneck(cin, planes, stride, down))
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

    @staticmethod
    def featmap_sizes(shape):
        def conv(n, k, s, p):
            return (n + 2 * p - k) // s + 1

        d, h, w = shape
        h, w = conv(h, 7, 2, 3), conv(w, 7, 2, 3)
        d, h, w = conv(d, 3, 2, 1), conv(h, 3, 2, 1), conv(w, 3, 2, 1)
        sizes = []
        for s in STAGE_STRIDES:
            d, h, w = conv(d, 3, s, 1), conv(h, 3, s, 1), conv(w, 3, s, 1)
            sizes.append((d, h, w))
        return sizes


class FPN3D(nn.Module):
    """1x1x1 laterals, nearest top-down sums, 3x3x3 outputs, extra
    levels by stride-2 subsampling."""

    def __init__(self, in_channels, out_channels, num_outs):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, inputs):
        lat = [m(x) for m, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode="nearest")
        outs = [m(x) for m, x in zip(self.fpn_convs, lat)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2, ::2])
        return outs

    def featmap_sizes(self, stage_sizes):
        sizes = list(stage_sizes)
        while len(sizes) < self.num_outs:
            sizes.append(tuple((n + 1) // 2 for n in sizes[-1]))
        return sizes


class RPNHead(nn.Module):
    def __init__(self, channels, num_anchors):
        super().__init__()
        self.rpn_conv = Conv3d(channels, channels, 3, padding=1)
        self.rpn_cls = Conv3d(channels, num_anchors, 1)
        self.rpn_reg = Conv3d(channels, num_anchors * 6, 1)

    def forward(self, x):
        x = torch.relu(self.rpn_conv(x))
        return self.rpn_cls(x), self.rpn_reg(x)


class BBoxHead(nn.Module):
    """Flatten, two shared fcs + ReLU, fc_cls and fc_reg (6 per class, or
    6 when class-agnostic); without fc_cls it is the refinement head,
    whose output is the deltas alone."""

    def __init__(self, in_features, fc_out, num_classes, with_cls=True,
                 class_agnostic=False):
        super().__init__()
        dims = [in_features, fc_out, fc_out]
        self.shared_fcs = nn.ModuleList(
            [Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])
        self.fc_cls = Linear(fc_out, num_classes) if with_cls else None
        self.fc_reg = Linear(fc_out, 6 if class_agnostic else 6 * num_classes)

    def forward(self, x):
        x = x.flatten(1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        if self.fc_cls is None:
            return self.fc_reg(x)
        return self.fc_cls(x), self.fc_reg(x)


class MaskHead(nn.Module):
    """3x3x3 convs + ReLU, a 2x transposed conv + ReLU, 1x1x1 class
    logits; with `with_conv_res`, HTC's head: the input first adds
    conv_res of the previous stage's features, and forward returns
    (logits, features after the convs)."""

    def __init__(self, channels, num_classes, num_convs=4, htc=False,
                 with_conv_res=False):
        super().__init__()
        self.htc = htc
        self.convs = nn.ModuleList(
            [ConvModule(channels, channels, 3, padding=1, relu=True)
             for _ in range(num_convs)])
        self.upsample = ConvTranspose3d(channels, channels, 2, stride=2)
        self.conv_logits = Conv3d(channels, num_classes, 1)
        if with_conv_res:
            self.conv_res = ConvModule(channels, channels, 1)

    def forward(self, x, res_feat=None):
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for m in self.convs:
            x = m(x)
        logits = self.conv_logits(torch.relu(self.upsample(x)))
        return (logits, x) if self.htc else logits


class SemanticHead(nn.Module):
    """HTC's fused semantic head: the fusion level's 1x1x1 lateral, the
    other levels' laterals resized to its size (jax.image.resize
    trilinear, antialiased when it shrinks) and added; 3x3x3 convs +
    ReLU; 1x1x1 class logits and embedding."""

    def __init__(self, channels, num_ins, fusion_level, num_convs,
                 num_classes, resize):
        super().__init__()
        self.fusion_level = fusion_level
        self.resize = resize
        self.lateral_convs = nn.ModuleList(
            [ConvModule(channels, channels, 1) for _ in range(num_ins)])
        self.convs = nn.ModuleList(
            [ConvModule(channels, channels, 3, padding=1, relu=True)
             for _ in range(num_convs)])
        self.conv_logits = Conv3d(channels, num_classes, 1)
        self.conv_embedding = ConvModule(channels, channels, 1)

    def forward(self, feats):
        fl = self.fusion_level
        x = self.lateral_convs[fl](feats[fl])
        for i, (f, lateral) in enumerate(zip(feats, self.lateral_convs)):
            if i != fl:
                x = x + self.resize(lateral(f), x.shape[2:])
        for m in self.convs:
            x = m(x)
        return self.conv_logits(x), self.conv_embedding(x)
