"""Shared NN building blocks (NCDHW).

FrozenBatchNorm is the reference's BatchNorm3d under `norm_eval=True`
(resnet3d.py:480-486): the running statistics are never updated, so the
layer is an affine map with stored (mean, var).  ConvModule3D keeps the
reference's `.conv` child name, so state_dict keys read
`neck.lateral_convs.0.conv.weight` as in the reference checkpoints.
"""
from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm evaluated with stored statistics (never updated)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        # (x - mean) * inv + bias, with inv = rsqrt(var + eps) * weight,
        # folded into one scale and shift computed in float32
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        inv = inv * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class ConvModule3D(nn.Module):
    """Conv3d with bias [+ ReLU] under the reference's `.conv` name."""

    def __init__(self, cin, cout, kernel_size, padding=0, relu=False):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel_size, padding=padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return torch.relu(x) if self.relu else x
