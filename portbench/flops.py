"""Model FLOPs of one request, counted from the configuration and the
shapes: 2 * output voxels * Cin/groups * Cout * k^3 per convolution (a
transposed one: per input voxel), 2 * rows * in * out per linear layer,
with the heads at the rows the static shapes hold (the proposal and
detection budgets).  The reference's modules run on the meta device, so
nothing is computed; RoIAlign, NMS and the elementwise work are not
counted.
"""
from __future__ import annotations

import math

import torch

from .reference import nn as rnn


class FlopCounter:
    def __init__(self):
        self.flops = 0
        self._handles = []

    def _hook(self, mod, inp, out):
        x = inp[0]
        k = math.prod(mod.weight.shape[2:]) if mod.weight.dim() > 2 else 1
        if isinstance(mod, rnn.ConvTranspose3d):
            self.flops += 2 * x.numel() * mod.out_channels * k
        elif isinstance(mod, rnn.Conv3d):
            self.flops += (2 * out.numel() * (mod.in_channels // mod.groups)
                           * k)
        else:
            self.flops += 2 * x.numel() * mod.out_features

    def __enter__(self):
        return self

    def attach(self, model):
        for mod in model.modules():
            if isinstance(mod, rnn.MULTIPLYING):
                self._handles.append(mod.register_forward_hook(self._hook))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        return False


def meta(*shape):
    return torch.empty(shape, device="meta")


def request_flops(reference, cfg, batch_shapes):
    """FLOPs of one request of (1, 3, D, H, W) inputs `batch_shapes`
    (key -> shape) through the configuration's reference module's
    `flop_plan`, on the meta device."""
    model = reference.Detector(cfg).to("meta")
    with torch.no_grad(), FlopCounter().attach(model) as counter:
        reference.flop_plan(model, cfg, batch_shapes, meta)
    return counter.flops
