"""Seeded random weights, made on the device in a few large calls.

The keys and shapes are the reference's (`reference.<module>.Detector`),
which are the program's state-dict names.  Kernels are normal of std
1 / sqrt(fan_in), biases zero, frozen-BN statistics drawn near identity
(mean N(0, 0.1), var U(0.8, 1.2)), as the port's inference build draws
them; but each bbox head's classifier (`fc_cls`) is normal of std
CLS_STD, as mmdetection's BBoxHead.init_weights draws it.  So the class
scores sit near 1 / num_classes on every seed and every row passes the
score threshold: drawn at 1 / sqrt(fan_in), the classifier shifted all
rows' scores together by a seed's draw, and the rows that passed (the
detections, and so the mask heads' work) were 2000 on most seeds of the
flagship and about 1100 or a dozen on others.  The weights come out in the type the configuration serves them
in; the program loads them, and the reference loads the same tensors in
float32.
"""
from __future__ import annotations

import math

import torch

from .reference import nn as rnn

CLS_STD = 0.01


def fan_in(mod):
    w = mod.weight
    if isinstance(mod, rnn.ConvTranspose3d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def make_weights(model, seed, device, dtype):
    """{state-dict key: tensor in dtype on device} for `model`."""
    kernels, stats = [], []
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, rnn.MULTIPLYING):
            kernels.append((prefix, mod))
        elif isinstance(mod, rnn.FrozenBN):
            stats.append((prefix, mod))
    gen = torch.Generator(device=device).manual_seed(seed)
    n_norm = sum(m.weight.numel() for _, m in kernels) + sum(
        m.running_mean.numel() for _, m in stats)
    normal = torch.randn(n_norm, generator=gen, device=device)
    uniform = torch.rand(sum(m.running_var.numel() for _, m in stats),
                         generator=gen, device=device)
    out, off, uoff = {}, 0, 0
    for prefix, mod in kernels:
        n = mod.weight.numel()
        std = (CLS_STD if prefix.endswith("fc_cls.")
               else 1 / math.sqrt(fan_in(mod)))
        out[prefix + "weight"] = (normal[off:off + n].view(mod.weight.shape)
                                  * std).to(dtype)
        off += n
        if mod.bias is not None:
            out[prefix + "bias"] = torch.zeros(mod.bias.shape, dtype=dtype,
                                               device=device)
    for prefix, mod in stats:
        n = mod.running_mean.numel()
        out[prefix + "running_mean"] = (normal[off:off + n] * 0.1).to(dtype)
        out[prefix + "running_var"] = (uniform[uoff:uoff + n] * 0.4
                                       + 0.8).to(dtype)
        out[prefix + "weight"] = torch.ones(n, dtype=dtype, device=device)
        out[prefix + "bias"] = torch.zeros(n, dtype=dtype, device=device)
        off += n
        uoff += n
    return out
