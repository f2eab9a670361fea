"""Separable trilinear volume resize on torch tensors (NCDHW).

Counterpart of `mrcnn3d/ops/resize3d.py`: the host runtime's grid-center
(half-pixel) convention (csrc/host_ops.cpp resize_trilinear: cpos =
(i+0.5)*in/out - 0.5 clamped to [0, in-1], a two-tap lerp per axis),
itself the skimage.transform.resize convention the reference uses to
build the 1.5x twin (reference coco_3d_2scales.py:209-234).  The tiled
driver derives the twin with it on the device instead of uploading it.

The taps are computed in float64 with numpy, as `axis_lerp_matrix` does
(`F.interpolate` computes the source index in float32, which can move a
weight by one bit); each axis is one two-tap lerp in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def axis_taps(out_n: int, in_n: int):
    """(lo, hi) int64 and fr float32 of the grid-center lerp, (out_n,)."""
    i = np.arange(out_n, dtype=np.float64)
    cpos = np.clip((i + 0.5) * in_n / out_n - 0.5, 0.0, in_n - 1)
    lo = np.floor(cpos).astype(np.int64)
    hi = np.minimum(lo + 1, in_n - 1)
    fr = (cpos - lo).astype(np.float32)
    return lo, hi, fr


def axis_lerp_matrix(out_n: int, in_n: int) -> np.ndarray:
    """(out_n, in_n) f32 matrix applying the grid-center 2-tap lerp."""
    lo, hi, fr = axis_taps(out_n, in_n)
    m = np.zeros((out_n, in_n), np.float32)
    m[np.arange(out_n), lo] += 1.0 - fr
    m[np.arange(out_n), hi] += fr
    return m


def _lerp_axis(x, dim, out_n):
    lo, hi, fr = axis_taps(out_n, x.shape[dim])
    shape = [1] * x.ndim
    shape[dim] = out_n
    dev = x.device
    w_lo = torch.from_numpy(1.0 - fr).to(dev).reshape(shape)
    w_hi = torch.from_numpy(fr).to(dev).reshape(shape)
    a = x.index_select(dim, torch.from_numpy(lo).to(dev)).mul_(w_lo)
    b = x.index_select(dim, torch.from_numpy(hi).to(dev)).mul_(w_hi)
    return a.add_(b)


def resize_trilinear_3d(vol, out_dhw):
    """Resize (N, C, D, H, W) -> (N, C, D', H', W') in vol's dtype, the
    lerps in float32 (z, then y, then x).  One channel at a time, so the
    float32 intermediates are those of one channel."""
    od, oh, ow = (int(v) for v in out_dhw)
    *lead, d, h, w = vol.shape
    flat = vol.reshape(-1, d, h, w)
    out = torch.empty((flat.shape[0], od, oh, ow), dtype=vol.dtype,
                      device=vol.device)
    for i in range(flat.shape[0]):
        x = flat[i].float()
        x = _lerp_axis(x, 0, od)
        x = _lerp_axis(x, 1, oh)
        out[i] = _lerp_axis(x, 2, ow)
    return out.reshape(*lead, od, oh, ow)
