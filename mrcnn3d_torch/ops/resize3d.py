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


# ---------------------------------------------------------------------------
# jax.image.resize semantics (the fused semantic head's laterals, the
# semantic target's downsample)
# ---------------------------------------------------------------------------


def antialias_taps(out_n: int, in_n: int) -> np.ndarray:
    """(out_n, in_n) f32 weights of `jax.image.resize(..., "trilinear")`
    along one axis (jax `_compute_weight_mat` with antialias): a triangle
    kernel at the half-pixel sample (i + 0.5) * in / out - 0.5, widened by
    in / out when it downsamples (a box-filtered lerp, not a two-tap
    one), each row normalised to sum 1.  Computed in float64."""
    inv = in_n / out_n
    width = max(inv, 1.0)
    sample = (np.arange(out_n, dtype=np.float64) + 0.5) * inv - 0.5
    dist = np.abs(sample[:, None] - np.arange(in_n, dtype=np.float64)[None])
    w = np.maximum(0.0, 1.0 - dist / width)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_n - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def nearest_index(out_n: int, in_n: int) -> np.ndarray:
    """(out_n,) source index of `jax.image.resize(..., "nearest")`:
    floor((i + 0.5) * in / out) in float32, as jax computes it (torch's
    'nearest-exact', not its 'nearest')."""
    i = np.arange(out_n, dtype=np.float32) + np.float32(0.5)
    return np.floor(i * np.float32(in_n) / np.float32(out_n)).astype(
        np.int64)


def jax_resize(x, out_dhw, method):
    """`jax.image.resize` of the last three axes of `x` (…, D, H, W) to
    `out_dhw`: "trilinear" (antialiased when it downsamples) as one
    contraction per axis with `antialias_taps`, in x's dtype; "nearest" as
    a gather by `nearest_index`.  Axes of equal size are left alone, as
    jax leaves them."""
    if method not in ("trilinear", "nearest"):
        raise ValueError(f"resize method {method!r}")
    nd = x.dim()
    for axis, out_n in zip(range(nd - 3, nd), out_dhw):
        in_n = x.shape[axis]
        if int(out_n) == in_n:
            continue
        if method == "nearest":
            idx = torch.from_numpy(nearest_index(int(out_n), in_n))
            x = x.index_select(axis, idx.to(x.device))
        else:
            w = torch.from_numpy(antialias_taps(int(out_n), in_n)).to(
                device=x.device, dtype=x.dtype)
            x = torch.movedim(torch.movedim(x, axis, -1) @ w.t(), -1, axis)
    return x
