"""The H100's published peaks and the work of the port's two kernels.

Peaks: NVIDIA's H100 SXM data sheet, dense: 3.35 TB/s of HBM, 67
TFLOP/s of float32 outside the tensor cores, 989 TFLOP/s of bf16 on
them.  A kernel's bound is the larger of its bytes over the bandwidth
and its operations over the float32 peak, its inputs read and its
outputs written once (the arithmetic of the repository's chip_smoke.py
`bound`, `nms_case` and `align_geometry`, copied here).
"""
from __future__ import annotations

import torch

from .reference import ops

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_FLOPS_PER_S = 989e12
# f32 operations of one symmetric IoU and its threshold test
IOU_OPS = 28


def bound_s(nbytes, nops):
    """The least time for that work, seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_FP32_OPS_PER_S)


def k1_work(counts):
    """K1 over segments of `counts` rows: (bytes, operations).  Boxes
    (6 float32) and valid flags in, keep flags out; one IoU per pair of
    rows in a segment."""
    total = sum(counts)
    nbytes = total * (6 * 4 + 1) + total
    nops = sum(k * (k - 1) // 2 for k in counts) * IOU_OPS
    return nbytes, nops


def _span(low, high, inr):
    big = torch.iinfo(low.dtype).max
    first = torch.where(inr, low, big).min(1).values
    last = torch.where(inr, high, -1).max(1).values
    return first, torch.where(last >= 0, last - first + 1, 0)


def k2_work(level_shapes, elt, rois, levels, valid, out, out_d, strides,
            strides_d, sn):
    """K2 on one launch's arguments: (bytes, operations).  Bytes: the
    feature voxels the valid rois' taps touch (the union over rois, each
    voxel once), the rois, levels and valid flags, the output.
    Operations: the separable form over each roi's touched window (four
    per tap and channel along y then x, per distinct z plane, and four
    per output bin and tap for the z fold).

    level_shapes: (B, D, H, W, C) of each level; elt: bytes a value."""
    c = level_shapes[0][-1]
    sel = valid.bool().cpu()
    r, lv = rois.cpu()[sel].float(), levels.cpu()[sel].long()
    dims = torch.tensor([s[1:4] for s in level_shapes])[lv]
    inv = torch.tensor([[1.0 / s, 1.0 / sd] for s, sd in
                        zip(strides, strides_d)])[lv]
    taps = []
    for lo_col, hi_col, dim, scale, pooled in (
            (1, 3, dims[:, 2], inv[:, 0], out),
            (2, 4, dims[:, 1], inv[:, 0], out),
            (5, 6, dims[:, 0], inv[:, 1], out_d)):
        lo = r[:, lo_col] * scale
        ext = ((r[:, hi_col] + 1.0) * scale - lo).clamp(min=0.0)
        taps.append(ops.interp(ops.axis_samples(lo, ext, pooled, sn), dim))
    (xl, xh, _, _, xin), (yl, yh, _, _, yin), (zl, zh, _, _, zin) = taps
    x0, nx = _span(xl, xh, xin)
    y0, ny = _span(yl, yh, yin)
    z0, nz = _span(zl, zh, zin)
    zs = torch.stack([zl, zh], -1).reshape(r.shape[0], out_d, 2 * sn)
    zs = torch.where(zin.reshape(r.shape[0], out_d, sn)
                     .repeat_interleave(2, -1), zs, -1).sort(-1).values
    planes = ((zs[..., 1:] != zs[..., :-1]) & (zs[..., 1:] >= 0)).sum(-1) \
        + (zs[..., 0] >= 0)
    empty = (nx == 0) | (ny == 0)
    rows = torch.where(empty, 0, ny)[:, None]
    nops = int((c * (planes * rows * out * 4 * sn
                     + (planes > 0) * (~empty)[:, None] * out * out * 4 * sn))
               .sum())
    touched = 0
    for lvl, shape in enumerate(level_shapes):
        on = (lv == lvl) & ~empty & (nz > 0)
        if not bool(on.any()):
            continue
        mark = torch.zeros(tuple(shape[:4]), dtype=torch.bool)
        for b, zz, yy, xx, dz, dy, dx in zip(*(
                v[on].tolist() for v in (r[:, 0].long(), z0, y0, x0, nz,
                                         ny, nx))):
            mark[b, zz:zz + dz, yy:yy + dy, xx:xx + dx] = True
        touched += int(mark.sum()) * c * elt
    n = rois.shape[0]
    nbytes = touched + n * 7 * 4 + n * 5 + n * c * out_d * out * out * elt
    return nbytes, nops
