"""Multi-level RoIAlign3D: the K2 kernel wrapper and its plain version.

Semantics of `mrcnn3d/ops/roi_align3d.py:multi_level_roi_align_3d`
(reference roi_align_kernel.cu ROIAlignForward3D and
bilinear_interpolate_3d, level choice of single_level.py:73-81):

  * roi_start = coord * scale, roi_end = (coord + 1) * scale (+1 extent),
    extents clamped to >= 0, bin = extent / pooled;
  * `sample_num` samples per bin per axis at
    start + p*bin + (i + .5) * bin / sample_num, averaged;
  * trilinear interpolation with the CUDA edge rules: a coordinate
    below -1 or above dim contributes 0, coordinates <= 0 clamp to 0,
    a low index >= dim-1 collapses onto the edge voxel;
  * separate scales for xy and depth; each roi reads one FPN level.

`multi_level_roi_align_3d` takes NCDHW levels, views them as
(B, D, H, W, C) (free for the channels_last_3d features the detector
produces) and returns (N, C, out_d, out, out).  For CUDA tensors it
launches `csrc/roi_align3d.cu` once for all levels (`roi_align_3d_cuda`,
counted in `launches`, and each valid roi by its path in `path_rois`);
for CPU tensors it runs `roi_align_3d_plain`.

When a level requires a gradient, the align goes through
`RoIAlign3DFunction`, differentiable with respect to the levels only
(the rois are detached boxes in every caller): the forward is the same
K2 launch, the backward one launch of the backward kernel in the same
source (`roi_align_3d_backward_cuda`, counted in `backward_launches`),
or `roi_align_3d_backward_plain` on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda

launches = 0
backward_launches = 0
# per card: int64 (2,) counts of valid rois by the path K2 took for them
# (window, direct), added to by the kernel itself (no synchronisation)
path_rois: dict = {}

# a K2 block takes up to CHANNEL_BLOCK channels of one roi; its dynamic
# shared memory is the window path's budget.  Four blocks fit on an H100
# SM (228 KB, 1 KB reserved per block, ~4.7 KB of static tap and plane
# tables each).
CHANNEL_BLOCK = 32
WINDOW_BYTES = 51 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bytes of float32 work space the plain version allows per roi chunk
_PLAIN_CHUNK_BYTES = 1 << 28


def map_roi_levels(rois, num_levels, finest_scale=56):
    """Per-roi FPN level: floor(log2(sqrt(w*h*d) / finest + 1e-6)),
    clamped to [0, num_levels - 1]."""
    scale = torch.sqrt(
        (rois[:, 3] - rois[:, 1] + 1)
        * (rois[:, 4] - rois[:, 2] + 1)
        * (rois[:, 6] - rois[:, 5] + 1)
    )
    target = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    # a negative extent makes the root NaN; XLA converts NaN to level 0
    target = torch.nan_to_num(target, nan=0.0)
    return target.clamp(0, num_levels - 1).to(torch.int32)


def _axis_samples(lo, ln, pooled, sample_num):
    """(N,) origin and extent -> (N, pooled * sample_num) coordinates."""
    dev = lo.device
    bin_size = ln / pooled
    p = torch.arange(pooled, dtype=torch.float32, device=dev)
    s = (torch.arange(sample_num, dtype=torch.float32, device=dev) + 0.5)
    s = s / sample_num
    offs = p[:, None] + s[None, :]
    coords = lo[:, None, None] + bin_size[:, None, None] * offs[None]
    return coords.reshape(coords.shape[0], pooled * sample_num)


def _interp(coord, dim):
    """CUDA edge rules for coords (N, S) against per-roi dims (N,)."""
    dim = dim[:, None]
    in_range = (coord >= -1.0) & (coord <= dim.to(coord.dtype))
    c = coord.clamp(min=0.0)
    low = torch.floor(c).long()
    at_edge = low >= dim - 1
    low = torch.where(at_edge, dim - 1, low)
    high = torch.where(at_edge, dim - 1, low + 1)
    c = torch.where(at_edge, low.to(c.dtype), c)
    frac = c - low.to(c.dtype)
    return low, high, 1.0 - frac, frac, in_range


def _check_levels(feats_cl):
    ref = feats_cl[0]
    for f in feats_cl:
        if f.dim() != 5 or f.shape[0] != ref.shape[0] \
                or f.shape[4] != ref.shape[4] or f.dtype != ref.dtype:
            raise ValueError(
                "levels must be (B, D, H, W, C) with one B, C and dtype"
            )


def _plain_samples(level_shapes, rois, levels, valid, out_size,
                   out_size_depth, featmap_strides, featmap_strides_depth,
                   sample_num):
    """The plain version's samples, over roi chunks: yields (s0, s1,
    corners, ok) for the rois s0:s1, where corners are the 8 trilinear
    corners (voxel index into the levels' concatenated (voxels, C) rows,
    weight), each (m, out_d*sn, out*sn, out*sn), and ok the samples that
    count (in range on every axis, valid roi).

    level_shapes: the (B, D, H, W, C) shape of each level."""
    dev = rois.device
    c = level_shapes[0][-1]
    n = rois.shape[0]
    sn = sample_num
    o, od = out_size, out_size_depth
    dims = torch.tensor([s[1:4] for s in level_shapes], device=dev)
    sizes = [math.prod(s[:4]) for s in level_shapes]
    offsets = torch.tensor(
        [sum(sizes[:i]) for i in range(len(sizes))], device=dev
    )
    inv_xy = torch.tensor(
        [1.0 / s for s in featmap_strides], dtype=torch.float32, device=dev
    )
    inv_d = torch.tensor(
        [1.0 / s for s in featmap_strides_depth], dtype=torch.float32,
        device=dev,
    )
    samples = od * sn * (o * sn) ** 2
    chunk = max(1, _PLAIN_CHUNK_BYTES // (3 * samples * c * 4))
    for s0 in range(0, n, chunk):
        r = rois[s0:s0 + chunk]
        t = levels[s0:s0 + chunk].long()
        dim_d, dim_h, dim_w = dims[t, 0], dims[t, 1], dims[t, 2]
        sc, scd = inv_xy[t], inv_d[t]
        start_w = r[:, 1] * sc
        start_h = r[:, 2] * sc
        end_w = (r[:, 3] + 1.0) * sc
        end_h = (r[:, 4] + 1.0) * sc
        start_d = r[:, 5] * scd
        end_d = (r[:, 6] + 1.0) * scd
        xs = _axis_samples(start_w, (end_w - start_w).clamp(min=0.0), o, sn)
        ys = _axis_samples(start_h, (end_h - start_h).clamp(min=0.0), o, sn)
        zs = _axis_samples(start_d, (end_d - start_d).clamp(min=0.0), od, sn)
        xl, xh, wxl, wxh, xin = _interp(xs, dim_w)
        yl, yh, wyl, wyh, yin = _interp(ys, dim_h)
        zl, zh, wzl, wzh, zin = _interp(zs, dim_d)
        base = offsets[t] + r[:, 0].long() * dim_d * dim_h * dim_w
        base = base[:, None, None, None]
        hh = dim_h[:, None, None, None]
        ww = dim_w[:, None, None, None]
        corners = []
        for zi, wz in ((zl, wzl), (zh, wzh)):
            for yi, wy in ((yl, wyl), (yh, wyh)):
                for xi, wx in ((xl, wxl), (xh, wxh)):
                    idx = base + (
                        zi[:, :, None, None] * hh + yi[:, None, :, None]
                    ) * ww + xi[:, None, None, :]
                    w = (wz[:, :, None, None] * wy[:, None, :, None]) \
                        * wx[:, None, None, :]
                    corners.append((idx, w))
        ok = zin[:, :, None, None] & yin[:, None, :, None] \
            & xin[:, None, None, :]
        ok = ok & valid[s0:s0 + chunk, None, None, None]
        yield s0, s0 + r.shape[0], corners, ok


def roi_align_3d_plain(feats_cl, rois, levels, valid, out_size,
                       out_size_depth, featmap_strides,
                       featmap_strides_depth, sample_num=2):
    """Plain version of the kernel, in float32, over roi chunks.

    feats_cl: list of (B, D, H, W, C) levels; rois (N, 7) float32
    [b, x1, y1, x2, y2, z1, z2]; levels (N,) int; valid (N,) bool.
    Returns (N, C, out_d, out, out) in the features' dtype.
    """
    _check_levels(feats_cl)
    c = feats_cl[0].shape[-1]
    sn = sample_num
    o, od = out_size, out_size_depth
    flat = torch.cat([f.reshape(-1, c) for f in feats_cl])
    out = torch.zeros((rois.shape[0], c, od, o, o), dtype=flat.dtype,
                      device=rois.device)
    for s0, s1, corners, ok in _plain_samples(
            [f.shape for f in feats_cl], rois, levels, valid, o, od,
            featmap_strides, featmap_strides_depth, sn):
        acc = None
        for idx, w in corners:
            v = flat[idx.reshape(-1)].reshape(*idx.shape, c).float()
            term = v * w[..., None]
            acc = term if acc is None else acc + term
        acc = torch.where(ok[..., None], acc, 0.0)
        acc = acc.reshape(s1 - s0, od, sn, o, sn, o, sn, c).mean(
            dim=(2, 4, 6))
        out[s0:s1] = acc.permute(0, 4, 1, 2, 3).to(flat.dtype)
    return out


def roi_align_3d_backward_plain(grad_out, level_shapes, rois, levels, valid,
                                out_size, out_size_depth, featmap_strides,
                                featmap_strides_depth, sample_num=2):
    """Plain version of the backward kernel: the gradient of
    `roi_align_3d_plain` with respect to the levels, as explicit
    `index_add_` of each sample's 8 corner weights times its bin's
    gradient / sample_num^3 (an out-of-range sample or an invalid roi
    adds nothing; an edge collapse puts the whole weight on dim - 1).

    grad_out (N, C, out_d, out, out); level_shapes: the (B, D, H, W, C)
    shape of each level.  Returns float32 (B, D, H, W, C) gradients."""
    c = level_shapes[0][-1]
    sn = sample_num
    sizes = [math.prod(s[:4]) for s in level_shapes]
    grad = torch.zeros((sum(sizes), c), dtype=torch.float32,
                       device=rois.device)
    for s0, s1, corners, ok in _plain_samples(
            level_shapes, rois, levels, valid, out_size, out_size_depth,
            featmap_strides, featmap_strides_depth, sn):
        g = grad_out[s0:s1].float().permute(0, 2, 3, 4, 1) / sn**3
        for axis in (1, 2, 3):
            g = g.repeat_interleave(sn, dim=axis)
        g = torch.where(ok[..., None], g, 0.0)
        for idx, w in corners:
            grad.index_add_(0, idx.reshape(-1),
                            (g * w[..., None]).reshape(-1, c))
    return [part.reshape(s) for part, s in
            zip(torch.split(grad, sizes), level_shapes)]


def _levels_args(feats_cl, featmap_strides, featmap_strides_depth):
    """ctypes arrays of the levels: data pointers, (D, H, W), scales."""
    num_levels = len(feats_cl)
    ptrs = (ctypes.c_longlong * num_levels)(
        *[f.data_ptr() for f in feats_cl])
    dims = (ctypes.c_int * (3 * num_levels))(
        *[int(v) for f in feats_cl for v in f.shape[1:4]])
    scales = (ctypes.c_float * (2 * num_levels))(
        *[v for s, sd in zip(featmap_strides, featmap_strides_depth)
          for v in (1.0 / s, 1.0 / sd)])
    return ptrs, dims, scales, num_levels


_LEVEL_ARGTYPES = [
    ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
]


def _kernel(name, argtypes):
    """The library's C function `name`, typed: the level arguments, then
    `argtypes`."""
    fn = getattr(_cuda.load("roi_align3d"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _LEVEL_ARGTYPES + argtypes
    return fn


@functools.cache
def _align_fn():
    return _kernel("mrcnn3d_roi_align3d", [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


@functools.cache
def _taps_fn():
    return _kernel("mrcnn3d_roi_align3d_taps", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])


def _path_counter(dev):
    counter = path_rois.get(dev)
    if counter is None:
        # a normal tensor even when the first launch runs under
        # inference_mode (simple_test): reset_path_counts zeroes it later
        with torch.inference_mode(False):
            counter = torch.zeros(2, dtype=torch.int64, device=dev)
        path_rois[dev] = counter
    return counter


def path_counts():
    """Valid rois that took the window path and the direct path, summed
    over the cards since the last `reset_path_counts` (synchronises)."""
    total = [0, 0]
    for counter in path_rois.values():
        window, direct = counter.tolist()
        total = [total[0] + window, total[1] + direct]
    return {"window": total[0], "direct": total[1]}


def reset_path_counts():
    for counter in path_rois.values():
        counter.zero_()


def _check_cuda_args(feats_cl, rois, levels, valid, out_size,
                     out_size_depth, sample_num):
    _check_levels(feats_cl)
    dev = rois.device
    dtype = feats_cl[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"roi_align_3d_cuda takes float32 or bfloat16, "
                         f"not {dtype}")
    tensors = [*feats_cl, rois, levels, *([] if valid is None else [valid])]
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("roi_align_3d_cuda takes CUDA tensors on one card")
    if not all(f.is_contiguous() and f.data_ptr() % 16 == 0
               for f in feats_cl):
        raise ValueError("levels must be contiguous (B, D, H, W, C), "
                         "16-byte aligned")
    c = feats_cl[0].shape[-1]
    cb = min(c, CHANNEL_BLOCK)
    if c % cb or cb * feats_cl[0].element_size() % 16:
        raise ValueError(f"{c} channels: a block's share ({cb}) must divide "
                         f"them and fill 16-byte vectors")
    if len(feats_cl) > 8 or not 1 <= sample_num <= 4 \
            or out_size * sample_num > 64 or not 1 <= out_size_depth <= 32:
        raise ValueError("at most 8 levels, 1..4 samples per bin, "
                         "out_size * sample_num <= 64 and out_size_depth "
                         "<= 32")


def roi_align_3d_cuda(feats_cl, rois, levels, valid, out_size,
                      out_size_depth, featmap_strides,
                      featmap_strides_depth, sample_num=2):
    """K2: the same function as `roi_align_3d_plain`, one launch (the
    window kernel, then the direct kernel for the rois it listed).

    Each valid roi takes the window path when its window fits
    `WINDOW_BYTES` of shared memory and the direct path otherwise; the
    kernel counts both per card (`path_counts`)."""
    global launches
    _check_cuda_args(feats_cl, rois, levels, valid, out_size, out_size_depth,
                     sample_num)
    dev = rois.device
    dtype = feats_cl[0].dtype
    n = rois.shape[0]
    c = feats_cl[0].shape[-1]
    rois = rois.float().contiguous()
    levels = levels.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    out = torch.empty((n, c, out_size_depth, out_size, out_size),
                      dtype=dtype, device=dev)
    # the kernel's list of the rois that take the direct path
    direct = torch.empty(n + 2, dtype=torch.int32, device=dev)
    status = _align_fn()(
        *_levels_args(feats_cl, featmap_strides, featmap_strides_depth),
        _DTYPE_CODES[dtype], c, rois.data_ptr(), levels.data_ptr(),
        valid.data_ptr(), out.data_ptr(), _path_counter(dev).data_ptr(),
        direct.data_ptr(), n, out_size, out_size_depth, sample_num,
        WINDOW_BYTES, _cuda.stream_ptr(dev),
    )
    _cuda.check(status, "roi_align3d")
    launches += 1
    return out


def sample_taps_cuda(feats_cl, rois, levels, out_size, out_size_depth,
                     featmap_strides, featmap_strides_depth, sample_num=2):
    """The taps K2 computes for each roi, from the kernel's own device
    code: (lo, hi, wl, wh, in_range), each (N, T) with the x taps, then
    y, then z (T = (2 * out_size + out_size_depth) * sample_num).  For the
    card tests, which hold them against the plain version's."""
    _check_cuda_args(feats_cl, rois, levels, None, out_size, out_size_depth,
                     sample_num)
    dev = rois.device
    n = rois.shape[0]
    t = (2 * out_size + out_size_depth) * sample_num
    rois = rois.float().contiguous()
    levels = levels.to(torch.int32).contiguous()
    lo = torch.empty((n, t), dtype=torch.int32, device=dev)
    hi = torch.empty_like(lo)
    wl = torch.empty((n, t), dtype=torch.float32, device=dev)
    wh = torch.empty_like(wl)
    in_range = torch.empty((n, t), dtype=torch.bool, device=dev)
    status = _taps_fn()(
        *_levels_args(feats_cl, featmap_strides, featmap_strides_depth),
        rois.data_ptr(), levels.data_ptr(), n, out_size, out_size_depth,
        sample_num, lo.data_ptr(), hi.data_ptr(), wl.data_ptr(),
        wh.data_ptr(), in_range.data_ptr(), _cuda.stream_ptr(dev),
    )
    _cuda.check(status, "roi_align3d_taps")
    return lo, hi, wl, wh, in_range


@functools.cache
def _backward_fn():
    return _kernel("mrcnn3d_roi_align3d_backward", [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


def roi_align_3d_backward_cuda(grad_out, level_shapes, rois, levels, valid,
                               out_size, out_size_depth, featmap_strides,
                               featmap_strides_depth, sample_num=2):
    """K2's backward: the same function as `roi_align_3d_backward_plain`,
    one launch (the float32 gradient buffer zeroed, then the scatter
    kernel).  Float atomics add in an order that changes from run to run,
    so the result varies in its last bits."""
    global backward_launches
    dev = rois.device
    dtype = grad_out.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"roi_align_3d_backward_cuda takes float32 or "
                         f"bfloat16, not {dtype}")
    if not all(t.is_cuda and t.device == dev
               for t in (grad_out, rois, levels, valid)):
        raise ValueError("roi_align_3d_backward_cuda takes CUDA tensors on "
                         "one card")
    n = rois.shape[0]
    c = level_shapes[0][-1]
    if tuple(grad_out.shape) != (n, c, out_size_depth, out_size, out_size):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not match "
                         f"{n} rois of {c} channels")
    cb = min(c, CHANNEL_BLOCK)
    if c % cb or len(level_shapes) > 8 or not 1 <= sample_num <= 4 \
            or out_size * sample_num > 64 or not 1 <= out_size_depth <= 32 \
            or cb * (out_size * out_size | 1) * 4 > 200 * 1024:
        raise ValueError("a block's channels must divide them; at most 8 "
                         "levels, 1..4 samples per bin, out_size * "
                         "sample_num <= 64, out_size_depth <= 32")
    # held in locals until the launch is queued: a temporary freed before
    # the kernel reads it could be handed to another tensor on the stream
    grad_out = grad_out.contiguous()
    rois = rois.float().contiguous()
    levels = levels.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    sizes = [math.prod(s) for s in level_shapes]
    grad = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    parts = [p.view(s) for p, s in zip(torch.split(grad, sizes),
                                       level_shapes)]
    status = _backward_fn()(
        *_levels_args(parts, featmap_strides, featmap_strides_depth),
        _DTYPE_CODES[dtype], c, grad_out.data_ptr(), rois.data_ptr(),
        levels.data_ptr(), valid.data_ptr(), grad.data_ptr(),
        grad.numel() * 4, n, out_size, out_size_depth, sample_num,
        _cuda.stream_ptr(dev),
    )
    _cuda.check(status, "roi_align3d_backward")
    backward_launches += 1
    return parts


class RoIAlign3DFunction(torch.autograd.Function):
    """The multi-level align, differentiable with respect to the levels.

    apply(rois, levels, valid, geometry, *feats_cl): geometry is
    (out_size, out_size_depth, featmap_strides, featmap_strides_depth,
    sample_num); feats_cl the (B, D, H, W, C) levels.  On CUDA tensors
    the forward is K2 and the backward its backward kernel; on the CPU
    the plain versions.  The gradient reaches each level in its own
    dtype, accumulated in float32."""

    @staticmethod
    def forward(ctx, rois, levels, valid, geometry, *feats_cl):
        fn = roi_align_3d_cuda if rois.is_cuda else roi_align_3d_plain
        out = fn(list(feats_cl), rois, levels, valid, *geometry)
        ctx.save_for_backward(rois, levels, valid)
        ctx.geometry = geometry
        ctx.levels = [(f.shape, f.dtype) for f in feats_cl]
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rois, levels, valid = ctx.saved_tensors
        fn = (roi_align_3d_backward_cuda if grad_out.is_cuda
              else roi_align_3d_backward_plain)
        grads = fn(grad_out.contiguous(), [s for s, _ in ctx.levels], rois,
                   levels, valid, *ctx.geometry)
        return (None, None, None, None,
                *(g.to(dtype) for g, (_, dtype) in zip(grads, ctx.levels)))


def channels_last_levels(feats):
    """NCDHW levels -> contiguous (B, D, H, W, C) views (no copy for
    channels_last_3d storage)."""
    return [f.permute(0, 2, 3, 4, 1).contiguous() for f in feats]


def multi_level_roi_align_3d(feats, rois, out_size, out_size_depth,
                             featmap_strides, featmap_strides_depth,
                             sample_num=2, finest_scale=56, valid=None):
    """feats: list of NCDHW levels; rois (N, 7); valid (N,) bool or None.
    Returns (N, C, out_d, out, out); invalid rois give zeros.  Goes
    through `RoIAlign3DFunction` when a level requires a gradient."""
    feats_cl = channels_last_levels(feats)
    rois = rois.detach()
    levels = map_roi_levels(rois, len(feats), finest_scale)
    if valid is None:
        valid = torch.ones(rois.shape[0], dtype=torch.bool,
                           device=rois.device)
    geometry = (out_size, out_size_depth, featmap_strides,
                featmap_strides_depth, sample_num)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats_cl):
        return RoIAlign3DFunction.apply(rois, levels, valid, geometry,
                                        *feats_cl)
    fn = roi_align_3d_cuda if rois.is_cuda else roi_align_3d_plain
    return fn(feats_cl, rois, levels, valid, *geometry)
