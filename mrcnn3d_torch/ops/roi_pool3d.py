"""RoIPool 3D: the reference kernel's max pooling of a roi's bins, in
plain PyTorch (NCDHW).

Semantics of the reference CUDA kernel (mmdet/ops/roi_pool/src/
roi_pool_kernel.cu ROIPoolForward), as `mrcnn3d/ops/roi_pool3d.py:
roi_pool_3d_numpy` states them: the roi's corners scaled by
`spatial_scale` (x, y) and `depth_scale` (z) and rounded half to even;
extents end - start + 1, at least 1; bin b of `out` along an axis covers
[start + floor(b * ext / out), start + ceil((b + 1) * ext / out))
clamped to [0, dim]; the bin's max over that box, 0 for an empty bin.

The JAX package's `roi_pool_3d` is XLA code, not a Pallas kernel, and
also clamps each roi to a static window (64 cells in x and y, 16 in z),
which changes the result of larger rois; the port has no such window.
The reference marks RoIPool legacy (RoIAlign3D is the shipped
extractor); it stays for capability parity.
"""
from __future__ import annotations

import torch


def _axis_bins(start, ext, out, dim):
    """(lo, hi) (N, out) int64 bin bounds along one axis, clamped to
    [0, dim]; the floor and ceil are exact integer divisions."""
    b = torch.arange(out, dtype=torch.int64, device=start.device)
    lo = start[:, None] + (b[None, :] * ext[:, None]) // out
    hi = start[:, None] - ((-(b[None, :] + 1) * ext[:, None]) // out)
    return lo.clamp(0, dim), hi.clamp(0, dim)


def _bin_max(v, lo, hi, axis):
    """Per bin, the max of `v` over [lo, hi) along `axis` of a window
    that starts at index 0: (..., win, ...) -> (..., out, ...), -inf for
    an empty bin."""
    idx = torch.arange(v.shape[axis], device=v.device)
    mask = (idx[None, :] >= lo[:, None]) & (idx[None, :] < hi[:, None])
    v = v.movedim(axis, 0)  # (win, ...)
    shape = mask.shape + (1,) * (v.dim() - 1)
    sel = torch.where(mask.reshape(shape), v[None],
                      torch.tensor(float("-inf"), dtype=v.dtype,
                                   device=v.device))
    return sel.amax(dim=1).movedim(0, axis)


def roi_pool_3d(feats, rois, out_size, out_size_depth, spatial_scale,
                depth_scale, valid=None):
    """feats (B, C, D, H, W); rois (N, 7) [b, x1, y1, x2, y2, z1, z2] in
    the input frame.  Returns (N, C, out_size_depth, out_size, out_size)
    in feats' dtype; rows with `valid` False are zero.

    Each roi reads only its own window of the map (the union of its
    bins), so the work is that of the rois, not of the map."""
    _, c, fd, fh, fw = feats.shape
    n = rois.shape[0]
    r = rois.float()
    corner = torch.round(
        r[:, 1:] * torch.tensor(
            [spatial_scale] * 4 + [depth_scale] * 2, dtype=torch.float32,
            device=r.device)).long()
    x1, y1, x2, y2, z1, z2 = corner.unbind(1)
    lo_x, hi_x = _axis_bins(x1, (x2 - x1 + 1).clamp(min=1), out_size, fw)
    lo_y, hi_y = _axis_bins(y1, (y2 - y1 + 1).clamp(min=1), out_size, fh)
    lo_z, hi_z = _axis_bins(z1, (z2 - z1 + 1).clamp(min=1), out_size_depth,
                            fd)
    out = feats.new_zeros((n, c, out_size_depth, out_size, out_size))
    bounds = torch.stack([r[:, 0].long(), lo_z[:, 0], hi_z[:, -1],
                          lo_y[:, 0], hi_y[:, -1], lo_x[:, 0], hi_x[:, -1]],
                         1).tolist()
    keep = [True] * n if valid is None else valid.tolist()
    for i, (bi, z0, z9, y0, y9, x0, x9) in enumerate(bounds):
        if not keep[i] or z0 >= z9 or y0 >= y9 or x0 >= x9:
            continue
        win = feats[bi, :, z0:z9, y0:y9, x0:x9]
        v = _bin_max(win, lo_z[i] - z0, hi_z[i] - z0, 1)
        v = _bin_max(v, lo_y[i] - y0, hi_y[i] - y0, 2)
        v = _bin_max(v, lo_x[i] - x0, hi_x[i] - x0, 3)
        out[i] = torch.where(torch.isfinite(v), v, 0.0)
    return out
