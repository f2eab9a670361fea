"""Deformable convolution (DCN v1/v2) and deformable RoI pooling, the
2-D ops of the reference's DCN package (mmdet/ops/dcn), in plain
PyTorch: the port's copy of `mrcnn3d/ops/dcn.py:27-453`.

The JAX package writes them as XLA gathers, not Pallas kernels, and no
detector builds them (ROADMAP A11.8 (d)), so they are gathers and an
einsum here too, differentiable through the data and the offsets.
Layouts are PyTorch's (NCHW), the reference's:

  * deform_conv2d(x (B, C, H, W), offset (B, 2K, Ho, Wo) with (dy, dx)
    pairs per tap k = i * kw + j, weight (Cout, C, kh, kw), mask
    (B, K, Ho, Wo) or None) -> (B, Cout, Ho, Wo): each tap k of output
    position p samples x bilinearly at p * stride - padding + k *
    dilation + offset[p, k], zero outside the map (the reference's
    deformable_im2col), scaled by the mask in v2;
  * deform_roi_pool(feats (B, C_in, H, W), rois (N, 5), offsets
    (N, 2, part, part) or None) -> (N, C_in / group_size**2, out, out):
    the reference's DeformablePSROIPoolForwardKernel (rounded corners
    shifted by -0.5, extent at least 0.1, per-bin shifts scaled by
    trans_std times the roi's extent, sample_per_part**2 bilinear
    samples a bin, those outside (-0.5, size - 0.5) dropped from the
    mean, position-sensitive channel groups);
  * DeformConv2dPack / DeformRoIPoolingPack: the layers with a learned
    offset branch (zero-initialised, so each starts as its plain op).
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _out_size(n, k, stride, padding, dilation):
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def deform_conv2d(x, offset, weight, stride=1, padding=1, dilation=1,
                  mask=None):
    """Deformable conv (v2 with `mask`); layouts in the module doc."""
    b, c, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    dev, dt = x.device, x.dtype
    ky = (torch.arange(kh, device=dev) * dilation).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dilation).repeat(kh)
    py = torch.arange(ho, device=dev) * stride - padding
    px = torch.arange(wo, device=dev) * stride - padding
    # (K, Ho, 1) and (K, 1, Wo) tap positions, then (B, K, Ho, Wo)
    off = offset.reshape(b, k, 2, ho, wo)
    sy = (py[None, :, None] + ky[:, None, None]).to(dt) + off[:, :, 0]
    sx = (px[None, None, :] + kx[:, None, None]).to(dt) + off[:, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    flat = x.reshape(b, c, h * w)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
        v = flat.gather(2, idx).reshape(b, c, k, ho, wo)
        return v * inb[:, None].to(dt)

    v = (gather(y0, x0) * ((1 - fy) * (1 - fx))[:, None]
         + gather(y0, x0 + 1) * ((1 - fy) * fx)[:, None]
         + gather(y0 + 1, x0) * (fy * (1 - fx))[:, None]
         + gather(y0 + 1, x0 + 1) * (fy * fx)[:, None])
    if mask is not None:
        v = v * mask[:, None]
    return torch.einsum("bckhw,ock->bohw", v, weight.reshape(cout, c, k))


class DeformConv2dPack(nn.Module):
    """DCN with a learned offset branch (reference dcn/deform_conv.py
    DeformConvPack): the offsets (and, `modulated` -- DCNv2,
    ModulatedDeformConvPack -- the sigmoid mask's K channels after them)
    come from `conv_offset`, a conv initialised to zero, so the layer
    starts as a plain conv.  Takes (B, C, H, W) or a depth-1 volume
    (B, C, 1, H, W), and returns the same rank."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, modulated=False):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.modulated = modulated
        k = kernel_size * kernel_size
        self.conv_offset = nn.Conv2d(
            in_channels, k * (3 if modulated else 2), kernel_size,
            stride=stride, padding=padding, dilation=dilation)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        nn.init.normal_(self.weight, 0.0,
                        1.0 / math.sqrt(in_channels * k))

    def forward(self, x):
        squeeze = x.dim() == 5
        if squeeze:
            if x.shape[2] != 1:
                raise ValueError("DCN is a 2-D (depth-1) op")
            x = x[:, :, 0]
        raw = self.conv_offset(x)
        k = self.weight.shape[2] * self.weight.shape[3]
        if self.modulated:
            offset, mask = raw[:, :2 * k], torch.sigmoid(raw[:, 2 * k:])
        else:
            offset, mask = raw, None
        out = deform_conv2d(x, offset, self.weight.to(x.dtype), self.stride,
                            self.padding, self.dilation, mask)
        return out[:, :, None] if squeeze else out


def deform_roi_pool(feats, rois, offsets=None, spatial_scale=1.0,
                    out_size=7, sample_per_part=4, trans_std=0.0,
                    group_size=1, part_size=None):
    """Deformable (PS-)RoI pooling; layouts and rules in the module doc."""
    b, c_in, h, w = feats.shape
    n = rois.shape[0]
    gs = int(group_size)
    out_channels = c_in // (gs * gs)
    part = int(part_size) if part_size is not None else int(out_size)
    sp, os_ = int(sample_per_part), int(out_size)
    dev, dt = feats.device, feats.dtype

    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = roi_w / os_, roi_h / os_
    sub_w, sub_h = bin_w / sp, bin_h / sp

    ph = torch.arange(os_, device=dev)
    if offsets is None:
        tx = torch.zeros((n, os_, os_), dtype=dt, device=dev)
        ty = tx
    else:
        cell = torch.floor(ph.to(torch.float32) / os_ * part).long()
        tx = offsets[:, 0][:, cell][:, :, cell] * trans_std
        ty = offsets[:, 1][:, cell][:, :, cell] * trans_std
    # bin starts with their shift (N, out, out), then the samples
    # (N, out, out, sp, sp)
    wstart = (ph[None, None, :] * bin_w[:, None, None] + x1[:, None, None]
              + tx * roi_w[:, None, None])
    hstart = (ph[None, :, None] * bin_h[:, None, None] + y1[:, None, None]
              + ty * roi_h[:, None, None])
    s = torch.arange(sp, device=dev)
    sx = wstart[..., None, None] + s[None, None, None, None, :] \
        * sub_w[:, None, None, None, None]
    sy = hstart[..., None, None] + s[None, None, None, :, None] \
        * sub_h[:, None, None, None, None]
    valid = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    x1c, y1c = torch.ceil(sx), torch.ceil(sy)
    fx, fy = sx - x0, sy - y0

    flat = feats.permute(0, 2, 3, 1).reshape(b, h * w, c_in)

    def corner(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(n, -1)
        return flat[batch_idx[:, None], idx].reshape(n, os_, os_, sp, sp,
                                                     c_in)

    val = (corner(y0, x0) * ((1 - fy) * (1 - fx))[..., None]
           + corner(y1c, x0) * (fy * (1 - fx))[..., None]
           + corner(y0, x1c) * ((1 - fy) * fx)[..., None]
           + corner(y1c, x1c) * (fy * fx)[..., None])
    val = val * valid[..., None].to(dt)
    count = valid.sum(dim=(3, 4))
    pooled = val.sum(dim=(3, 4)) / count.clamp(min=1)[..., None].to(dt)
    pooled = torch.where(count[..., None] > 0, pooled,
                         torch.zeros((), dtype=dt, device=dev))
    if gs > 1:
        # channel c of output bin (ph, pw) reads input channel
        # (c * gs + gh) * gs + gw
        g = torch.clamp((ph * gs) // os_, 0, gs - 1)
        cidx = ((torch.arange(out_channels, device=dev)[None, None, :] * gs
                 + g[:, None, None]) * gs + g[None, :, None])
        pooled = pooled.gather(3, cidx[None].expand(n, -1, -1, -1))
    else:
        pooled = pooled[..., :out_channels]
    return pooled.permute(0, 3, 1, 2)


class DeformRoIPoolingPack(nn.Module):
    """Deformable RoI pooling with a learned offset branch (reference
    modules/deform_pool.py DeformRoIPoolingPack): a no-trans pass feeds
    `num_offset_fcs` linear layers (ReLU between, the last initialised to
    zero) that give each bin its (dx, dy) shift for the deformable pass;
    `modulated` (ModulatedDeformRoIPoolingPack) adds `num_mask_fcs`
    layers whose sigmoid per bin scales the output.  The fcs read the
    no-trans pass flattened in C*out*out order."""

    def __init__(self, out_size=7, out_channels=256, spatial_scale=1.0 / 16,
                 sample_per_part=4, trans_std=0.1, group_size=1,
                 num_offset_fcs=3, num_mask_fcs=2, deform_fc_channels=1024,
                 no_trans=False, modulated=False):
        super().__init__()
        self.kw = dict(spatial_scale=spatial_scale, out_size=out_size,
                       sample_per_part=sample_per_part, trans_std=trans_std,
                       group_size=group_size)
        self.out_size = out_size
        self.no_trans = no_trans
        self.modulated = modulated
        in_features = out_channels * out_size * out_size

        def fcs(num, last_out):
            dims = [in_features] + [deform_fc_channels] * (num - 1)
            layers = nn.ModuleList(
                [nn.Linear(a, deform_fc_channels) for a in dims[:-1]]
                + [nn.Linear(dims[-1], last_out)])
            nn.init.zeros_(layers[-1].weight)
            nn.init.zeros_(layers[-1].bias)
            return layers

        if not no_trans:
            self.offset_fcs = fcs(num_offset_fcs, out_size * out_size * 2)
            if modulated:
                self.mask_fcs = fcs(num_mask_fcs, out_size * out_size)

    @staticmethod
    def _run(layers, y):
        for i, fc in enumerate(layers):
            y = fc(y)
            if i < len(layers) - 1:
                y = torch.relu(y)
        return y

    def forward(self, feats, rois):
        x = deform_roi_pool(feats, rois, None, **self.kw)
        if self.no_trans:
            return x
        n, o = rois.shape[0], self.out_size
        offsets = self._run(self.offset_fcs, x.reshape(n, -1))
        out = deform_roi_pool(feats, rois, offsets.reshape(n, 2, o, o),
                              **self.kw)
        if self.modulated:
            m = torch.sigmoid(self._run(self.mask_fcs, x.reshape(n, -1)))
            out = out * m.reshape(n, 1, o, o)
        return out
