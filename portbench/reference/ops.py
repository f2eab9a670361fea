"""Plain PyTorch operations of the detectors' inference: the anchor
lattice, the 6-DoF delta codec and IoU, greedy NMS, multi-level
RoIAlign3D, the proposal and class-wise NMS stages, and
jax.image.resize's antialiased trilinear resize.

A frozen copy of the published semantics as the port states them
(reference mmdet 3-D ops: anchor_generator_3d.py, transforms_3d.py,
nms_kernel.cu's IoU with +1 extents, roi_align_kernel.cu's sampling and
edge rules, bbox_nms.py), in float32, with stable sorts where the
program breaks ties toward the lower index.  It imports nothing of the
program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sort_desc(x, dim=-1):
    """Stable descending sort (ties keep the lower index first)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------


def base_anchors(base_size, scales, depth_scales, ratios, depth_base):
    w = h = base_size
    xc, yc, zc = 0.5 * (w - 1), 0.5 * (h - 1), 0.5 * (depth_base - 1)
    scales = np.asarray(scales, np.float32)
    depth_scales = np.asarray(depth_scales, np.float32)
    ratios = np.asarray(ratios, np.float32)
    hr = np.sqrt(ratios)
    wr = 1.0 / hr
    ws = (w * wr[:, None] * scales[None, :]).reshape(-1)
    hs = (h * hr[:, None] * scales[None, :]).reshape(-1)
    zs = (depth_base * hr[:, None] * depth_scales[None, :]).reshape(-1)
    base = np.stack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                     xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1),
                     zc - 0.5 * (zs - 1), zc + 0.5 * (zs - 1)], -1)
    return np.round(base).astype(np.float32)


def level_anchors(size, stride, depth_stride, base):
    """(d*h*w*A, 6) anchors of one level in (z, y, x, a) order."""
    d, h, w = size
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    sz = np.arange(d, dtype=np.float32) * depth_stride
    zz, yy, xx = np.meshgrid(sz, sy, sx, indexing="ij")
    xx, yy, zz = xx.ravel(), yy.ravel(), zz.ravel()
    shifts = np.stack([xx, yy, xx, yy, zz, zz], -1)
    return (base[None] + shifts[:, None]).reshape(-1, 6)


def anchor_set(featmap_sizes, img_dhw, rpn_cfg, device):
    """Per level (anchors (N, 6), inside-volume flags (N,)) on device."""
    strides = rpn_cfg["anchor_strides"]
    dstrides = rpn_cfg["anchor_strides_depth"]
    d, h, w = img_dhw
    out = []
    for lvl, size in enumerate(featmap_sizes):
        base = base_anchors(strides[lvl], rpn_cfg["anchor_scales"],
                            rpn_cfg["anchor_depth_scales"],
                            rpn_cfg["anchor_ratios"], dstrides[lvl])
        a = level_anchors(size, strides[lvl], dstrides[lvl], base)
        inside = ((a[:, 0] >= 0) & (a[:, 1] >= 0) & (a[:, 4] >= 0)
                  & (a[:, 2] < w) & (a[:, 3] < h) & (a[:, 5] < d))
        out.append((torch.from_numpy(a).to(device),
                    torch.from_numpy(inside).to(device)))
    return out


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------


def delta2bbox(rois, deltas, means, stds, img_dhw, clip=16.0 / 1000.0):
    """Decode (..., 6K) deltas against (..., 6) boxes, clamped to the
    volume; boxes [x1, y1, x2, y2, z1, z2] with +1 extents."""
    k = deltas.shape[-1] // 6
    dev = deltas.device
    means = torch.tensor(means, dtype=torch.float32, device=dev).repeat(k)
    stds = torch.tensor(stds, dtype=torch.float32, device=dev).repeat(k)
    den = deltas * stds + means
    dx, dy = den[..., 0::6], den[..., 1::6]
    dw, dh = den[..., 2::6], den[..., 3::6]
    dz, dd = den[..., 4::6], den[..., 5::6]
    lim = float(abs(math.log(clip)))
    dw, dh = dw.clamp(-lim, lim), dh.clamp(-lim, lim)
    dz, dd = dz.clamp(-lim, lim), dd.clamp(-lim, lim)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pz = ((rois[..., 4] + rois[..., 5]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
    pd = (rois[..., 5] - rois[..., 4] + 1.0)[..., None]
    gw, gh, gd = pw * torch.exp(dw), ph * torch.exp(dh), pd * torch.exp(dd)
    gx, gy, gz = px + pw * dx, py + ph * dy, pz + pd * dz
    d, h, w = img_dhw
    x1 = (gx - gw * 0.5 + 0.5).clamp(0, w - 1)
    y1 = (gy - gh * 0.5 + 0.5).clamp(0, h - 1)
    x2 = (gx + gw * 0.5 - 0.5).clamp(0, w - 1)
    y2 = (gy + gh * 0.5 - 0.5).clamp(0, h - 1)
    z1 = (gz - gd * 0.5 + 0.5).clamp(0, d - 1)
    z2 = (gz + gd * 0.5 - 0.5).clamp(0, d - 1)
    return torch.stack([x1, y1, x2, y2, z1, z2], -1).reshape(deltas.shape)


def box_volume(b):
    return ((b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
            * (b[..., 5] - b[..., 4] + 1.0))


def iou(boxes1, boxes2):
    """(m, 6), (n, 6) -> (m, n) volume IoU with +1 extents, as
    inter / (vol1 + vol2 - inter)."""
    a, b = boxes1[:, None], boxes2[None, :]
    inter = ((torch.minimum(a[..., 2], b[..., 2])
              - torch.maximum(a[..., 0], b[..., 0]) + 1.0).clamp(min=0)
             * (torch.minimum(a[..., 3], b[..., 3])
                - torch.maximum(a[..., 1], b[..., 1]) + 1.0).clamp(min=0)
             * (torch.minimum(a[..., 5], b[..., 5])
                - torch.maximum(a[..., 4], b[..., 4]) + 1.0).clamp(min=0))
    return inter / (box_volume(boxes1)[:, None] + box_volume(boxes2)[None, :]
                    - inter)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------


def greedy_keep(boxes, valid, iou_thr):
    """Greedy hard NMS over rows already in score order: a kept row
    removes every later row whose IoU with it exceeds iou_thr."""
    sup = (iou(boxes, boxes) > iou_thr).triu(diagonal=1).cpu()
    alive = valid.cpu().clone()
    for i in range(boxes.shape[0]):
        if alive[i]:
            alive &= ~sup[i]
    return alive.to(boxes.device)


def nms_segments(boxes, scores, valid, counts, iou_thr):
    """Independent NMS problems laid end to end: each segment sorted by
    score (stable, invalid rows last), scanned greedily; keep (T,) in
    input order."""
    keep = torch.zeros_like(valid)
    neg_inf = float("-inf")
    start = 0
    for n in counts:
        sl = slice(start, start + n)
        _, order = sort_desc(torch.where(valid[sl], scores[sl], neg_inf))
        k = greedy_keep(boxes[sl][order].float(), valid[sl][order], iou_thr)
        seg = torch.zeros_like(k)
        seg[order] = k
        keep[sl] = seg
        start += n
    return keep


def top_kept(boxes, scores, keep, max_out):
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    top_s, top_i = sort_desc(torch.where(keep, scores, neg_inf))
    top_s, top_i = top_s[..., :max_out], top_i[..., :max_out]
    out_valid = top_s > neg_inf
    out_boxes = torch.gather(boxes, -2,
                             top_i[..., None].expand(*top_i.shape, 6))
    return torch.where(out_valid[..., None], out_boxes, 0.0), top_s, out_valid


def proposals(cls_outs, reg_outs, anchors, img_dhw, cfg, means, stds):
    """RPN proposals of one image per level's (cls (1, A, d, h, w), reg
    (1, 6A, d, h, w)): the inside anchors' top nms_pre by sigmoid score,
    decoded; one NMS per level; each level's best nms_post; the best
    max_num overall.  Returns boxes (1, M, 6), valid (1, M)."""
    nms_pre, nms_post = cfg["nms_pre"], cfg["nms_post"]
    neg_inf = float("-inf")
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for (cls, reg), (anc, inside) in zip(zip(cls_outs, reg_outs), anchors):
        scores = torch.sigmoid(cls.float().permute(0, 2, 3, 4, 1)
                               .reshape(1, -1))
        deltas = reg.float().permute(0, 2, 3, 4, 1).reshape(1, -1, 6)
        n = scores.shape[1]
        if n > nms_pre:
            top_s, top_i = sort_desc(torch.where(inside, scores, neg_inf))
            top_s, top_i = top_s[:, :nms_pre], top_i[:, :nms_pre]
            anc = anc[top_i]
            deltas = torch.gather(deltas, 1,
                                  top_i[..., None].expand(1, nms_pre, 6))
            valid = top_s > neg_inf
            scores = torch.where(valid, top_s, 0.0)
        else:
            anc = anc.expand(1, n, 6)
            valid = torch.ones((1, n), dtype=torch.bool, device=cls.device)
        lvl_boxes.append(delta2bbox(anc, deltas, means, stds, img_dhw))
        lvl_scores.append(scores)
        lvl_valid.append(valid)
    counts = [s.shape[1] for s in lvl_scores]
    keep = nms_segments(torch.cat(lvl_boxes, 1).reshape(-1, 6),
                        torch.cat(lvl_scores, 1).reshape(-1),
                        torch.cat(lvl_valid, 1).reshape(-1), counts,
                        cfg["nms_thr"]).reshape(1, -1)
    boxes, scores, valid = [], [], []
    for lvl, keep_l in enumerate(torch.split(keep, counts, dim=1)):
        bx, sc, vd = top_kept(lvl_boxes[lvl], lvl_scores[lvl], keep_l,
                              min(nms_post, counts[lvl]))
        boxes.append(bx)
        scores.append(torch.where(vd, sc, neg_inf))
        valid.append(vd)
    boxes, scores, valid = (torch.cat(t, 1) for t in (boxes, scores, valid))
    num = min(cfg["max_num"], boxes.shape[1])
    top_s, top_i = sort_desc(scores)
    top_s, top_i = top_s[:, :num], top_i[:, :num]
    out_valid = (top_s > neg_inf) & torch.gather(valid, 1, top_i)
    out = torch.gather(boxes, 1, top_i[..., None].expand(1, num, 6))
    return torch.where(out_valid[..., None], out, 0.0), out_valid


def classwise_nms(boxes, scores, valid, score_thr, iou_thr, max_num):
    """Per foreground class: the score threshold, then NMS; the best
    max_num overall.  boxes (1, N, 6) or (1, N, 6C); scores (1, N, C)
    softmax (class 0 the background); valid (1, N).  Returns dets (1,
    max_num, 7), labels, valid (1, max_num) and each det's input row."""
    _, n, num_classes = scores.shape
    dev = scores.device
    bx, sc, sel = [], [], []
    for i in range(1, num_classes):
        bx.append(boxes if boxes.shape[-1] == 6
                  else boxes[:, :, i * 6:(i + 1) * 6])
        sc.append(scores[:, :, i])
        sel.append(valid & (scores[:, :, i] > score_thr))
    bx, sc, sel = (torch.cat(t, 1) for t in (bx, sc, sel))
    keep = nms_segments(bx.reshape(-1, 6), sc.reshape(-1), sel.reshape(-1),
                        [n] * (num_classes - 1), iou_thr).reshape(1, -1)
    labels = torch.arange(num_classes - 1, device=dev).repeat_interleave(n)
    neg_inf = torch.tensor(float("-inf"), dtype=sc.dtype, device=dev)
    top_s, top_i = sort_desc(torch.where(keep, sc, neg_inf))
    k = min(max_num, top_s.shape[1])
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    ok = top_s > neg_inf
    det_boxes = torch.gather(bx, 1, top_i[..., None].expand(1, k, 6))
    dets = torch.cat([torch.where(ok[..., None], det_boxes, 0.0),
                      torch.where(ok, top_s, 0.0)[..., None]], -1)
    det_labels = torch.where(ok, labels[top_i], 0)
    src = torch.where(ok, top_i % n, 0)
    if k < max_num:
        dets, det_labels, ok, src = (
            torch.cat([t, t.new_zeros((1, max_num - k) + t.shape[2:])], 1)
            for t in (dets, det_labels, ok, src))
    return dets, det_labels, ok, src


# ---------------------------------------------------------------------------
# RoIAlign3D
# ---------------------------------------------------------------------------


def roi_levels(rois, num_levels, finest_scale=56):
    """floor(log2(sqrt(w*h*d) / finest + 1e-6)), clamped to the levels."""
    scale = torch.sqrt((rois[:, 3] - rois[:, 1] + 1)
                       * (rois[:, 4] - rois[:, 2] + 1)
                       * (rois[:, 6] - rois[:, 5] + 1))
    t = torch.nan_to_num(torch.floor(torch.log2(scale / finest_scale + 1e-6)),
                         nan=0.0)
    return t.clamp(0, num_levels - 1).long()


def axis_samples(lo, ext, pooled, sn):
    """(N,) origin and extent -> (N, pooled * sn) sample coordinates."""
    dev = lo.device
    p = torch.arange(pooled, dtype=torch.float32, device=dev)
    s = (torch.arange(sn, dtype=torch.float32, device=dev) + 0.5) / sn
    offs = p[:, None] + s[None, :]
    c = lo[:, None, None] + (ext / pooled)[:, None, None] * offs[None]
    return c.reshape(c.shape[0], pooled * sn)


def interp(coord, dim):
    """The CUDA edge rules: a coordinate below -1 or above dim adds 0,
    one at or below 0 clamps to 0, a low index at dim-1 or above
    collapses onto the edge voxel.  Returns (low, high, w_low, w_high,
    in_range)."""
    dim = dim[:, None]
    in_range = (coord >= -1.0) & (coord <= dim.to(coord.dtype))
    c = coord.clamp(min=0.0)
    low = torch.floor(c).long()
    edge = low >= dim - 1
    low = torch.where(edge, dim - 1, low)
    high = torch.where(edge, dim - 1, low + 1)
    c = torch.where(edge, low.to(c.dtype), c)
    frac = c - low.to(c.dtype)
    return low, high, 1.0 - frac, frac, in_range


def roi_align(feats, rois, valid, out, out_d, strides, strides_d, sn=2,
              chunk_bytes=1 << 30, levels=None):
    """Multi-level RoIAlign3D in float32.  feats: NCDHW levels; rois
    (N, 7) [b, x1, y1, x2, y2, z1, z2]; valid (N,).  Each roi reads the
    level `roi_levels` gives (or `levels`); each bin averages sn^3
    trilinear samples; invalid rois give zeros.  Returns (N, C, out_d,
    out, out) float32."""
    c = feats[0].shape[1]
    n = rois.shape[0]
    dev = rois.device
    if levels is None:
        levels = roi_levels(rois, len(feats))
    res = torch.zeros((n, c, out_d, out, out), device=dev)
    samples = out_d * sn * (out * sn) ** 2
    step = max(1, chunk_bytes // (3 * samples * c * 4))
    for lvl, f in enumerate(feats):
        f = f.float().permute(0, 2, 3, 4, 1)
        _, fd, fh, fw, _ = f.shape
        flat = f.reshape(-1, c)
        idx_all = torch.nonzero((levels == lvl) & valid).flatten()
        inv, inv_d = 1.0 / strides[lvl], 1.0 / strides_d[lvl]
        for s0 in range(0, idx_all.shape[0], step):
            idx = idx_all[s0:s0 + step]
            r = rois[idx]
            m = r.shape[0]
            dims = [torch.full((m,), v, device=dev) for v in (fw, fh, fd)]
            taps = []
            for lo_col, hi_col, scale, pooled, dim in (
                    (1, 3, inv, out, dims[0]), (2, 4, inv, out, dims[1]),
                    (5, 6, inv_d, out_d, dims[2])):
                lo = r[:, lo_col] * scale
                ext = ((r[:, hi_col] + 1.0) * scale - lo).clamp(min=0.0)
                taps.append(interp(axis_samples(lo, ext, pooled, sn), dim))
            (xl, xh, wxl, wxh, xin), (yl, yh, wyl, wyh, yin), \
                (zl, zh, wzl, wzh, zin) = taps
            base = (r[:, 0].long() * fd * fh * fw)[:, None, None, None]
            acc = 0.0
            for zi, wz in ((zl, wzl), (zh, wzh)):
                for yi, wy in ((yl, wyl), (yh, wyh)):
                    for xi, wx in ((xl, wxl), (xh, wxh)):
                        vox = base + (zi[:, :, None, None] * fh
                                      + yi[:, None, :, None]) * fw \
                            + xi[:, None, None, :]
                        w = (wz[:, :, None, None] * wy[:, None, :, None]) \
                            * wx[:, None, None, :]
                        acc = acc + flat[vox.reshape(-1)].reshape(
                            *vox.shape, c) * w[..., None]
            ok = zin[:, :, None, None] & yin[:, None, :, None] \
                & xin[:, None, None, :]
            acc = torch.where(ok[..., None], acc, 0.0)
            acc = acc.reshape(m, out_d, sn, out, sn, out, sn, c).mean(
                dim=(2, 4, 6))
            res[idx] = acc.permute(0, 4, 1, 2, 3)
    return res


def flat_rois(boxes, valid):
    """(1, R, 6), (1, R) -> rois (R, 7) [0, x1..z2], valid (R,)."""
    b = boxes.reshape(-1, 6)
    return torch.cat([b.new_zeros((b.shape[0], 1)), b], 1), valid.reshape(-1)


# ---------------------------------------------------------------------------
# jax.image.resize, trilinear
# ---------------------------------------------------------------------------


def antialias_taps(out_n, in_n):
    """(out_n, in_n) weights: a triangle kernel at the half-pixel sample,
    widened by in/out when it shrinks, rows normalised to sum 1."""
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


def resize_trilinear(x, out_dhw):
    """jax.image.resize(x, ..., "trilinear") of the last three axes."""
    nd = x.dim()
    for axis, out_n in zip(range(nd - 3, nd), out_dhw):
        in_n = x.shape[axis]
        if int(out_n) == in_n:
            continue
        w = torch.from_numpy(antialias_taps(int(out_n), in_n)).to(x)
        x = torch.movedim(torch.movedim(x, axis, -1) @ w.t(), -1, axis)
    return x
