"""Greedy hard 3-D NMS: the K1 kernel wrapper and its plain version.

Semantics of `mrcnn3d/ops/nms3d.py:nms_3d_mask` (reference
nms_kernel.cu devIoU3d + the host scan): boxes sorted by score
descending with invalid rows last (a stable sort, as JAX's argsort),
then a greedy scan in which an earlier kept box suppresses a later box
whose symmetric volume IoU (+1 extents) exceeds the threshold.

The sorting and un-permuting are torch ops; the scan over the sorted
rows is `greedy_scan`, which launches `csrc/nms3d.cu` for CUDA tensors
(`greedy_scan_cuda`, one launch for many independent problems) and runs
`greedy_scan_plain` for CPU tensors.  `launches` counts the kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from . import _cuda
from .box3d import bbox_overlaps_3d

launches = 0

_TILE = 64
# the scan keeps up to 12 removed-words per lane of one warp: 384 tiles
# of 64 (SSD512's 24,564 anchors in one segment)
_MAX_ROWS = 384 * _TILE


def sort_desc(x, dim=-1):
    """Stable descending sort: ties keep the lower index first, as JAX's
    argsort(-x) and lax.top_k do.  Returns (values, indices)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


def greedy_scan_plain(sboxes, svalid, counts, iou_thr):
    """Plain version of the kernel: per segment, the IoU matrix of the
    sorted boxes, then the greedy scan row by row.

    sboxes (T, 6) float32 and svalid (T,) bool, sorted within each
    segment; counts: segment lengths summing to T.  Returns keep (T,)
    bool per sorted row, on the input's device.
    """
    keep = []
    start = 0
    for n in counts:
        boxes = sboxes[start:start + n]
        sup = (bbox_overlaps_3d(boxes, boxes) > iou_thr).triu(diagonal=1)
        sup = sup.cpu()
        alive = svalid[start:start + n].cpu().clone()
        for i in range(n):
            if alive[i]:
                alive &= ~sup[i]
        keep.append(alive)
        start += n
    return torch.cat(keep).to(sboxes.device)


@functools.cache
def _scan_fn():
    fn = _cuda.load("nms3d").mrcnn3d_nms3d
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return fn


def segment_table(counts):
    """K1's segment table and mask size: (the segments' first rows, row
    counts and mask-word offsets, laid end to end; the mask words in
    all), each segment's words those of its tiles on or above the
    diagonal, 64 * W * (W + 1) / 2 for W = ceil(count / 64).  Raises for
    a segment of more than _MAX_ROWS rows."""
    if max(counts) > _MAX_ROWS:
        raise ValueError(f"segment of {max(counts)} boxes: at most "
                         f"{_MAX_ROWS}")
    tiles = [(n + _TILE - 1) // _TILE for n in counts]
    starts = [0, *itertools.accumulate(counts)][:-1]
    offs = [0, *itertools.accumulate(_TILE * w * (w + 1) // 2
                                     for w in tiles)]
    return starts + list(counts) + offs[:-1], offs[-1]


def greedy_scan_cuda(sboxes, svalid, counts, iou_thr):
    """K1: the same scan as `greedy_scan_plain`, one launch of each of its
    two passes for every segment.  The segment table reaches the card in
    one non-blocking copy from pinned memory; `keep` is written as bool."""
    global launches
    if not (sboxes.is_cuda and svalid.is_cuda):
        raise ValueError("greedy_scan_cuda takes CUDA tensors")
    total = sum(counts)
    if sboxes.shape != (total, 6) or svalid.shape != (total,):
        raise ValueError(
            f"boxes {tuple(sboxes.shape)} / valid {tuple(svalid.shape)} do "
            f"not match {total} rows"
        )
    if sboxes.dtype != torch.float32 or not sboxes.is_contiguous():
        raise ValueError("boxes must be contiguous float32")
    if svalid.dtype != torch.bool or not svalid.is_contiguous():
        raise ValueError("valid must be a contiguous bool tensor")
    dev = sboxes.device
    if total == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    table, words = segment_table(counts)
    table = torch.tensor(table, dtype=torch.int64, pin_memory=True)
    table = table.to(dev, non_blocking=True)
    mask = torch.empty(max(words, 1), dtype=torch.int64, device=dev)
    keep = torch.empty(total, dtype=torch.bool, device=dev)
    status = _scan_fn()(
        sboxes.data_ptr(), svalid.data_ptr(), table.data_ptr(),
        mask.data_ptr(), keep.data_ptr(), len(counts), max(counts),
        float(iou_thr), _cuda.stream_ptr(dev),
    )
    _cuda.check(status, "nms3d")
    launches += 1
    return keep


def greedy_scan(sboxes, svalid, counts, iou_thr):
    """K1 for CUDA tensors, the plain version for CPU tensors."""
    if sboxes.is_cuda:
        return greedy_scan_cuda(sboxes, svalid, counts, iou_thr)
    return greedy_scan_plain(sboxes, svalid, counts, iou_thr)


def segment_order(scores, valid, counts):
    """Permutation that sorts each segment by score, descending and
    stable, invalid rows last; segments stay in place."""
    dev = scores.device
    seg = torch.repeat_interleave(
        torch.arange(len(counts), device=dev),
        torch.tensor(counts, device=dev),
        output_size=scores.shape[0],
    )
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    _, order = sort_desc(torch.where(valid, scores, neg_inf))
    # group by segment, keeping the score order inside each (stable)
    return order[torch.sort(seg[order], stable=True).indices]


def nms_3d_mask_segments(boxes, scores, valid, counts, iou_thr):
    """Independent NMS problems laid end to end, in one scan.

    boxes (T, 6), scores (T,), valid (T,) bool; counts: python ints,
    the segment lengths, summing to T.  Returns keep (T,) bool in input
    order.
    """
    order = segment_order(scores, valid, counts)
    sboxes = boxes[order].float().contiguous()
    keep_sorted = greedy_scan(sboxes, valid[order], counts, iou_thr)
    keep = torch.zeros_like(valid)
    keep[order] = keep_sorted
    return keep


def nms_3d_mask(boxes, scores, valid, iou_thr):
    """One problem: boxes (K, 6), scores (K,), valid (K,) -> keep (K,)."""
    return nms_3d_mask_segments(
        boxes, scores, valid, [boxes.shape[0]], iou_thr
    )


def nms_3d(boxes, scores, valid, iou_thr, max_out):
    """Survivors in score order, padded: (boxes (max_out, 6), scores
    (max_out,) with -inf padding, valid (max_out,))."""
    keep = nms_3d_mask(boxes, scores, valid, iou_thr)
    return top_kept(boxes, scores, keep, max_out)


def top_kept(boxes, scores, keep, max_out):
    """The `max_out` best kept rows along the last row axis: boxes
    (..., K, 6), scores/keep (..., K).  Padding rows have score -inf and
    zero boxes."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    top_s, top_i = sort_desc(torch.where(keep, scores, neg_inf))
    top_s, top_i = top_s[..., :max_out], top_i[..., :max_out]
    out_valid = top_s > neg_inf
    out_boxes = torch.gather(
        boxes, -2, top_i[..., None].expand(*top_i.shape, 6)
    )
    out_boxes = torch.where(out_valid[..., None], out_boxes, 0.0)
    return out_boxes, top_s, out_valid


def nms_3d_overlap_numpy(dets, iou_thr):
    """The plain version of the eval-merge NMS (`native.nms3d_overlap`):
    asymmetric overlap = inter / vol(other), +1 extents.

    dets: (N, 7) numpy [x1, y1, x2, y2, z1, z2, score].  Returns the kept
    indices, highest score first, in the reference `nms_3d_python` pick
    order.
    """
    dets = np.asarray(dets)
    if dets.shape[0] == 0:
        return []
    x1, y1, x2, y2, z1, z2, probs = (dets[:, i] for i in range(7))
    idxs = np.argsort(probs)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1) * (z2 - z1 + 1)
    pick = []
    while len(idxs) > 0:
        last = len(idxs) - 1
        i = idxs[last]
        pick.append(int(i))
        rest = idxs[:last]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        zz1 = np.maximum(z1[i], z1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        zz2 = np.minimum(z2[i], z2[rest])
        w = np.maximum(0, xx2 - xx1 + 1)
        h = np.maximum(0, yy2 - yy1 + 1)
        d = np.maximum(0, zz2 - zz1 + 1)
        overlap = (w * h * d) / areas[rest]
        idxs = np.delete(
            idxs, np.concatenate(([last], np.where(overlap > iou_thr)[0]))
        )
    return pick


def soft_nms_3d(dets, iou_thr=0.3, method="linear", sigma=0.5,
                min_score=1e-3):
    """Soft-NMS of 6-DoF boxes on the host (`mrcnn3d/ops/nms3d.py:
    soft_nms_3d_numpy`; the reference's Cython soft_nms_cpu, 2-D there):
    repeatedly take the best row, then decay the others' scores by their
    symmetric volume IoU (+1 extents) with it -- `linear` by 1 - IoU above
    `iou_thr`, `gaussian` by exp(-IoU^2 / sigma), `naive` to 0 above
    `iou_thr` (hard NMS) -- and drop rows below `min_score`.

    dets (N, 7) [x1, y1, x2, y2, z1, z2, score], numpy or a tensor on any
    device.  Returns (new_dets (K, 7) float32 numpy, kept original
    indices in pick order)."""
    if isinstance(dets, torch.Tensor):
        dets = dets.detach().float().cpu().numpy()
    dets = np.asarray(dets, np.float32).copy()
    idxs = np.arange(dets.shape[0])
    out, out_idx = [], []
    while len(dets):
        top = int(np.argmax(dets[:, 6]))
        best = dets[top].copy()
        out.append(best)
        out_idx.append(int(idxs[top]))
        dets = np.delete(dets, top, axis=0)
        idxs = np.delete(idxs, top)
        if not len(dets):
            break
        xa = np.maximum(best[0], dets[:, 0])
        ya = np.maximum(best[1], dets[:, 1])
        za = np.maximum(best[4], dets[:, 4])
        xb = np.minimum(best[2], dets[:, 2])
        yb = np.minimum(best[3], dets[:, 3])
        zb = np.minimum(best[5], dets[:, 5])
        inter = (np.maximum(0, xb - xa + 1) * np.maximum(0, yb - ya + 1)
                 * np.maximum(0, zb - za + 1))
        va = ((best[2] - best[0] + 1) * (best[3] - best[1] + 1)
              * (best[5] - best[4] + 1))
        vb = ((dets[:, 2] - dets[:, 0] + 1) * (dets[:, 3] - dets[:, 1] + 1)
              * (dets[:, 5] - dets[:, 4] + 1))
        iou = inter / (va + vb - inter)
        if method == "linear":
            decay = np.where(iou > iou_thr, 1.0 - iou, 1.0)
        elif method == "gaussian":
            decay = np.exp(-(iou**2) / sigma)
        else:  # naive: hard NMS
            decay = (iou <= iou_thr).astype(np.float32)
        dets[:, 6] *= decay
        keep = dets[:, 6] >= min_score
        dets = dets[keep]
        idxs = idxs[keep]
    return (np.stack(out) if out else np.zeros((0, 7), np.float32)), out_idx
