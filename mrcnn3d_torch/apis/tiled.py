"""Whole-volume inference: overlapping tiles, merged in volume coordinates.

Counterpart of `mrcnn3d/apis/tiled.py`.  The reference scales to whole
volumes by evaluating pre-cut patch datasets whose img_infos carry
pos_top/pos_left/pos_front offsets, then translating detections to
volume coordinates and merging them with a global asymmetric-overlap
NMS at 0.1 (SURVEY.md section 5; coco_utils.py:306-370).  Here:

  * the volume is uploaded once (to the card unless the detector is on
    the CPU), cast to the model dtype and laid out (1, 3, D, H, W); for
    a detector of two scales or more its 1.5x twin is derived on the
    device (`ops.resize3d`) unless the sample carries one
    (`mrcnn3d/apis/tiled.py:323, 364`); both are zero-padded so every
    tile is in bounds;
  * each tile is a slice of the device volume, run through
    `Flagship.simple_test` (K1 and K2 on the card);
  * per tile, the top `max_dets_per_tile` detections by score are kept
    and only the predicted class's mask-logit slice, as bfloat16, is
    fetched;
  * on the host, detections are translated to volume coordinates and
    merged, and masks are resized to their boxes for the survivors only.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..detectors.pipeline import bbox2result3d
from ..eval.masks import _sigmoid, box_mask_from_probs
from ..eval.results import MERGE_NMS_THR, det_entries, merge_patch_detections
from ..ops.nms3d import sort_desc
from ..ops.resize3d import resize_trilinear_3d


def tile_starts(extent, patch, stride):
    """Start offsets covering [0, extent) with overlap; last tile flush."""
    if extent <= patch:
        return [0]
    starts = list(range(0, extent - patch, stride))
    starts.append(extent - patch)
    return starts


class Sweep(NamedTuple):
    """A tile sweep over a volume and its 1.5x twin: the patch (D, H, W)
    of each scale, the tile origins of each scale, the twin's shape and
    the padded shape of each volume."""

    patch1: tuple
    patch2: tuple
    origins1: list
    origins2: list
    twin_shape: tuple
    tgt1: tuple
    tgt2: tuple


def plan_sweep(dhw, patch_hw, patch_d, overlap, up, twin_shape=None):
    """The tiles of a (D, H, W) volume (`mrcnn3d/apis/tiled.py:313-351`).

    Origins at 1.5x are round(s * up), Python's round, as in the JAX
    driver.  twin_shape: the given twin's (D, H, W); None derives it as
    round(extent * up).  The 1.5x target is the farthest origin plus the
    patch, and at least the twin's shape: round-half-even can leave the
    farthest origin plus the patch one voxel short of the twin (D 241,
    patch_d 166: 112 + 249 = 361 < 362 = round(361.5)), where the JAX
    driver's pad fails."""
    d, h, w = dhw
    patch_d = patch_d or d
    stride_hw = max(int(patch_hw * (1 - overlap)), 1)
    stride_d = max(int(patch_d * (1 - overlap)), 1)
    starts = (tile_starts(d, patch_d, stride_d),
              tile_starts(h, patch_hw, stride_hw),
              tile_starts(w, patch_hw, stride_hw))
    starts2 = [[int(round(s * up)) for s in axis] for axis in starts]
    pd2, ph2 = int(round(patch_d * up)), int(round(patch_hw * up))
    patch1, patch2 = (patch_d, patch_hw, patch_hw), (pd2, ph2, ph2)
    if twin_shape is None:
        twin_shape = tuple(int(round(n * up)) for n in dhw)
    tgt1 = tuple(max(n, p) for n, p in zip(dhw, patch1))
    tgt2 = tuple(max(max(s) + p, n)
                 for s, p, n in zip(starts2, patch2, twin_shape))
    grid = [(iz, iy, ix) for iz in range(len(starts[0]))
            for iy in range(len(starts[1])) for ix in range(len(starts[2]))]
    return Sweep(
        patch1, patch2,
        [tuple(starts[a][i] for a, i in enumerate(g)) for g in grid],
        [tuple(starts2[a][i] for a, i in enumerate(g)) for g in grid],
        tuple(twin_shape), tgt1, tgt2,
    )


def _upload(vol, device):
    """(D, H, W, C) host volume -> a float32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(vol, np.float32)).to(device)


def _pad_to(x, tgt):
    """Zero-pad (1, C, D, H, W) at the far end of D, H, W up to tgt."""
    pads = []
    for n, t in zip(reversed(x.shape[2:]), reversed(tgt)):
        pads += [0, t - n]
    return F.pad(x, pads) if any(pads) else x


def _cut(vol, origin, patch):
    (z, y, x), (pd, ph, pw) = origin, patch
    return vol[:, :, z:z + pd, y:y + ph, x:x + pw]


def tile_step(det, t1, t2, max_dets, with_masks):
    """One tile on the device (t2 None for a single-scale detector):
    simple_test, the top `max_dets` valid rows
    by score (a stable sort, so the order is lax.top_k's), and the
    predicted class's mask-logit slice as bfloat16.  Returns (dets (k,
    7), labels (k,), valid (k,)[, masks (k, Dm, Hm, Wm)]) on the device."""
    batch = dict(imgs=t1)
    if t2 is not None:
        batch["imgs_2"] = t2
    out = det.simple_test(batch)
    dets, labels, valid = out["dets"][0], out["labels"][0], out["valid"][0]
    top_i = None
    if max_dets is not None and max_dets < dets.shape[0]:
        neg_inf = torch.tensor(float("-inf"), device=dets.device)
        top_s, top_i = sort_desc(torch.where(valid, dets[:, 6].float(),
                                             neg_inf))
        top_s, top_i = top_s[:max_dets], top_i[:max_dets]
        dets, labels = dets[top_i], labels[top_i]
        valid = valid[top_i] & torch.isfinite(top_s)
    res = (dets, labels, valid)
    if with_masks:
        ml = out["mask_logits"]
        if top_i is not None:
            ml = ml[top_i]
        rows = torch.arange(ml.shape[0], device=ml.device)
        res += (ml[rows, labels.long() + 1].to(torch.bfloat16),)
    return res


def tiled_inference(det, volume_sample, patch_hw=256, patch_d=None,
                    overlap=0.25, merge_thr=MERGE_NMS_THR,
                    max_dets_per_tile=256, timers=None):
    """Patch-tiled inference over one whole volume with `det`, an
    `entry.Flagship`.

    volume_sample: imgs (D, H, W, 3) normalised, and optionally its
    1.5x twin imgs_2, numpy.  Returns per-class (n, 7) float32 arrays
    [x1, y1, x2, y2, z1, z2, score] in volume coordinates after the
    merge NMS; when the config computes masks (test_cfg
    return_bbox_only False), (per_class, segms): per class, a
    {box, mask, shape} carrier per detection, the box-extent uint8 mask
    in volume coordinates (`eval.masks.paste_mask_3d` pastes it;
    `CocoEval3D` takes it as it is).

    timers: optional dict; wall seconds of each phase are added to it
    (upload, derive_twin_pad, first_tile, tile_device_step, fetch,
    host_entries, merge_nms, deferred_mask_realise), with n_tiles,
    n_entries and n_merged.  On the card every device phase ends in a
    synchronize, so its time is the device's.
    """
    model, cfg, device = det.model, det.cfg, det.device
    dtype = next(model.parameters()).dtype
    with_masks = model.with_mask and not cfg.test_cfg.get(
        "return_bbox_only", False)
    two_scale = model.num_scales >= 2
    mask_thr = cfg.test_cfg["rcnn"].get("mask_thr_binary", 0.25)
    num_classes = model.num_classes

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def acc(key, t0):
        if timers is not None:
            timers[key] = timers.get(key, 0.0) + time.perf_counter() - t0

    img = volume_sample["imgs"]
    twin = volume_sample.get("imgs_2")
    d, h, w, _ = img.shape
    sweep = plan_sweep(
        (d, h, w), patch_hw, patch_d, overlap, cfg.get("upscale_factor", 1.5),
        None if twin is None else tuple(twin.shape[:3]),
    )

    t0 = time.perf_counter()
    raw = _upload(img, device)
    raw2 = None if twin is None or not two_scale else _upload(twin, device)
    sync()
    acc("upload", t0)
    t0 = time.perf_counter()
    vol = raw.to(dtype).permute(3, 0, 1, 2)[None].contiguous()
    del raw
    if not two_scale:
        vol2 = None
    elif raw2 is None:
        vol2 = _pad_to(resize_trilinear_3d(vol, sweep.twin_shape),
                       sweep.tgt2)
    else:
        vol2 = _pad_to(raw2.to(dtype).permute(3, 0, 1, 2)[None]
                       .contiguous(), sweep.tgt2)
        del raw2
    vol = _pad_to(vol, sweep.tgt1)
    sync()
    acc("derive_twin_pad", t0)

    entries = []
    for i, (o1, o2) in enumerate(zip(sweep.origins1, sweep.origins2)):
        t0 = time.perf_counter()
        t2 = None if vol2 is None else _cut(vol2, o2, sweep.patch2)
        out = tile_step(det, _cut(vol, o1, sweep.patch1), t2,
                        max_dets_per_tile, with_masks)
        sync()
        acc("tile_device_step" if i else "first_tile", t0)
        t0 = time.perf_counter()
        out = [t.cpu() for t in out]
        acc("fetch", t0)
        t0 = time.perf_counter()
        dets, labels, valid = out[:3]
        z0, y0, x0 = o1
        patch_entries = det_entries(
            bbox2result3d(dets, labels, valid, num_classes),
            dict(id=0, pos_left=x0, pos_top=y0, pos_front=z0),
        )
        if with_masks:
            # the raw class-gathered probs and the int box per entry; the
            # resize to box extents waits for the merge NMS.  Rows in
            # bbox2result3d's per-class order, which det_entries keeps
            probs = _sigmoid(out[3].float().numpy())
            vmask = valid.numpy().astype(bool)
            lbl = labels.numpy()
            rows = [i for c in range(num_classes - 1)
                    for i in np.nonzero(vmask & (lbl == c))[0]]
            shift = np.array([x0, y0, x0, y0, z0, z0], np.int32)
            boxes_int = dets.numpy()[:, :6].astype(np.int32)
            for e, r in zip(patch_entries, rows):
                e["segmentation"] = dict(box=boxes_int[r] + shift,
                                         probs=probs[r], shape=(d, h, w))
        entries.extend(patch_entries)
        acc("host_entries", t0)
    del vol, vol2

    t0 = time.perf_counter()
    merged = merge_patch_detections(entries, merge_thr)
    acc("merge_nms", t0)
    t0 = time.perf_counter()
    for e in merged:
        seg = e.get("segmentation")
        if seg is not None:
            seg["mask"] = box_mask_from_probs(seg.pop("probs"), seg["box"],
                                              mask_thr)
    acc("deferred_mask_realise", t0)
    if timers is not None:
        timers.update(n_tiles=len(sweep.origins1), n_entries=len(entries),
                      n_merged=len(merged))

    out = [[] for _ in range(num_classes - 1)]
    segms = [[] for _ in range(num_classes - 1)]
    for e in merged:
        b = e["bbox"]
        out[e["category_id"] - 1].append([
            b[0], b[1], b[0] + b[2] - 1, b[1] + b[3] - 1, b[4],
            b[4] + b[5] - 1, e["score"],
        ])
        if "segmentation" in e:
            segms[e["category_id"] - 1].append(e["segmentation"])
    per_class = [np.asarray(x, np.float32).reshape(-1, 7) for x in out]
    if with_masks:
        return per_class, segms
    return per_class
