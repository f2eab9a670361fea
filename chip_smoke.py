#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mrcnn3d_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. device   -- CUDA is required; prints nvidia-smi's name and power limit.
  2. build    -- nvcc builds both kernels from mrcnn3d_torch/csrc/.
  3. kernels  -- each kernel against its plain PyTorch version at the shapes
                 the main path gives it (TF32 off): K1 (3-D NMS) on the 10
                 proposal segments and on the 4000-row class-wise problem,
                 keep masks exactly equal; K2 (RoIAlign3D) at bbox geometry
                 on the 1.0x and 1.5x pyramids and at mask geometry, and on
                 2000 rois that take its direct-read path (oversized and
                 thin-wide), 1e-4 in float32 and, in bfloat16, 2e-2 or one
                 bf16 step of the plain value.  K2's rois by path (window,
                 direct), as the kernel counts them, must equal its rule
                 applied to the plain version's taps.  Median of CUDA-event
                 times, and device time per launch from torch.profiler.
  4. small    -- the narrow two-scale pipeline on the card (kernels) against
                 the CPU (plain versions): valid and labels equal, dets and
                 mask logits of valid rows within 2e-3.
  5. main     -- the flagship at full width and the bench.py headline
                 geometry: a 64x512x512 volume plus its 96x768x768 twin,
                 bfloat16, every budget 2000, boxes and masks, seeded random
                 weights; 1 warm-up and 3 timed volume pairs.  The kernels'
                 launch counters (and K2's rois by path) are zeroed just
                 before and read just after.
                 Then one profiled step, and one step whose K1 and K2
                 launches are recorded with their arguments.
  6. step_kernels -- each launch of that recorded step, on the arguments
                 the main path gave it, against the plain version (same
                 tolerances) and timed alone: the per-step kernel times;
                 then K2's direct-read path on the step's own mask-align
                 features and geometry.
Then the kernels line, the card line and, last, the result line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
not 0 and no result line is printed.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "mask_rcnn_3d_2scales.py")

# H100 SXM data-sheet peaks (dense): HBM bytes/s, FP32 (non-tensor) ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

MAIN_SHAPES = [(64, 512, 512), (96, 768, 768)]
MAIN_BUDGET = 2000
SMALL_SHAPES = [(8, 32, 32), (12, 48, 48)]
SMALL_BUDGET = 64
NMS_PROPOSAL_K = [[2000, 2000, 2000, 1024, 128], [2000, 2000, 2000, 2000, 432]]
NMS_CLASSWISE_K = 4000
# K2 against its plain version: absolute; a bfloat16 value may also differ
# by one bf16 step (both versions round an f32 sum to bf16)
ALIGN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PIPELINE_ATOL = 2e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def require_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "mrcnn3d_torch", "csrc")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the repo")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=1):
    """Median milliseconds of `fn` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the CUDA kernels behind each wrapper, as the profiler names them
KERNEL_CUDA_NAMES = {
    "nms3d": ("nms3d_mask_kernel", "nms3d_scan_kernel"),
    "roi_align3d": ("roi_align3d_kernel", "roi_align3d_direct_kernel"),
}


def kernel_ms(prof, cuda_names):
    """{name: device ms} of the CUDA kernels named `cuda_names` in a
    profile."""
    import torch

    by_name = dict.fromkeys(cuda_names, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in cuda_names:
            if f"::{k}(" in e.name or f"::{k}<" in e.name:
                by_name[k] += (e.time_range.end - e.time_range.start) / 1e3
    return by_name


def device_ms(fn, cuda_names, iters=5, tries=2):
    """{name: device ms per call} of `fn`'s CUDA kernels named
    `cuda_names`, from torch.profiler over `iters` calls after one
    warm-up; None when no try's trace holds any of them (the profiler
    now and then returns a trace without the device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = kernel_ms(prof, cuda_names)
        if any(by_name.values()):
            return {k: ms / iters for k, ms in by_name.items()}
    return None


def sum_or_none(values):
    """Sum of the values, None if any is None."""
    values = list(values)
    return None if None in values else sum(values)


def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time for that work."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# synthetic main-path inputs
# ---------------------------------------------------------------------------


def proposal_boxes(gen, k, shape, device):
    """k proposal-like boxes in a (D, H, W) volume: clustered around
    k/8 centres, xy extents 8..256 voxels, depth 4..48; scores in [0, 1),
    2% invalid rows.  Returns (boxes (k, 6), scores (k,), valid (k,))."""
    import torch

    d, h, w = shape
    lim = torch.tensor([w, h, d], dtype=torch.float32, device=device)
    centres = torch.rand((k // 8 + 1, 3), generator=gen, device=device) * lim
    pick = torch.randint(0, centres.shape[0], (k,), generator=gen,
                         device=device)
    u = torch.rand((k, 3), generator=gen, device=device)
    size = torch.stack([
        torch.exp(u[:, 0] * 3.5 + 2.08),
        torch.exp(u[:, 1] * 3.5 + 2.08),
        torch.exp(u[:, 2] * 2.5 + 1.39),
    ], 1)
    c = centres[pick] + torch.randn((k, 3), generator=gen,
                                    device=device) * size / 6
    lo = torch.minimum(torch.maximum(c - size / 2, lim * 0), lim - 1)
    hi = torch.minimum(torch.maximum(c + size / 2, lo), lim - 1)
    boxes = torch.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1],
                         lo[:, 2], hi[:, 2]], 1)
    scores = torch.rand((k,), generator=gen, device=device)
    valid = torch.rand((k,), generator=gen, device=device) > 0.02
    return boxes, scores, valid


def pyramid(gen, model, shape, dtype, device):
    """Random FPN levels of the shapes the detector gives a (D, H, W)
    volume, in channels_last_3d storage, as the backbone produces them."""
    import torch

    c = model.neck.fpn_convs[0].conv.out_channels
    return [
        torch.randn((1, c, *s), generator=gen, device=device)
        .to(dtype).contiguous(memory_format=torch.channels_last_3d)
        for s in model.featmap_sizes(shape)[:4]
    ]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_nms(gen, device):
    """K1 on synthetic proposal-like boxes at the main path's segment
    sizes."""
    import torch

    from mrcnn3d_torch.ops import nms3d

    problems = [
        ("proposals_1.0x", NMS_PROPOSAL_K[0], MAIN_SHAPES[0], 0.7),
        ("proposals_1.5x", NMS_PROPOSAL_K[1], MAIN_SHAPES[1], 0.7),
        ("classwise", [NMS_CLASSWISE_K], MAIN_SHAPES[0], 0.5),
    ]
    calls = []
    for name, counts, shape, thr in problems:
        parts = [proposal_boxes(gen, k, shape, device) for k in counts]
        boxes, scores, valid = (torch.cat(p) for p in zip(*parts))
        order = nms3d.segment_order(scores, valid, counts)
        calls.append(nms_case(name, boxes[order].contiguous(), valid[order],
                              counts, thr))
    return calls


def nms_case(name, sboxes, svalid, counts, thr):
    """K1 against its plain version on one launch's inputs: keep flags
    exactly equal; median times of both; the bound of this work."""
    import torch

    from mrcnn3d_torch.ops import nms3d

    got = nms3d.greedy_scan_cuda(sboxes, svalid, counts, thr)
    want = nms3d.greedy_scan_plain(sboxes, svalid, counts, thr)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"K1 {name}: {mismatches} keep flags differ")
    ms = time_ms(lambda: nms3d.greedy_scan_cuda(sboxes, svalid, counts, thr))
    dev_ms = device_ms(
        lambda: nms3d.greedy_scan_cuda(sboxes, svalid, counts, thr),
        KERNEL_CUDA_NAMES["nms3d"])
    plain_ms = time_ms(lambda: nms3d.greedy_scan_plain(
        sboxes, svalid, counts, thr), iters=2, warmup=0)
    total = sum(counts)
    nbytes = total * (6 * 4 + 1) + total  # boxes + valid in, keep out
    ops = sum(k * (k - 1) // 2 for k in counts) * 28  # 28 f32 ops/IoU
    b_ms, b_by = bound(nbytes, ops)
    return dict(
        name=name, segments=list(counts), iou_thr=thr,
        valid=int(svalid.sum()), kept=int(got.sum()),
        ms=ms, device_ms=dev_ms and sum_or_none(dev_ms.values()),
        device_ms_by_kernel=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, ops=ops, max_abs_err=0.0,
    )


def axis_taps(rois, levels, feats_cl, out, out_d, strides, strides_d, sn):
    """Per axis (x, y, z), the plain version's taps of `rois` on each
    roi's level: (low, high, w_low, w_high, in_range), each (N, samples)."""
    import torch

    from mrcnn3d_torch.ops.roi_align3d import _axis_samples, _interp

    t = levels.long()
    shape = torch.tensor([f.shape[1:4] for f in feats_cl],
                         device=rois.device)[t]
    inv = torch.tensor([[1.0 / s, 1.0 / sd] for s, sd in
                        zip(strides, strides_d)], device=rois.device)[t]
    taps = []
    for lo_col, hi_col, dim, scale, pooled in (
        (1, 3, shape[:, 2], inv[:, 0], out),
        (2, 4, shape[:, 1], inv[:, 0], out),
        (5, 6, shape[:, 0], inv[:, 1], out_d),
    ):
        lo = rois[:, lo_col] * scale
        ext = (rois[:, hi_col] + 1.0) * scale - lo
        coords = _axis_samples(lo, ext.clamp(min=0.0), pooled, sn)
        taps.append(_interp(coords, dim))
    return taps


def _span(low, high, inr):
    """First voxel and voxel count of the in-range taps (0 if none)."""
    import torch

    big = torch.iinfo(low.dtype).max
    first = torch.where(inr, low, big).min(1).values
    last = torch.where(inr, high, -1).max(1).values
    return first, torch.where(last >= 0, last - first + 1, 0)


def window_need(nx, ny, c, elt, out):
    """Shared memory (bytes) a K2 block's window path needs at least for
    an nx x ny window of c channels, as csrc/roi_align3d.cu:window_bytes
    counts it for the block's share of the channels."""
    from mrcnn3d_torch.ops.roi_align3d import CHANNEL_BLOCK

    cb = min(c, CHANNEL_BLOCK)
    return ny * out * cb * 4 + cb * (out * out | 1) * elt + nx * ny * cb * elt


def align_geometry(feats_cl, rois, levels, valid, out, out_d, strides,
                   strides_d, sn):
    """What K2's work on these arguments is, from the plain version's
    taps: the bytes of the touched feature voxels (each once), the
    operations of the separable form over each roi's touched window, the
    rois that take the window and the direct path (the kernel's rule),
    and the largest window (staged plane and shared memory need)."""
    import torch

    from mrcnn3d_torch.ops.roi_align3d import WINDOW_BYTES

    c = feats_cl[0].shape[-1]
    elt = feats_cl[0].element_size()
    # on the CPU, whose operations round as the kernel's tap arithmetic
    # (PyTorch on the card divides by a scalar through its reciprocal)
    sel = valid.bool().cpu()
    r, lv = rois.cpu()[sel].float(), levels.cpu()[sel]
    (xl, xh, _, _, xin), (yl, yh, _, _, yin), (zl, zh, _, _, zin) = \
        axis_taps(r, lv, feats_cl, out, out_d, strides, strides_d, sn)
    x0, nx = _span(xl, xh, xin)
    y0, ny = _span(yl, yh, yin)
    need = window_need(nx, ny, c, elt, out)
    direct = need > WINDOW_BYTES
    # distinct z planes per output depth plane (in-range taps only)
    zs = torch.stack([zl, zh], -1).reshape(r.shape[0], out_d, 2 * sn)
    zs = torch.where(zin.reshape(r.shape[0], out_d, sn)
                     .repeat_interleave(2, -1), zs, -1).sort(-1).values
    planes = ((zs[..., 1:] != zs[..., :-1]) & (zs[..., 1:] >= 0)).sum(-1) \
        + (zs[..., 0] >= 0)
    empty = (nx == 0) | (ny == 0)
    rows = torch.where(empty, 0, ny)[:, None]
    ops = int((c * (planes * rows * out * 4 * sn
                    + (planes > 0) * (~empty)[:, None] * out * out * 4 * sn))
              .sum())
    # touched voxels: the union of the rois' touched boxes, per level
    touched = 0
    z0, nz = _span(zl, zh, zin)
    for lvl, f in enumerate(feats_cl):
        on = (lv == lvl) & ~empty & (nz > 0)
        if not bool(on.any()):
            continue
        mark = torch.zeros(f.shape[:4], dtype=torch.bool)
        for b, zz, yy, xx, dz, dy, dx in zip(*(
                v[on].tolist() for v in (r[:, 0].long(), z0, y0, x0, nz,
                                         ny, nx))):
            mark[b, zz:zz + dz, yy:yy + dy, xx:xx + dx] = True
        touched += int(mark.sum()) * c * elt
    return dict(
        touched_bytes=touched, ops=ops,
        paths={"window": int((~direct).sum()), "direct": int(direct.sum())},
        max_window_bytes=int((nx * ny * c * elt).max()) if len(nx) else 0,
        max_smem_need=int(need.max()) if len(nx) else 0,
    )


def direct_rois(gen, k, shape, device):
    """k rois that K2's window path cannot stage in a 512 x 512 volume:
    half are oversized for their level (about 420 x 420 voxels but one
    slice deep, so the volume rule puts them on level 2, where their
    window is ~27 x 27 voxels), half are thin and wide (a band of 16-20
    rows across the volume, one slice deep, on the finest level).
    Returns rois (k, 7)."""
    import torch

    d, h, w = shape
    u = torch.rand((k, 3), generator=gen, device=device)
    x = u[:, 0] * (w - 440)
    y = u[:, 1] * (h - 440)
    z = u[:, 2] * (d - 1)
    big = torch.stack([x, y, x + 400 + u[:, 1] * 30, y + 400 + u[:, 0] * 30,
                       z, z], 1)
    y = u[:, 0] * (h - 24)
    thin = torch.stack([
        u[:, 1] * 16, y, w - 1 - u[:, 2] * 16, y + 15 + u[:, 1] * 4,
        u[:, 2] * (d - 1), u[:, 2] * (d - 1)], 1)
    boxes = torch.where((torch.arange(k, device=device) % 2 == 0)[:, None],
                        big, thin)
    return torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)


def check_align(gen, det, device):
    """K2 on random pyramids and 2000 synthetic rois (2% invalid): the
    most rows an align of the main path can take; then 2000 rois that
    take the direct-read path."""
    import torch

    from mrcnn3d_torch.ops import roi_align3d as ra

    bcfg = align_cfg(det.cfg, "bbox")
    mcfg = align_cfg(det.cfg, "mask")
    cases = [
        ("bbox_1.0x", MAIN_SHAPES[0], bcfg, torch.float32),
        ("bbox_1.0x", MAIN_SHAPES[0], bcfg, torch.bfloat16),
        ("bbox_1.5x", MAIN_SHAPES[1], bcfg, torch.bfloat16),
        ("mask_1.0x", MAIN_SHAPES[0], mcfg, torch.bfloat16),
        ("mask_1.0x_direct", MAIN_SHAPES[0], mcfg, torch.bfloat16),
    ]
    calls = []
    for name, shape, geometry, dtype in cases:
        feats = ra.channels_last_levels(
            pyramid(gen, det.model, shape, dtype, device))
        if name.endswith("_direct"):
            rois = direct_rois(gen, MAIN_BUDGET, shape, device)
            valid = torch.ones(MAIN_BUDGET, dtype=torch.bool, device=device)
        else:
            boxes, _, valid = proposal_boxes(gen, MAIN_BUDGET, shape, device)
            rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
        levels = ra.map_roi_levels(rois, len(feats))
        calls.append(align_case(name, (feats, rois, levels, valid,
                                       *geometry)))
    if calls[-1]["paths"]["direct"] == 0:
        raise AssertionError("K2: the direct-read case took no direct path")
    return calls


def align_case(name, args):
    """K2 against its plain version on one launch's arguments (those of
    `roi_align_3d_cuda`): max error within the dtype's tolerance; the rois
    each path took, counted by the kernel and equal to its rule applied
    to the plain version's taps; median event times of both versions and
    the kernel's device time per launch; the bound of the work this data
    needs."""
    import torch

    from mrcnn3d_torch.ops import roi_align3d as ra

    feats, rois, levels, valid, out, out_d, strides, strides_d, sn = args
    dtype = feats[0].dtype
    ra.reset_path_counts()
    got = ra.roi_align_3d_cuda(*args)
    paths = ra.path_counts()
    want = ra.roi_align_3d_plain(*args)
    torch.cuda.synchronize()
    geo = align_geometry(*args)
    if paths != geo["paths"]:
        raise AssertionError(f"K2 {name}: paths {paths}, the window rule "
                             f"gives {geo['paths']}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = ALIGN_TOL[str(dtype).split(".")[-1]]
    ok = diff <= tol
    if dtype == torch.bfloat16:
        # both round an f32 sum to bf16: sums that differ in their last
        # bits may land on neighbouring bf16 values, one step apart
        _, e = torch.frexp(want.float())
        ok |= diff <= torch.ldexp(torch.ones_like(diff), e - 8)
    if not bool(ok.all()):
        raise AssertionError(
            f"K2 {name} {dtype}: {int((~ok).sum())} values differ by more "
            f"than {tol} and one bf16 step; max error {err}")
    del diff, ok
    ms = time_ms(lambda: ra.roi_align_3d_cuda(*args))
    dev_ms = device_ms(lambda: ra.roi_align_3d_cuda(*args),
                       KERNEL_CUDA_NAMES["roi_align3d"])
    plain_ms = time_ms(lambda: ra.roi_align_3d_plain(*args), iters=2,
                       warmup=0)
    n_valid = int(valid.sum())
    # inputs once (touched voxels, rois, levels, valid), the output once
    nbytes = (geo["touched_bytes"] + rois.numel() * 4 + rois.shape[0] * 5
              + got.numel() * got.element_size())
    b_ms, b_by = bound(nbytes, geo["ops"])
    return dict(
        name=name, dtype=str(dtype).split(".")[-1], rois=rois.shape[0],
        valid=n_valid,
        levels=[int((levels[valid] == i).sum()) for i in range(len(feats))],
        paths=paths, max_window_bytes=geo["max_window_bytes"],
        max_smem_need=geo["max_smem_need"], window_budget=ra.WINDOW_BYTES,
        max_abs_out=float(want.float().abs().max()) if want.numel() else 0.0,
        ms=ms, device_ms=dev_ms and sum_or_none(dev_ms.values()),
        device_ms_by_kernel=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, ops=geo["ops"], max_abs_err=err,
        tol=tol,
    )


def align_cfg(cfg, which):
    """(out, out_d, strides, strides_d, sample_num) of an roi extractor."""
    rcfg = cfg.model[f"{which}_roi_extractor"]
    layer = rcfg["roi_layer"]
    return (layer["out_size"], layer["out_size_depth"],
            rcfg["featmap_strides"], rcfg["featmap_strides_depth"],
            layer["sample_num"])


# ---------------------------------------------------------------------------
# phase 4: the small pipeline, card against CPU
# ---------------------------------------------------------------------------


def main_config():
    """The flagship config with masks on (it asks for boxes only), as
    bench.py runs it."""
    from mrcnn3d_torch.utils.config import Config

    cfg = Config.fromfile(CONFIG)
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


def small_config():
    """The flagship config at narrow widths (depth 50 kept)."""
    cfg = main_config()
    cfg.model["backbone"]["base_width"] = 4
    cfg.model["neck"]["out_channels"] = 8
    for head in ("bbox_head", "refinement_head"):
        cfg.model[head]["fc_out_channels"] = 32
    return cfg


def small_inputs(seed, with_proposals):
    """numpy inputs of the small pipeline (NCDHW volumes, proposals)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    batch = {
        "imgs": rng.randn(1, 3, *SMALL_SHAPES[0]).astype(np.float32),
        "imgs_2": rng.randn(1, 3, *SMALL_SHAPES[1]).astype(np.float32),
    }
    if with_proposals:
        m = 24
        xy = rng.uniform(0, 24, (m, 2))
        z = rng.uniform(0, 6, (m, 1))
        size = rng.uniform(4, 16, (m, 3))
        props = np.concatenate([xy, xy + size[:, :2], z,
                                np.minimum(z + size[:, 2:] / 3, 7)], 1)
        valid = rng.rand(m) > 0.2
        batch.update(
            proposals=props[None].astype(np.float32),
            proposals_2=(props * 1.5)[None].astype(np.float32),
            proposals_valid=valid[None],
            proposals_valid_2=valid[None],
        )
    return batch


def small_run(det, batch, scale=1.0):
    """The small pipeline on `det`'s device; numpy outputs."""
    import torch

    tb = {k: torch.from_numpy(v).to(det.device) for k, v in batch.items()}
    for k in ("imgs", "imgs_2"):
        tb[k] = tb[k] * scale
    out = det.simple_test(tb)
    return {k: v.cpu().numpy() for k, v in out.items()}


def compare_outputs(a, b, atol, what):
    """valid and labels equal; dets and mask logits of valid rows within
    atol.  Returns the largest difference."""
    import numpy as np

    for key in ("valid", "labels"):
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"{what}: {key} differ")
    v = a["valid"].reshape(-1)
    err = 0.0
    for key, rows in (("dets", a["dets"].reshape(-1, 7)),
                      ("mask_logits", a["mask_logits"])):
        other = (b["dets"].reshape(-1, 7) if key == "dets"
                 else b["mask_logits"])
        e = float(np.abs(rows[v] - other[v]).max()) if v.any() else 0.0
        if not e <= atol:
            raise AssertionError(f"{what}: {key} differ by {e} > {atol}")
        err = max(err, e)
    return err


def check_small_pipeline(device):
    from mrcnn3d_torch.entry import build

    cfg = small_config()
    gpu = build(cfg, device=device, budgets=SMALL_BUDGET)
    cpu = build(cfg, device="cpu", budgets=SMALL_BUDGET)
    result = {}
    for with_proposals in (False, True):
        batch = small_inputs(7, with_proposals)
        a = small_run(gpu, batch)
        b = small_run(cpu, batch)
        err = compare_outputs(a, b, PIPELINE_ATOL, "small pipeline")
        key = "proposals" if with_proposals else "rpn"
        result[key] = dict(detections=int(a["valid"].sum()),
                           max_abs_err=err)
    return result


# ---------------------------------------------------------------------------
# phase 5: the full-width main path
# ---------------------------------------------------------------------------


class StageTimer:
    """`mark` hook of simple_test: a CUDA event per stage boundary."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def stages_ms(self):
        return {
            name: prev.elapsed_time(ev)
            for (_, prev), (name, ev) in zip(self.events, self.events[1:])
        }


def run_main_path(device, steps=3):
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.ops import nms3d, roi_align3d

    torch.backends.cudnn.benchmark = True
    det = build(main_config(), device=device, dtype=torch.bfloat16,
                budgets=MAIN_BUDGET, seed=0)
    gen = torch.Generator(device=device).manual_seed(11)
    imgs = [torch.randn((1, 3, *s), generator=gen, device=device)
            .to(torch.bfloat16) for s in MAIN_SHAPES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms3d.launches = 0
    roi_align3d.launches = 0
    roi_align3d.reset_path_counts()
    walls, stages, outs = [], [], None
    for step in range(1 + steps):
        timer = StageTimer()
        t0 = time.perf_counter()
        out = det.simple_test(dict(imgs=imgs[0], imgs_2=imgs[1]), mark=timer)
        torch.cuda.synchronize()
        if step:
            walls.append(time.perf_counter() - t0)
            stages.append(timer.stages_ms())
        outs = out
    launches = {"nms3d": nms3d.launches, "roi_align3d": roi_align3d.launches}
    k2_paths = roi_align3d.path_counts()
    n_steps = 1 + steps

    dets, labels, valid = outs["dets"], outs["labels"], outs["valid"]
    masks = outs["mask_logits"]
    b = MAIN_BUDGET
    expect = {"dets": (1, b, 7), "labels": (1, b), "valid": (1, b),
              "mask_logits": (b, 2, 20, 28, 28)}
    for key, shape in expect.items():
        if tuple(outs[key].shape) != shape:
            raise AssertionError(f"{key} shape {tuple(outs[key].shape)}")
    n_det = int(valid.sum())
    if n_det == 0:
        raise AssertionError("no detections at full width")
    if not bool(torch.isfinite(dets[valid]).all()):
        raise AssertionError("non-finite detections")
    if not bool(torch.isfinite(masks.float()).all()):
        raise AssertionError("non-finite mask logits")
    per_step = {"nms3d": 3, "roi_align3d": 4}
    for name, count in per_step.items():
        if launches[name] != count * n_steps:
            raise AssertionError(
                f"{name}: {launches[name]} launches in {n_steps} steps, "
                f"expected {count} per step"
            )
    names = stages[0].keys()
    stage_ms = {k: float(np.median([s[k] for s in stages])) for k in names}
    batch = dict(imgs=imgs[0], imgs_2=imgs[1])
    profile = profile_step(lambda: det.simple_test(batch))
    with Capture() as captured:
        det.simple_test(batch)
    torch.cuda.synchronize()
    return dict(
        steps=steps, step_s=walls, median_step_s=float(np.median(walls)),
        volume_pairs_per_s=1.0 / float(np.median(walls)),
        stage_ms=stage_ms, detections=n_det,
        labels=sorted(set(labels[valid].tolist())),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, launches_per_step=per_step,
        k2_rois_by_path=k2_paths, profile=profile,
    ), captured


class Capture:
    """Within the block, records the arguments of every launch of K1 and
    K2 (calling the kernels as usual), by wrapping the two wrappers."""

    def __enter__(self):
        from mrcnn3d_torch.ops import nms3d, roi_align3d

        self.calls = {"nms3d": [], "roi_align3d": []}
        self._saved = [
            (nms3d, "greedy_scan_cuda", nms3d.greedy_scan_cuda),
            (roi_align3d, "roi_align_3d_cuda", roi_align3d.roi_align_3d_cuda),
        ]
        for (mod, attr, fn), calls in zip(self._saved, self.calls.values()):
            setattr(mod, attr, self._recorder(fn, calls))
        return self

    @staticmethod
    def _recorder(fn, calls):
        def record(*args):
            calls.append(args)
            return fn(*args)

        return record

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


# names of one step's launches, in the order simple_test makes them
STEP_CALLS = {
    "nms3d": ["proposals_1.0x", "proposals_1.5x", "classwise"],
    "roi_align3d": ["bbox_1.0x", "bbox_1.5x", "refinement_1.0x",
                    "mask_1.0x"],
}


def check_step_kernels(captured):
    """Each launch of one main-path step, on the arguments it was given
    there, against the plain version, and timed alone."""
    got = {k: len(v) for k, v in captured.calls.items()}
    want = {k: len(v) for k, v in STEP_CALLS.items()}
    if got != want:
        raise AssertionError(f"launches in the captured step: {got}, "
                             f"expected {want}")
    import torch

    from mrcnn3d_torch.ops import roi_align3d as ra

    # the direct-read path at the step's own mask align: its features and
    # geometry, with rois the window path cannot stage
    feats, rois = captured.calls["roi_align3d"][-1][:2]
    gen = torch.Generator(device=rois.device).manual_seed(13)
    direct = direct_rois(gen, MAIN_BUDGET, MAIN_SHAPES[0], rois.device)
    direct_args = (feats, direct, ra.map_roi_levels(direct, len(feats)),
                   torch.ones(MAIN_BUDGET, dtype=torch.bool,
                              device=rois.device),
                   *captured.calls["roi_align3d"][-1][4:])
    out = {
        "nms3d": [nms_case(name, *args) for name, args in
                  zip(STEP_CALLS["nms3d"], captured.calls["nms3d"])],
        "roi_align3d": [align_case(name, args) for name, args in
                        zip(STEP_CALLS["roi_align3d"],
                            captured.calls["roi_align3d"])],
        "roi_align3d_direct": align_case("mask_1.0x_direct", direct_args),
    }
    if out["roi_align3d_direct"]["paths"]["direct"] == 0:
        raise AssertionError("K2: the direct-read case took no direct path")
    return out


def profile_step(step, top=12):
    """One more step under torch.profiler: device busy time (the union of
    kernel intervals), the span from the first kernel's start to the last
    one's end, the idle share of that span, the device time of K1's and
    K2's CUDA kernels, and the kernels that take the most device time.
    None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return None
    busy, end, by_name = 0.0, spans[0][0], {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    span_ms = (end - spans[0][0]) / 1e3
    port_ms = {kernel: sum(kernel_ms(prof, names).values())
               for kernel, names in KERNEL_CUDA_NAMES.items()}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the operator that launched each kernel, with its input shapes
    ops = sorted(
        prof.key_averages(group_by_input_shape=True),
        key=lambda a: -a.self_device_time_total,
    )[:top]
    return dict(
        kernels=len(spans), busy_ms=busy / 1e3, span_ms=span_ms,
        idle_share=1.0 - busy / 1e3 / span_ms, port_kernels_ms=port_ms,
        top_kernels_ms=[[name[:80], ms] for name, ms in ranked],
        top_ops_ms=[[a.key, str(a.input_shapes)[:120], a.count,
                     a.self_device_time_total / 1e3] for a in ops],
    )


def kernels_line(nms_calls, align_calls, step_calls, main_path):
    """The {"kernels": [...]} record.  Per kernel: launches from the
    counted main-path run; ms (CUDA events), device_ms (profiler), plain_ms
    and the bound summed over one step's launches, each run alone on the
    arguments the main path gave it; the profiled device time of the same
    kernel within one step; the largest error of every comparison (phase
    3 and the step's calls)."""
    profile = main_path["profile"] or {}
    kernels = []
    for name, src, replaces, checked in (
        ("nms3d", "mrcnn3d_torch/csrc/nms3d.cu",
         "mrcnn3d/ops/nms3d_pallas.py:26", nms_calls),
        ("roi_align3d", "mrcnn3d_torch/csrc/roi_align3d.cu",
         "mrcnn3d/ops/roi_align3d_pallas.py:76", align_calls),
    ):
        calls = step_calls[name]
        checked = checked + ([step_calls["roi_align3d_direct"]]
                             if name == "roi_align3d" else [])
        b_ms, b_by = bound(sum(c["bytes"] for c in calls),
                           sum(c["ops"] for c in calls))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "launches_per_step": main_path["launches_per_step"][name],
            "max_abs_err": max(c["max_abs_err"] for c in checked + calls),
            "ms": sum(c["ms"] for c in calls),
            "device_ms": sum_or_none(c["device_ms"] for c in calls),
            "plain_ms": sum(c["plain_ms"] for c in calls),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "profiled_ms_per_step":
                profile.get("port_kernels_ms", {}).get(name),
            "matched": True,
            "per_step_calls": [
                {k: c[k] for k in ("name", "valid", "ms", "device_ms",
                                   "device_ms_by_kernel", "plain_ms",
                                   "bound_ms", "bound_by")}
                for c in calls
            ],
        })
    return {"kernels": kernels}


def main():
    t_start = time.perf_counter()
    require_card()
    import torch

    card = card_line()
    emit({"phase": "device", "ok": True, "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t_start})

    from mrcnn3d_torch.ops import _cuda

    t = time.perf_counter()
    report = _cuda.build()
    regs = {
        name: [ln.strip() for ln in r["ptxas"].splitlines()
               if "registers" in ln]
        for name, r in report.items()
    }
    emit({"phase": "build", "ok": True,
          "kernels": {k: r["seconds"] for k, r in report.items()},
          "ptxas": regs, "seconds": time.perf_counter() - t})

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    from mrcnn3d_torch.entry import build

    t = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(5)
    nms_calls = check_nms(gen, device)
    shape_model = build(CONFIG, device=device, budgets=MAIN_BUDGET)
    align_calls = check_align(gen, shape_model, device)
    del shape_model
    emit({"phase": "kernels", "ok": True, "nms3d": nms_calls,
          "roi_align3d": align_calls, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    small = check_small_pipeline(device)
    emit({"phase": "small_pipeline", "ok": True, **small,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    main_path, captured = run_main_path(device)
    emit({"phase": "main_path", "ok": True, **main_path,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    step_calls = check_step_kernels(captured)
    del captured
    emit({"phase": "step_kernels", "ok": True, **step_calls,
          "seconds": time.perf_counter() - t})

    emit(kernels_line(nms_calls, align_calls, step_calls, main_path))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
