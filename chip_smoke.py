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
                 applied to the plain version's taps.  K2's backward on
                 the train step's 1.0x and 1.5x pyramids at bbox geometry
                 (1024 rois), at mask geometry (260 rois), on 2000 rois of
                 the kinds K2 reads directly, on 500 rois on one spot and
                 on rows that add nothing (invalid, outside the volume),
                 grad_out in float32 and in bfloat16, two launches each
                 within 1e-4 of the largest gradient.  Median of CUDA-event
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
  7. small_train -- one train step of the narrow config on the card
                 (kernels, float32, TF32 off) and on the CPU (plain
                 versions) from the same weights, batch and draws: every
                 anchor target and R-CNN sample (labels, assignments,
                 counts) equal, losses within 2e-3, each parameter's
                 update within 2e-3 of the CPU update's largest magnitude
                 (2e-2 for the stem conv, under the stem max-pool).
  8. train    -- the flagship's train step at full width and bench.py's
                 training geometry: a 64x128x128 crop plus its 96x192x192
                 twin, batch 2, 16 gt boxes and masks per image (bench.py's
                 synthetic batch), the config's budgets, bf16 autocast over
                 float32 parameters; 1 warm-up and 3 timed steps, the
                 counters zeroed just before and read just after: K1 2, K2
                 5 and K2's backward 5 launches a step.  Then one profiled
                 step, and one step whose launches are recorded.
  9. train_step_kernels -- each launch of that recorded train step
                 against its plain version and timed alone: K1 and K2 as
                 in phase 6, K2's backward as in phase 3 (float atomics
                 add in an order that varies), its time that of the whole
                 backward of RoIAlign3DFunction (the launch and the cast
                 to the levels' dtype).
 10. small_tiled -- whole-volume tiled inference of the narrow config
                 (budgets 64, masks on) over a seeded 16x64x64 volume in
                 27 tiles, 8 detections kept per tile, on the card
                 (kernels) and on the CPU (plain versions) from the same
                 weights: per-class counts equal, rows within 2e-3,
                 pasted masks equal on every voxel whose probability lies
                 farther than 1e-2 from 0.25; the twin derived on the
                 card within 1e-5 of the CPU's in float32.
 11. wholevol -- the flagship at full width, bfloat16, every budget 2000,
                 masks on, over bench.py's whole volume: a host float32
                 240x512x512 volume, 512x512x64 tiles at 0.25 overlap (5
                 tiles), 256 detections kept per tile; 1 first and 3
                 timed calls with the counters zeroed just before and
                 read just after (K1 15, K2 20 launches a volume), each
                 phase's timer; one profiled sweep; the result scored by
                 CocoEval3D (bbox and segm) against a seeded gt.
 12. wholevol_tile_kernels -- the K1 and K2 launches of one tile of that
                 sweep, recorded with their arguments, against the plain
                 versions and timed alone, as in phase 6.
 13. learn    -- the pinned learning protocol (tools/learning_bench.py)
                 cut to 200 iterations: the port generates the pinned data
                 (its hash must be LEARNING.json's); the loader's first
                 batch on the card must equal its numpy sample bit for
                 bit; train_detector at full width from seed 2024 through
                 the Prefetcher with the config's workers, float32, the
                 counters zeroed just before and read just after (K1 2, K2
                 5, K2's backward 5 launches an iteration); the mean loss
                 of the last 20 iterations must be below the first 20's;
                 the last iteration's launches, recorded, each against its
                 plain version (as in phase 9); the trained detector's
                 gradients on the first batch through the kernels against
                 through the plain versions on the card, from the same
                 draws (samples equal, losses and each parameter's
                 gradient within 2e-3 of its largest); then the
                 double_test + segm evaluation of the checkpoint (counted
                 the same way): 29 finite stats each, and the launches of
                 its last volume pair (pass 2, a 576x576x108 twin) each
                 against its plain version.
 14. serve    -- apis.serve.watch with that checkpoint over an in-dir of
                 the 4 val volumes (counted): one json per volume, its rows
                 as run_inference's for that volume (same counts, 2e-3).
                 Both run the same detector, so this checks the loop's
                 file IO and host-side twin; the last served volume's
                 launches are each checked against the plain version.
Then the kernels line, the card line and, last, the result line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
not 0 and no result line is printed.

    python3 chip_smoke.py --only train|learn [--port DIR]

runs phases 1-2 and then only phases 8-9 (train) or 13-14 (learn and
serve), and prints no result line: the way to set two versions of the
port side by side on one card.  --port takes another checkout (an older
commit unpacked with git archive) whose mrcnn3d_torch these phases then
drive; run it from this one, in turns with --port left out.
"""
from __future__ import annotations

import argparse
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
# K2's backward against its plain version: relative to the largest
# gradient of the launch (the kernel and index_add_ sum in other orders);
# a bfloat16 gradient may also differ by one bf16 step of the plain value
BACKWARD_TOL = 1e-4
# bench.py's training geometry: the 1.0x crop (D, H, W), batch, max_gt
TRAIN_CROP = (64, 128, 128)
TRAIN_BATCH = 2
TRAIN_MAX_GT = 16


def emit(obj):
    print(json.dumps(obj), flush=True)


def require_card(port=REPO):
    """CUDA and a checkout whose mrcnn3d_torch the phases import: this
    one, or `port`."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    if not os.path.isdir(os.path.join(port, "mrcnn3d_torch", "csrc")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the repo")
    if sys.path[:1] != [port]:
        sys.path.insert(0, port)


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
    "roi_align3d_backward": ("roi_align3d_backward_kernel",
                             "roi_align3d_backward_contract_kernel"),
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


def small_train_config():
    """The narrow config with the training budgets cut to its size:
    proposals 64 per level and image, the RPN sampler 64 anchors and the
    R-CNN sampler 32 rois (a quarter positive) per image."""
    cfg = small_config()
    tc = cfg.train_cfg
    for k in ("nms_pre", "nms_post", "max_num"):
        tc["rpn_proposal"][k] = SMALL_BUDGET
    tc["rpn"]["sampler"]["num"] = 64
    tc["rcnn"]["sampler"]["num"] = 32
    return cfg


def small_train_batch(seed, batch_size=2, max_gt=4):
    """numpy training batch of the small shapes (NCDHW volumes): gt
    boxes inside the volume (the 1.5x twin's scaled by 1.5), the last gt
    of each image invalid, labels 1, gt masks that fill each box's
    central part."""
    import numpy as np

    rng = np.random.RandomState(seed)
    (d, h, w), shape2 = SMALL_SHAPES
    b, g = batch_size, max_gt
    xy = rng.uniform(0, 18, (b, g, 2))
    size = rng.uniform(6, 13, (b, g, 2))
    z = rng.uniform(0, 4, (b, g, 1))
    dz = rng.uniform(2, 3.5, (b, g, 1))
    boxes = np.concatenate([xy, xy + size, z, z + dz], -1).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[:, -1] = False
    masks = np.zeros((b, g, d, h, w), np.uint8)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2, z1, z2 = np.round(boxes[i, j]).astype(int)
            masks[i, j, z1:z2, y1 + 1:y2, x1 + 1:x2] = 1
    labels = np.ones((b, g), np.int32)
    return {
        "imgs": rng.randn(b, 3, d, h, w).astype(np.float32),
        "imgs_2": rng.randn(b, 3, *shape2).astype(np.float32),
        "gt_boxes": boxes, "gt_boxes_2": boxes * np.float32(1.5),
        "gt_labels": labels, "gt_labels_2": labels,
        "gt_valid": valid, "gt_valid_2": valid, "gt_masks": masks,
    }


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
    """Within the block, records the arguments of every launch of the
    named kernels (calling them as usual), by wrapping their wrappers:
    K1 and K2 by default, K2's backward too when it is named.  keep:
    {kernel: n} keeps only each kernel's last n launches (those of the
    path's last step or volume)."""

    def __init__(self, kernels=("nms3d", "roi_align3d"), keep=None):
        self.kernels = kernels
        self.keep = keep

    def __enter__(self):
        import collections

        from mrcnn3d_torch.ops import nms3d, roi_align3d

        wrappers = {
            "nms3d": (nms3d, "greedy_scan_cuda"),
            "roi_align3d": (roi_align3d, "roi_align_3d_cuda"),
            "roi_align3d_backward": (roi_align3d,
                                     "roi_align_3d_backward_cuda"),
        }
        self.calls = {k: collections.deque(maxlen=(self.keep or {}).get(k))
                      for k in self.kernels}
        self._saved = [(*wrappers[k], getattr(*wrappers[k]))
                       for k in self.kernels]
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
        self.calls = {k: list(v) for k, v in self.calls.items()}
        return False


# names of one step's launches, in the order simple_test makes them
STEP_CALLS = {
    "nms3d": ["proposals_1.0x", "proposals_1.5x", "classwise"],
    "roi_align3d": ["bbox_1.0x", "bbox_1.5x", "refinement_1.0x",
                    "mask_1.0x"],
}
# those of a boxes-only simple_test (an evaluation pass-2 volume, a
# served volume under the flagship's test_cfg)
BOX_STEP_CALLS = {"nms3d": STEP_CALLS["nms3d"],
                  "roi_align3d": STEP_CALLS["roi_align3d"][:3]}


def volume_calls(test_cfg):
    """The names of one simple_test's launches under `test_cfg`."""
    return BOX_STEP_CALLS if test_cfg.get("return_bbox_only") else STEP_CALLS


def keep_last(names):
    """Capture's `keep` for the launches of the last of these calls."""
    return {k: len(v) for k, v in names.items()}


def check_launches(captured, names, what):
    """Each recorded K1 and K2 launch, on the arguments the path gave
    it, against the plain version and timed alone; `names` names them
    in launch order."""
    got = {k: len(v) for k, v in captured.calls.items()}
    want = {k: len(v) for k, v in names.items()}
    if got != want:
        raise AssertionError(f"launches in the captured {what}: {got}, "
                             f"expected {want}")
    return {
        "nms3d": [nms_case(name, *args) for name, args in
                  zip(names["nms3d"], captured.calls["nms3d"])],
        "roi_align3d": [align_case(name, args) for name, args in
                        zip(names["roi_align3d"],
                            captured.calls["roi_align3d"])],
    }


def check_step_kernels(captured):
    """Each launch of one main-path step, on the arguments it was given
    there, against the plain version, and timed alone."""
    out = check_launches(captured, STEP_CALLS, "step")
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
    out["roi_align3d_direct"] = align_case("mask_1.0x_direct", direct_args)
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


# ---------------------------------------------------------------------------
# phase 7: one small train step, card against CPU
# ---------------------------------------------------------------------------


class SampleRecorder:
    """Within the block, records every anchor target and R-CNN sample
    that forward_train makes (on the CPU), by wrapping the two functions
    in the pipeline's namespace, and the count behind every draw."""

    def __enter__(self):
        from mrcnn3d_torch.detectors import pipeline

        self.made = {"anchor_target_single": [], "sample_rcnn_single": []}
        self._saved = [(name, getattr(pipeline, name)) for name in self.made]
        for name, fn in self._saved:
            setattr(pipeline, name, self._recorder(fn, self.made[name]))
        return self

    @staticmethod
    def _recorder(fn, made):
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            items = out.items() if isinstance(out, dict) \
                else out._asdict().items()
            made.append({k: v.detach().cpu() for k, v in items})
            return out

        return record

    def __exit__(self, *exc):
        from mrcnn3d_torch.detectors import pipeline

        for name, fn in self._saved:
            setattr(pipeline, name, fn)
        return False


class CountedDraws:
    """The samplers' draws from a CPU torch.Generator (so the card and
    the CPU draw the same integers), recording (site, n, high)."""

    def __init__(self, seed):
        import torch

        from mrcnn3d_torch.core.targets import TorchDraws

        self.draws = TorchDraws(torch.Generator().manual_seed(seed))
        self.highs = []

    def __call__(self, site, n, high):
        self.highs.append((site, n, int(high)))
        return self.draws(site, n, high)


def small_train_step(device):
    """One train step of the narrow config on `device` from seed 0's
    weights and CountedDraws(7): (losses, {name: (update, parameter
    after the step)}, the recorded samples, the draws' counts, the stem's
    tensors), all on the CPU.  The update is the step's learning rate
    times SGD's momentum buffer, as the optimizer applies it (the
    parameter's own rounding would hide it at a step this small).  The
    stem's tensors, per input shape: the max-pool's input and the
    gradient that reaches the stem conv's output."""
    import torch

    from mrcnn3d_torch.entry import build_trainer

    trainer = build_trainer(small_train_config(), device=device, seed=0)
    trainer.draws = CountedDraws(7)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in small_train_batch(3).items()}
    backbone = trainer.model.backbone
    stem = {"pool_in": {}, "conv_grad": {}}

    def on_conv(mod, inp, out):
        key = tuple(out.shape)
        out.register_hook(lambda g: stem["conv_grad"].__setitem__(
            key, g.detach().cpu()))

    def on_pool(mod, inp, out):
        stem["pool_in"][tuple(inp[0].shape)] = inp[0].detach().cpu()

    hooks = [backbone.conv1.register_forward_hook(on_conv),
             backbone.maxpool.register_forward_hook(on_pool)]
    with SampleRecorder() as rec:
        losses = trainer.step(batch)
    for h in hooks:
        h.remove()
    opt = trainer.state.optimizer
    lr = opt.param_groups[0]["lr"]
    updates = {n: ((lr * opt.state[p]["momentum_buffer"]).cpu(),
                   p.detach().cpu())
               for n, p in trainer.model.named_parameters()}
    return ({k: float(v) for k, v in losses.items()}, updates, rec.made,
            trainer.draws.highs, stem)


def stem_divergence(gpu_stem, cpu_stem):
    """Per stem input shape, where the card's and the CPU's stems part:
    the largest difference of the max-pool's input (convolution
    rounding), the windows whose argmax differs between the two inputs
    (both pooled on the CPU, so the pool's own rule is the same), and the
    largest difference of the gradient at the stem conv's output against
    its largest value."""
    import torch.nn.functional as F

    out = {}
    for shape, x_cpu in cpu_stem["pool_in"].items():
        x_gpu = gpu_stem["pool_in"][shape]
        _, i_cpu = F.max_pool3d(x_cpu, 3, 2, 1, return_indices=True)
        _, i_gpu = F.max_pool3d(x_gpu, 3, 2, 1, return_indices=True)
        g_cpu = cpu_stem["conv_grad"][shape]
        g_gpu = gpu_stem["conv_grad"][shape]
        out["x".join(map(str, shape[2:]))] = dict(
            pool_in_max_diff=float((x_gpu - x_cpu).abs().max()),
            argmax_flips=int((i_gpu != i_cpu).sum()), windows=i_cpu.numel(),
            conv_grad_max_diff=float((g_gpu - g_cpu).abs().max()),
            conv_grad_max=float(g_cpu.abs().max()),
        )
    return out


# float entries of the recorded targets and samples: from boxes decoded
# (proposals) or encoded (deltas) in float32 on either device
SAMPLE_FLOATS = ("bbox_targets", "rois")
# parameter updates, card against CPU: within UPDATE_TOL of the CPU
# update's largest magnitude.  The stem conv's weights sit under the stem
# max-pool, whose argmax between two values equal to float32 rounding
# follows each device's convolution rounding: a flipped window routes its
# gradient to the neighbouring voxel, which moves the stem conv's weight
# gradient by about 1% of its largest (1.0% on the narrow config).  The
# phase reports the flips and the gradient they move (`stem_divergence`)
UPDATE_TOL = {"backbone.conv1.weight": 2e-2}


def compare_samples(got, want, what):
    """Two runs of forward_train, each (losses, _, recorded samples, the
    draws' counts): every draw's count, anchor target and R-CNN sample
    equal (float boxes and deltas within PIPELINE_ATOL), the losses
    within PIPELINE_ATOL.  Returns the largest float sample and loss
    errors."""
    if got[3] != want[3]:
        raise AssertionError(f"{what}: the draws' counts differ")
    made_err = 0.0
    for kind, items in want[2].items():
        if len(items) != len(got[2][kind]):
            raise AssertionError(f"{what}: {kind} calls differ")
        for w_item, g_item in zip(items, got[2][kind]):
            for key, w in w_item.items():
                g = g_item[key]
                if key in SAMPLE_FLOATS:
                    e = float((g - w).abs().max()) if w.numel() else 0.0
                    if not e <= PIPELINE_ATOL:
                        raise AssertionError(
                            f"{what}: {kind} {key} differ by {e}")
                    made_err = max(made_err, e)
                elif not bool((g == w).all()):
                    raise AssertionError(f"{what}: {kind} {key} differ")
    loss_err = max(abs(got[0][k] - v) for k, v in want[0].items())
    if set(got[0]) != set(want[0]) or not loss_err <= PIPELINE_ATOL:
        raise AssertionError(f"{what}: losses differ by {loss_err}")
    return made_err, loss_err


def check_small_train(device):
    """The narrow train step on the card against the CPU: every draw's
    count, anchor target and R-CNN sample equal (float boxes and deltas
    within PIPELINE_ATOL), the losses within PIPELINE_ATOL, each
    parameter's update within PIPELINE_ATOL of the CPU update's largest
    magnitude (UPDATE_TOL for the stem conv), and each parameter after
    the step within that and its own float32 spacing."""
    import math

    import torch

    gpu = small_train_step(device)
    cpu = small_train_step("cpu")
    made_err, loss_err = compare_samples(gpu, cpu, "small train")
    update_err = {}
    for name, (want, p_cpu) in cpu[1].items():
        got, p_gpu = gpu[1][name]
        scale = float(want.abs().max())
        tol = UPDATE_TOL.get(name, PIPELINE_ATOL) * scale
        e = float((got - want).abs().max())
        if not e <= tol:
            raise AssertionError(f"small train: {name} update differs by "
                                 f"{e}, largest {scale}")
        # the parameters after the step: the same, plus the float32
        # spacing of each parameter (its rounding after the update)
        spacing = (torch.nextafter(p_cpu, torch.full_like(p_cpu, math.inf))
                   - p_cpu)
        if not bool(((p_gpu - p_cpu).abs() <= tol + spacing).all()):
            raise AssertionError(f"small train: {name} after the step "
                                 f"differs beyond its update's tolerance")
        update_err[name] = e / scale if scale else 0.0
    worst = sorted(update_err, key=update_err.get)[-3:]
    return dict(
        losses=gpu[0], max_loss_err=loss_err, draws=len(cpu[3]),
        positives=[h for site, _, h in cpu[3] if site[-1] == "pos"],
        samples={k: len(v) for k, v in cpu[2].items()},
        max_sample_float_err=made_err,
        worst_update_rel_err={k: update_err[k] for k in worst},
        stem=stem_divergence(gpu[4], cpu[4]),
        tol=PIPELINE_ATOL, update_tol=UPDATE_TOL,
    )


# ---------------------------------------------------------------------------
# phase 8: the full-width train step
# ---------------------------------------------------------------------------


def train_batch(gen, device):
    """bench.py's synthetic training batch (make_batch), NCDHW: per scale
    f = 1.0, 1.5, random bf16 volumes of the crop times f; TRAIN_MAX_GT
    valid gt boxes per image with x1 = y1 ~ U(4, 0.6 H), extent ~ U(8,
    0.3 H), z from 2 to 14; labels 1; gt masks all ones at 1.0x.  The
    1.5x boxes are the 1.0x boxes times 1.5, so both scales hold the same
    objects.  That departs from bench.py on purpose: bench.py maps the
    shared draws onto the 1.5x crop's own H before scaling by 1.5, so
    its 1.5x boxes are not its 1.0x boxes scaled."""
    import torch

    d, h, w = TRAIN_CROP
    b, g = TRAIN_BATCH, TRAIN_MAX_GT
    x1 = 4 + torch.rand((b, g, 1), generator=gen, device=device) \
        * (h * 0.6 - 4)
    size = 8 + torch.rand((b, g, 1), generator=gen, device=device) \
        * (h * 0.3 - 8)
    batch = {}
    for s in range(2):
        f = 1.5 ** s
        sfx = "" if s == 0 else "_2"
        batch["imgs" + sfx] = torch.randn(
            (b, 3, int(d * f), int(h * f), int(w * f)), generator=gen,
            device=device).to(torch.bfloat16)
        lo, hi = x1 * f, (x1 + size) * f
        batch["gt_boxes" + sfx] = torch.cat(
            [lo, lo, hi, hi, torch.full_like(lo, 2.0 * f),
             torch.full_like(lo, 14.0 * f)], -1)
        batch["gt_valid" + sfx] = torch.ones((b, g), dtype=torch.bool,
                                             device=device)
        batch["gt_labels" + sfx] = torch.ones((b, g), dtype=torch.int32,
                                              device=device)
    batch["gt_masks"] = torch.ones((b, g, d, h, w), dtype=torch.uint8,
                                   device=device)
    return batch


TRAIN_PER_STEP = {"nms3d": 2, "roi_align3d": 5, "roi_align3d_backward": 5}


def run_train_path(device, steps=3):
    """The flagship's train step at full width: 1 warm-up and `steps`
    timed steps with the launch counters zeroed just before and read just
    after; then one profiled step and one recorded step."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build_trainer
    from mrcnn3d_torch.ops import nms3d, roi_align3d

    torch.backends.cudnn.benchmark = True
    trainer = build_trainer(CONFIG, device=device, seed=0,
                            compute_dtype=torch.bfloat16)
    batch = train_batch(torch.Generator(device=device).manual_seed(17),
                        device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms3d.launches = 0
    roi_align3d.launches = 0
    roi_align3d.backward_launches = 0
    walls, stages, losses = [], [], []
    for step in range(1 + steps):
        timer = StageTimer()
        t0 = time.perf_counter()
        out = trainer.step(batch, mark=timer)
        torch.cuda.synchronize()
        if step:
            walls.append(time.perf_counter() - t0)
            stages.append(timer.stages_ms())
        losses.append(out)
    launches = {"nms3d": nms3d.launches, "roi_align3d": roi_align3d.launches,
                "roi_align3d_backward": roi_align3d.backward_launches}
    n_steps = 1 + steps
    for name, count in TRAIN_PER_STEP.items():
        if launches[name] != count * n_steps:
            raise AssertionError(
                f"train: {name} {launches[name]} launches in {n_steps} "
                f"steps, expected {count} per step")
    losses = [{k: float(v) for k, v in out.items()} for out in losses]
    bad = [(i, k) for i, out in enumerate(losses) for k, v in out.items()
           if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"train: non-finite losses {bad}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    names = stages[0].keys()
    stage_ms = {k: float(np.median([s[k] for s in stages])) for k in names}
    median = float(np.median(walls))
    profile = profile_step(lambda: trainer.step(batch))
    if profile:
        # the profiler's own host cost stretches the kernel span of a
        # step of ~9000 launches; the busy time against the timed step
        # says how far the host holds the card back
        profile["busy_share_of_median_step"] = \
            profile["busy_ms"] / (median * 1e3)
    with Capture(tuple(TRAIN_PER_STEP)) as captured:
        trainer.step(batch)
    torch.cuda.synchronize()
    return dict(
        steps=steps, batch=TRAIN_BATCH, crop=list(TRAIN_CROP),
        step_s=walls, median_step_s=median,
        volumes_per_s=TRAIN_BATCH / median, stage_ms=stage_ms,
        losses_first=losses[0], losses_last=losses[-1],
        max_memory_allocated_gib=peak, launches=launches,
        launches_per_step=TRAIN_PER_STEP, profile=profile,
    ), captured


# ---------------------------------------------------------------------------
# phase 9: the train step's kernel launches, each alone
# ---------------------------------------------------------------------------


# names of one train step's forward launches, in the order forward_train
# makes them
TRAIN_STEP_CALLS = {
    "nms3d": ["proposals_1.0x", "proposals_1.5x"],
    "roi_align3d": ["bbox_1.0x", "bbox_1.5x", "refinement_1.0x",
                    "mask_1.0x", "mask_refinement_1.0x"],
}


def _fold_counts(lo, hi, wl, wh, inr, pooled, sn):
    """Per roi and output bin along one axis, the distinct voxels its sn
    in-range taps add to with a nonzero weight: (N, pooled)."""
    import torch

    n = lo.shape[0]
    vox = torch.stack([lo, hi], -1)
    keep = (torch.stack([wl, wh], -1) != 0) & inr[..., None]
    vox = torch.where(keep, vox, -1).reshape(n, pooled, 2 * sn)
    vox = vox.sort(-1).values
    return ((vox[..., 1:] != vox[..., :-1]) & (vox[..., 1:] >= 0)).sum(-1) \
        + (vox[..., 0] >= 0)


def backward_case(name, args):
    """K2's backward against its plain version on one launch's arguments
    (those of `roi_align_3d_backward_cuda`), launched twice: each time
    every gradient within BACKWARD_TOL of the largest plain gradient or,
    where the launch returns bfloat16, one bf16 step of the plain value.
    Median event times of the whole backward as RoIAlign3DFunction runs
    it (the launch, then each gradient cast to the levels' dtype, which is
    grad_out's) and of the plain version; the kernel's device time per
    launch (not the memset of the float32 buffer before it).  The bound of
    this work: the touched voxels of the gradient written once in the
    levels' dtype, the valid rois' rows of grad_out and their rois and
    levels read once, every roi's flag read once; a multiply and an add
    per (bin, voxel) pair of the folded samples.  dense_bytes: every voxel
    of every level's gradient written once in its dtype;
    adds_per_window_value: the 5th, 50th and 95th percentile over the
    valid rois of the adds a scatter from the bins makes per value of the
    roi's window (what the contraction saves)."""
    import math

    import torch

    from mrcnn3d_torch.ops import roi_align3d as ra

    grad_out, shapes, rois, levels, valid, out, out_d, strides, strides_d, \
        sn = args
    dtype = grad_out.dtype
    want = ra.roi_align_3d_backward_plain(*args)
    scale = max(float(w.abs().max()) for w in want)
    err = 0.0
    for _ in range(2):
        got = ra.roi_align_3d_backward_cuda(*args)
        torch.cuda.synchronize()
        if [tuple(g.shape) for g in got] != [tuple(s) for s in shapes]:
            raise AssertionError(f"K2 backward {name}: gradient shapes")
        bad = 0
        for g, w in zip(got, want):
            diff = (g.float() - w).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            ok = diff <= BACKWARD_TOL * scale
            if g.dtype == torch.bfloat16:
                _, e = torch.frexp(w)
                ok |= diff <= torch.ldexp(torch.ones_like(diff), e - 8)
            bad += int((~ok).sum())
        if bad:
            raise AssertionError(f"K2 backward {name} {dtype}: {bad} values "
                                 f"differ by more than {BACKWARD_TOL} of the "
                                 f"largest gradient {scale}; max error "
                                 f"{err}")
        del got
    del want
    ms = time_ms(lambda: [g.to(dtype) for g in
                          ra.roi_align_3d_backward_cuda(*args)])
    dev_ms = device_ms(lambda: ra.roi_align_3d_backward_cuda(*args),
                       KERNEL_CUDA_NAMES["roi_align3d_backward"])
    plain_ms = time_ms(lambda: ra.roi_align_3d_backward_plain(*args),
                       iters=2, warmup=0)
    c = shapes[0][-1]
    elt = grad_out.element_size()
    empty = [torch.empty(s, dtype=dtype, device="meta") for s in shapes]
    sel = valid.bool().cpu()
    r, lv = rois.cpu()[sel].float(), levels.cpu()[sel]
    taps = axis_taps(r, lv, empty, out, out_d, strides, strides_d, sn)
    fx, fy, fz = (_fold_counts(*t, pooled, sn).sum(1)
                  for t, pooled in zip(taps, (out, out, out_d)))
    adds = int((fx * fy * fz).sum()) * c
    # the adds a scatter makes per value of each roi's window
    window = math.prod(_span(t[0], t[1], t[4])[1] for t in taps)
    per_value = (fx * fy * fz)[window > 0] / window[window > 0]
    geo = align_geometry(empty, rois, levels, valid, out, out_d, strides,
                         strides_d, sn)
    n_valid = int(sel.sum())
    nbytes = (geo["touched_bytes"] + n_valid * grad_out[0].numel() * elt
              + n_valid * (7 * 4 + 4) + rois.shape[0])
    b_ms, b_by = bound(nbytes, 2 * adds)
    return dict(
        name=name, grad_out_dtype=str(dtype).split(".")[-1],
        rois=rois.shape[0], valid=n_valid, adds=adds,
        adds_per_window_value=per_value.quantile(
            torch.tensor([0.05, 0.5, 0.95])).tolist()
        if per_value.numel() else None,
        touched_bytes=geo["touched_bytes"], max_abs_grad=scale,
        ms=ms, device_ms=dev_ms and sum_or_none(dev_ms.values()),
        device_ms_by_kernel=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, ops=2 * adds,
        dense_bytes=sum(math.prod(s) for s in shapes) * elt,
        max_abs_err=err, tol=BACKWARD_TOL * scale,
    )


def train_level_shapes(model, scale):
    """The (B, D, H, W, C) levels of the train step's pyramid at a scale
    (1.0 or 1.5) of bench.py's training crop."""
    c = model.neck.fpn_convs[0].conv.out_channels
    crop = tuple(int(v * scale) for v in TRAIN_CROP)
    return [(TRAIN_BATCH, *s, c) for s in model.featmap_sizes(crop)[:4]]


def check_backward(gen, det, device):
    """K2's backward on synthetic rois, each case with grad_out in float32
    and in bfloat16: bbox geometry on the train step's
    1.0x and 1.5x pyramids (1024 proposal-like rois over its 2 images);
    mask geometry (260 rois); 2000 rois of the kinds K2's forward reads
    directly, on the 1.0x main-path pyramid; 500 rois on one spot (their
    windows add to the same voxels); and rows that add nothing (half
    invalid, some wholly outside the volume)."""
    import torch

    from mrcnn3d_torch.ops import roi_align3d as ra

    bcfg = align_cfg(det.cfg, "bbox")
    mcfg = align_cfg(det.cfg, "mask")
    c = det.model.neck.fpn_convs[0].conv.out_channels
    main = [(1, *s, c) for s in det.model.featmap_sizes(MAIN_SHAPES[0])[:4]]

    def proposals(k, scale):
        crop = tuple(int(v * scale) for v in TRAIN_CROP)
        boxes, _, valid = proposal_boxes(gen, k, crop, device)
        b = torch.randint(0, TRAIN_BATCH, (k, 1), generator=gen,
                          device=device).float()
        return torch.cat([b, boxes], 1), valid

    def one_spot(k):
        d, h, w = TRAIN_CROP
        rois = torch.tensor([[1.0, 0.3 * w, 0.4 * h, 0.5 * w, 0.58 * h,
                              0.3 * d, 0.4 * d]], device=device).repeat(k, 1)
        rois[:, 1:] += torch.rand((k, 6), generator=gen, device=device) * 4
        return rois, torch.ones(k, dtype=torch.bool, device=device)

    def nothing(k):
        rois, valid = proposals(k, 1.0)
        valid &= torch.rand((k,), generator=gen, device=device) > 0.5
        rois[: k // 8, 1:5] += TRAIN_CROP[2] * 2.0
        return rois, valid

    cases = [
        ("bbox_1.0x", train_level_shapes(det.model, 1.0), bcfg,
         proposals(1024, 1.0)),
        ("bbox_1.5x", train_level_shapes(det.model, 1.5), bcfg,
         proposals(1024, 1.5)),
        ("mask_1.0x", train_level_shapes(det.model, 1.0), mcfg,
         proposals(260, 1.0)),
        ("mask_1.0x_direct_kinds", main, mcfg,
         (direct_rois(gen, MAIN_BUDGET, MAIN_SHAPES[0], device),
          torch.ones(MAIN_BUDGET, dtype=torch.bool, device=device))),
        ("mask_1.0x_one_spot", train_level_shapes(det.model, 1.0), mcfg,
         one_spot(500)),
        ("bbox_1.0x_invalid_rows", train_level_shapes(det.model, 1.0), bcfg,
         nothing(1024)),
    ]
    calls = []
    for name, shapes, (out, out_d, strides, strides_d, sn), (rois, valid) \
            in cases:
        levels = ra.map_roi_levels(rois, len(shapes))
        for dtype in (torch.float32, torch.bfloat16):
            grad = torch.randn((rois.shape[0], c, out_d, out, out),
                               generator=gen, device=device).to(dtype)
            calls.append(backward_case(name, (
                grad, shapes, rois, levels, valid, out, out_d, strides,
                strides_d, sn)))
    return calls


def check_train_step_kernels(captured):
    """Each launch of one train step, on the arguments it was given
    there, against its plain version and timed alone.  Each backward
    launch takes the name of the forward launch whose rois it got."""
    got = {k: len(v) for k, v in captured.calls.items()}
    want = {**{k: len(v) for k, v in TRAIN_STEP_CALLS.items()},
            "roi_align3d_backward": len(TRAIN_STEP_CALLS["roi_align3d"])}
    if got != want:
        raise AssertionError(f"launches in the captured train step: {got}, "
                             f"expected {want}")
    by_rois = {args[1].data_ptr(): name for name, args in
               zip(TRAIN_STEP_CALLS["roi_align3d"],
                   captured.calls["roi_align3d"])}
    back = [(by_rois[args[2].data_ptr()], args)
            for args in captured.calls["roi_align3d_backward"]]
    if sorted(n for n, _ in back) != sorted(TRAIN_STEP_CALLS["roi_align3d"]):
        raise AssertionError("K2 backward launches do not match the "
                             "forward launches one to one")
    import torch

    # the recorded levels are activations that require a gradient
    with torch.no_grad():
        return {
            "nms3d": [nms_case(name, *args) for name, args in
                      zip(TRAIN_STEP_CALLS["nms3d"],
                          captured.calls["nms3d"])],
            "roi_align3d": [align_case(name, args) for name, args in
                            zip(TRAIN_STEP_CALLS["roi_align3d"],
                                captured.calls["roi_align3d"])],
            "roi_align3d_backward": [backward_case(name, args)
                                     for name, args in back],
        }


# ---------------------------------------------------------------------------
# phase 10: small tiled inference, card against CPU
# ---------------------------------------------------------------------------


# the small sweep: a 16x64x64 volume in 27 tiles of 8x32x32 (+ 12x48x48)
SMALL_TILED_SHAPE = (16, 64, 64)
SMALL_TILED = dict(patch_d=8, patch_hw=32, overlap=0.5, max_dets_per_tile=8)
# pasted masks must agree on every voxel whose probability (the reference
# side's, resized to the box) lies farther than this from the threshold
MASK_PROB_BAND = 1e-2
TWIN_TOL = 1e-5


def small_tiled_volume(seed=5, scale=1.0):
    """The small sweep's normalised (D, H, W, 3) float32 volume."""
    import numpy as np

    vol = np.random.RandomState(seed).randn(*SMALL_TILED_SHAPE, 3)
    return (vol * scale).astype(np.float32)


class MaskProbs:
    """Within the block, records the resized probabilities behind every
    mask a tiled driver realises, keyed by the id of the mask it returns,
    by wrapping `box_mask_from_probs` in `module`'s namespace (the port's
    `apis.tiled` by default)."""

    def __init__(self, module=None):
        self.module = module

    def __enter__(self):
        from mrcnn3d_torch.eval.masks import _trilinear_resize, box_extent

        if self.module is None:
            from mrcnn3d_torch.apis import tiled as module
            self.module = module
        self.probs = {}
        self._fn = fn = self.module.box_mask_from_probs

        def record(probs, box, thr=0.25):
            mask = fn(probs, box, thr)
            self.probs[id(mask)] = _trilinear_resize(probs, box_extent(box))
            return mask

        self.module.box_mask_from_probs = record
        return self

    def __exit__(self, *exc):
        self.module.box_mask_from_probs = self._fn
        return False


def _paste(box, values, shape):
    """`eval.masks.paste_mask_3d` of float values (the probabilities)."""
    import numpy as np

    out = np.zeros(shape, values.dtype)
    x0, y0, z0 = (max(int(box[i]), 0) for i in (0, 1, 4))
    d, h, w = values.shape
    z1, y1, x1 = (min(a + n, m) for a, n, m in
                  zip((z0, y0, x0), (d, h, w), shape))
    if z1 > z0 and y1 > y0 and x1 > x0:
        out[z0:z1, y0:y1, x0:x1] = values[:z1 - z0, :y1 - y0, :x1 - x0]
    return out


def compare_tiled(a, b, probs_b, atol, what, thr=0.25):
    """Two tiled results (per_class, segms): per-class counts equal; each
    row (box and score) of `a` within atol of its own row of `b`, one to
    one (the merged order of two scores equal to float noise is noise
    too); pasted masks of each pair equal on every voxel whose probability
    in `b` (probs_b: MaskProbs.probs of b's run) lies farther than
    MASK_PROB_BAND from thr.  Returns (largest row difference, voxels
    within the band, voxels that differ)."""
    import numpy as np

    from mrcnn3d_torch.eval.masks import paste_mask_3d

    err, band, differ = 0.0, 0, 0
    for c, (ra, rb) in enumerate(zip(a[0], b[0])):
        if ra.shape != rb.shape:
            raise AssertionError(f"{what}: class {c + 1} has {len(ra)} "
                                 f"detections against {len(rb)}")
        if not len(ra):
            continue
        dist = np.abs(ra[:, None] - rb[None]).max(-1)
        pair = dist.argmin(1)
        e = float(dist[np.arange(len(ra)), pair].max())
        if not e <= atol or len(set(pair.tolist())) != len(ra):
            raise AssertionError(f"{what}: class {c + 1} rows differ by {e}")
        err = max(err, e)
        for sa, sb in zip(a[1][c], (b[1][c][j] for j in pair)):
            shape = tuple(sb["shape"])
            if tuple(sa["shape"]) != shape:
                raise AssertionError(f"{what}: mask frames differ")
            pb = _paste(sb["box"], probs_b[id(sb["mask"])], shape)
            near = np.abs(pb - thr) <= MASK_PROB_BAND
            diff = (paste_mask_3d(sa["box"], sa["mask"], shape)
                    != paste_mask_3d(sb["box"], sb["mask"], shape))
            if (diff & ~near).any():
                raise AssertionError(
                    f"{what}: {int((diff & ~near).sum())} mask voxels "
                    f"differ outside the band")
            band += int(near.sum())
            differ += int(diff.sum())
    return err, band, differ


def small_tiled_run(det, scale=1.0):
    """The small sweep with `det`: (result, MaskProbs.probs)."""
    with MaskProbs() as rec:
        out = det.tiled(dict(imgs=small_tiled_volume(scale=scale)),
                        **SMALL_TILED)
    return out, rec.probs


def check_small_tiled(device):
    """The small sweep on the card (kernels) against the CPU (plain
    versions), from the same weights; and the twin the card derives
    against the CPU's, in float32."""
    import torch

    from mrcnn3d_torch.apis.tiled import plan_sweep
    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.ops.resize3d import resize_trilinear_3d

    cfg = small_config()
    gpu = build(cfg, device=device, budgets=SMALL_BUDGET)
    cpu = build(cfg, device="cpu", budgets=SMALL_BUDGET)
    a, _ = small_tiled_run(gpu)
    b, probs = small_tiled_run(cpu)
    err, band, differ = compare_tiled(a, b, probs, PIPELINE_ATOL,
                                      "small tiled")
    n = sum(len(r) for r in b[0])
    if n < 4:
        raise AssertionError(f"small tiled: {n} detections, vacuous")
    vol = torch.from_numpy(small_tiled_volume()).permute(3, 0, 1, 2)[None]
    twin = plan_sweep(SMALL_TILED_SHAPE, SMALL_TILED["patch_hw"],
                      SMALL_TILED["patch_d"], SMALL_TILED["overlap"],
                      cfg.get("upscale_factor", 1.5)).twin_shape
    twin_err = float((resize_trilinear_3d(vol.to(device), twin).cpu()
                      - resize_trilinear_3d(vol, twin)).abs().max())
    if not twin_err <= TWIN_TOL:
        raise AssertionError(f"small tiled: twins differ by {twin_err}")
    return dict(detections=n, per_class=[len(r) for r in b[0]],
                max_abs_err=err, mask_voxels_in_band=band,
                mask_voxels_differ=differ, band=MASK_PROB_BAND,
                twin_max_abs_err=twin_err, tol=PIPELINE_ATOL,
                twin_tol=TWIN_TOL, **SMALL_TILED)


# ---------------------------------------------------------------------------
# phase 11: a whole volume at full width, and its 3-D COCO scores
# ---------------------------------------------------------------------------


# bench.py's whole-volume geometry (bench.py:461-484): a 240x512x512 host
# float32 volume, 512x512x64 tiles at 0.25 overlap (5 tiles)
WHOLEVOL_SHAPE = (240, 512, 512)
WHOLEVOL = dict(patch_hw=512, patch_d=64, overlap=0.25, max_dets_per_tile=256)
WHOLEVOL_TILES = 5
SEGM_EVAL_BUDGET_S = 30.0
SEGM_EVAL_TOP = 100


def wholevol_gt(seed=17, n=6):
    """A seeded gt of n lesions in the whole volume: COCO-3D dict with
    xywhzd boxes and full-frame uint8 masks (an ellipsoid in each box)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d, h, w = WHOLEVOL_SHAPE
    anns = []
    for i in range(n):
        ext = np.array([rng.randint(4, 13), rng.randint(4, 13),
                        rng.randint(2, 7)])              # x, y, z extents
        lo = np.array([rng.randint(0, w - 13), rng.randint(0, h - 13),
                       rng.randint(0, d - 7)])
        mask = np.zeros(WHOLEVOL_SHAPE, np.uint8)
        zz, yy, xx = np.ogrid[:ext[2], :ext[1], :ext[0]]
        c = (ext - 1) / 2.0
        inside = (((xx - c[0]) / (c[0] + .5)) ** 2
                  + ((yy - c[1]) / (c[1] + .5)) ** 2
                  + ((zz - c[2]) / (c[2] + .5)) ** 2) <= 1.0
        mask[lo[2]:lo[2] + ext[2], lo[1]:lo[1] + ext[1],
             lo[0]:lo[0] + ext[0]] = inside
        anns.append(dict(id=i + 1, image_id=0, category_id=1,
                         bbox=[float(lo[0]), float(lo[1]), float(ext[0]),
                               float(ext[1]), float(lo[2]), float(ext[2])],
                         segmentation=mask))
    return dict(images=[dict(id=0)], annotations=anns,
                categories=[dict(id=1)])


def score_wholevol(result, gt):
    """CocoEval3D, bbox and segm, of a whole-volume result against gt.
    The segm evaluation pastes every detection into the full frame; when
    the time it would take, extrapolated from pasting the first few, is
    over SEGM_EVAL_BUDGET_S, it scores the SEGM_EVAL_TOP best merged
    detections and says so."""
    import numpy as np

    from mrcnn3d_torch.eval.coco_eval3d import CocoEval3D
    from mrcnn3d_torch.eval.masks import paste_mask_3d
    from mrcnn3d_torch.ops.box3d import xyxyzz_to_xywhzd

    per_class, segms = result
    entries = [
        dict(image_id=0, category_id=c + 1,
             bbox=[float(v) for v in xyxyzz_to_xywhzd(det[:6])],
             score=float(det[6]), segmentation=seg)
        for c in range(len(per_class))
        for det, seg in zip(per_class[c], segms[c])
    ]
    out = {"detections": len(entries)}
    t = time.perf_counter()
    out["bbox"] = CocoEval3D(gt, entries, "bbox").named_stats("bbox")
    out["bbox_eval_s"] = time.perf_counter() - t
    probe = entries[:5]
    t = time.perf_counter()
    for e in probe:
        s = e["segmentation"]
        np.flatnonzero(paste_mask_3d(s["box"], s["mask"], s["shape"]))
    per_det = (time.perf_counter() - t) / max(len(probe), 1)
    out["segm_predicted_s"] = per_det * len(entries)
    segm_entries = entries
    if out["segm_predicted_s"] > SEGM_EVAL_BUDGET_S:
        segm_entries = sorted(entries, key=lambda e: -e["score"])[
            :SEGM_EVAL_TOP]
        out["segm_note"] = (
            f"segm scored on the top {SEGM_EVAL_TOP} merged detections: "
            f"all {len(entries)} would take ~{out['segm_predicted_s']:.0f} s")
    t = time.perf_counter()
    out["segm"] = CocoEval3D(gt, segm_entries, "segm").named_stats("segm")
    out["segm_eval_s"] = time.perf_counter() - t
    out["segm_detections"] = len(segm_entries)
    return out


def check_wholevol_result(result):
    """Per-class (n, 7) finite rows inside the volume, one {box, mask,
    shape} carrier per row whose mask has the box's extents."""
    import numpy as np

    from mrcnn3d_torch.eval.masks import box_extent

    per_class, segms = result
    d, h, w = WHOLEVOL_SHAPE
    n = 0
    for rows, segs in zip(per_class, segms):
        if rows.ndim != 2 or rows.shape[1] != 7 or len(segs) != len(rows):
            raise AssertionError(f"wholevol: rows {rows.shape}, "
                                 f"{len(segs)} masks")
        if not np.isfinite(rows).all():
            raise AssertionError("wholevol: non-finite detections")
        lo, hi = rows[:, [0, 1, 4]], rows[:, [2, 3, 5]]
        if (lo < -1e-3).any() or (hi > np.array([w, h, d]) - 1 + 1e-3).any():
            raise AssertionError("wholevol: a box leaves the volume")
        for seg in segs:
            if tuple(seg["shape"]) != WHOLEVOL_SHAPE or \
                    seg["mask"].shape != box_extent(seg["box"]):
                raise AssertionError("wholevol: a mask's frame or extent")
        n += len(rows)
    if n == 0:
        raise AssertionError("wholevol: no detections")
    return n


def run_wholevol(device, calls=3):
    """The whole volume at full width: 1 first call and `calls` timed
    ones with the launch counters zeroed just before and read just after;
    then one profiled sweep, one sweep whose first tile's K1 and K2
    launches are recorded, and the 3-D COCO scores."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.ops import nms3d, roi_align3d

    torch.backends.cudnn.benchmark = True
    det = build(main_config(), device=device, dtype=torch.bfloat16,
                budgets=MAIN_BUDGET, seed=0)
    t = time.perf_counter()
    sample = {"imgs": np.random.RandomState(13).standard_normal(
        (*WHOLEVOL_SHAPE, 3)).astype(np.float32)}
    make_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms3d.launches = 0
    roi_align3d.launches = 0
    walls, timers, result = [], [], None
    for i in range(1 + calls):
        tm = {}
        t = time.perf_counter()
        result = det.tiled(sample, timers=tm, **WHOLEVOL)
        wall = time.perf_counter() - t
        if i == 0:
            first = dict(seconds=wall, timers=tm)
        else:
            walls.append(wall)
            timers.append(tm)
    launches = {"nms3d": nms3d.launches, "roi_align3d": roi_align3d.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_calls = 1 + calls
    if first["timers"]["n_tiles"] != WHOLEVOL_TILES:
        raise AssertionError(f"wholevol: {first['timers']['n_tiles']} tiles")
    per_volume = {k: WHOLEVOL_TILES * v for k, v in
                  {"nms3d": 3, "roi_align3d": 4}.items()}
    for name, count in per_volume.items():
        if launches[name] != count * n_calls:
            raise AssertionError(
                f"wholevol: {name} {launches[name]} launches in {n_calls} "
                f"volumes, expected {count} per volume")
    n_det = check_wholevol_result(result)
    med = {k: float(np.median([tm[k] for tm in timers])) for k in timers[0]}
    profile = profile_step(lambda: det.tiled(sample, **WHOLEVOL))
    # the first tile's launches: a tile is one simple_test, so its K1 and
    # K2 launches are the first of the sweep's
    with Capture() as captured:
        det.tiled(sample, **WHOLEVOL)
    torch.cuda.synchronize()
    captured.calls = {k: v[:len(STEP_CALLS[k])]
                      for k, v in captured.calls.items()}
    scores = score_wholevol(result, wholevol_gt())
    return dict(
        shape=list(WHOLEVOL_SHAPE), **WHOLEVOL, volume_make_s=make_s,
        first_call=first, calls=calls, e2e_s=walls,
        median_e2e_s=float(np.median(walls)),
        spread_e2e_s=float(max(walls) - min(walls)), median_timers=med,
        detections=n_det, max_memory_allocated_gib=peak,
        launches=launches, launches_per_volume=per_volume,
        profile=profile, scores=scores,
    ), captured


# ---------------------------------------------------------------------------
# phase 13: the pinned learning protocol, cut to 200 iterations
# ---------------------------------------------------------------------------


LEARN_ITERS = 200
LEARN_SEED = 2024
# the losses' means over the first and the last LEARN_WINDOW iterations
LEARN_WINDOW = 20


def kernel_counts():
    from mrcnn3d_torch.ops import nms3d, roi_align3d

    return {"nms3d": nms3d.launches, "roi_align3d": roi_align3d.launches,
            "roi_align3d_backward": roi_align3d.backward_launches}


def zero_counts():
    from mrcnn3d_torch.ops import nms3d, roi_align3d

    nms3d.launches = 0
    roi_align3d.launches = 0
    roi_align3d.backward_launches = 0


def check_first_batch(cfg, data, device):
    """The loader's first batch on the card against the numpy sample it
    was made from (a second dataset from the same seed): every array bit
    for bit, the volumes NCDHW in channels_last_3d storage.  Returns
    (what was checked, the batch)."""
    import numpy as np
    import torch

    from mrcnn3d_torch.data.loader import Prefetcher, epoch_indices
    from mrcnn3d_torch.tools.learning_bench import train_dataset

    ann_tr, dir_tr = data[1:3]
    loaded = train_dataset(cfg, ann_tr, dir_tr, LEARN_SEED)
    plain = train_dataset(cfg, ann_tr, dir_tr, LEARN_SEED)
    loader = Prefetcher(loaded, 1, seed=LEARN_SEED, num_workers=1,
                        device=device)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    sample = plain[int(epoch_indices(len(plain), 0, True, 0, 1,
                                     LEARN_SEED)[0])]
    if set(batch) != set(sample):
        raise AssertionError(f"learn: batch keys {sorted(batch)}")
    for k, v in sample.items():
        t = batch[k]
        if t.device != torch.device(device):
            raise AssertionError(f"learn: {k} on {t.device}")
        if k.startswith("imgs"):
            if not t.is_contiguous(memory_format=torch.channels_last_3d):
                raise AssertionError(f"learn: {k} not channels_last_3d")
            t = t.permute(0, 2, 3, 4, 1)
        got = t.cpu().numpy()[0]
        if got.dtype != v.dtype or not np.array_equal(got, v):
            raise AssertionError(f"learn: the first batch's {k} differs "
                                 "from its sample")
    return dict(keys=sorted(sample), bytes=sum(v.nbytes for v in
                                               sample.values()),
                imgs=list(batch["imgs"].shape),
                imgs_2=list(batch["imgs_2"].shape)), batch


class PlainKernels:
    """Within the block, the kernels' wrappers run their plain PyTorch
    versions (on the card's tensors, uncounted)."""

    SWAPS = (("nms3d", "greedy_scan_cuda", "greedy_scan_plain"),
             ("roi_align3d", "roi_align_3d_cuda", "roi_align_3d_plain"),
             ("roi_align3d", "roi_align_3d_backward_cuda",
              "roi_align_3d_backward_plain"))

    def __enter__(self):
        from mrcnn3d_torch.ops import nms3d, roi_align3d

        mods = {"nms3d": nms3d, "roi_align3d": roi_align3d}
        self._saved = []
        for name, attr, plain in self.SWAPS:
            mod = mods[name]
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, getattr(mod, plain))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


def learn_gradients(state, batch, plain):
    """forward_train and its backward with the weights `state` holds, on
    `batch`, the samplers drawing from CountedDraws(LEARN_SEED); with
    `plain`, the plain versions in place of the kernels.  Returns
    (losses, {parameter: gradient}, the recorded samples, the draws'
    counts), all on the CPU; the parameters' gradients are cleared."""
    import contextlib

    from mrcnn3d_torch.detectors.pipeline import forward_train

    model = state.model
    sets = state.anchor_sets([batch["imgs"].shape[2:],
                              batch["imgs_2"].shape[2:]])
    model.zero_grad(set_to_none=True)
    draws = CountedDraws(LEARN_SEED)
    swap = PlainKernels() if plain else contextlib.nullcontext()
    with SampleRecorder() as rec, swap:
        total, losses = forward_train(model, batch, state.cfg, sets, draws)
        total.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            rec.made, draws.highs)


def check_learn_gradients(state, batch):
    """The trained detector's gradients on one batch of the learning
    run, through the kernels against through their plain versions, on
    the card, from the same draws: every draw's count and sample equal,
    the losses within PIPELINE_ATOL, each parameter's gradient within
    PIPELINE_ATOL of the plain gradient's largest magnitude.  Reports the
    largest relative error of each module."""
    kern = learn_gradients(state, batch, plain=False)
    plain = learn_gradients(state, batch, plain=True)
    made_err, loss_err = compare_samples(kern, plain, "learn gradients")
    if set(kern[1]) != set(plain[1]):
        raise AssertionError("learn gradients: different parameters")
    rel = {}
    for name, want in plain[1].items():
        scale = float(want.abs().max())
        e = float((kern[1][name] - want).abs().max())
        if not e <= PIPELINE_ATOL * scale:
            raise AssertionError(f"learn gradients: {name} differs by {e}, "
                                 f"largest {scale}")
        rel[name] = e / scale if scale else 0.0
    by_module = {}
    for name, r in rel.items():
        mod = name.split(".")[0]
        by_module[mod] = max(by_module.get(mod, 0.0), r)
    return dict(losses=kern[0], max_loss_err=loss_err,
                positives=[h for site, _, h in plain[3] if site[-1] == "pos"],
                max_sample_float_err=made_err,
                worst_grad_rel_err_by_module=by_module, tol=PIPELINE_ATOL)


def run_learn(device, workdir, cfg=None, geometry=None, iters=LEARN_ITERS):
    """The pinned learning protocol through the port's entry points, cut
    to `iters` iterations: the pinned data (its hash must be
    LEARNING.json's), the loader's first batch on the card, train_detector
    at full width from seed LEARN_SEED through the Prefetcher with the
    config's workers (float32, TF32 off; the counters zeroed just before
    and read just after: K1 2, K2 5 and K2's backward 5 launches an
    iteration), then tools/learning_bench.py's double_test + segm
    evaluation of the checkpoint it leaves (counted the same way).  The
    launches of the last iteration and of the evaluation's last volume (a
    pass-2 volume pair, 576x576x108 twin) are recorded and each checked
    against its plain version, and the trained detector's gradients on
    the first batch through the kernels against through the plain
    versions.  Returns (the phase's record, the data, the checked
    launches).  cfg / geometry replace the flagship and the pinned data
    (the CPU rehearsal)."""
    import numpy as np
    import torch

    from mrcnn3d_torch.apis.test_api import load_detector
    from mrcnn3d_torch.apis.train_api import train_detector
    from mrcnn3d_torch.tools import learning_bench as lb
    from mrcnn3d_torch.utils.config import Config

    cfg = cfg or Config.fromfile(CONFIG)
    out = {}
    t = time.perf_counter()
    data = lb.generate_pinned_data(workdir, cfg.get("upscale_factor", 1.5),
                                   geometry)
    out["data_s"] = time.perf_counter() - t
    with open(os.path.join(REPO, "LEARNING.json")) as f:
        pinned = json.load(f)["data_sha256"]
    out["data_sha256"] = data[0]
    if geometry is None and data[0] != pinned:
        raise AssertionError(f"learn: data hash {data[0]} is not the "
                             f"pinned {pinned}")
    t = time.perf_counter()
    out["first_batch"], batch = check_first_batch(cfg, data, device)
    out["first_batch_s"] = time.perf_counter() - t

    dataset = lb.train_dataset(cfg, data[1], data[2], LEARN_SEED)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with Capture(tuple(TRAIN_PER_STEP), keep=keep_last(
            {**TRAIN_STEP_CALLS, "roi_align3d_backward":
             TRAIN_STEP_CALLS["roi_align3d"]})) as captured:
        state = train_detector(cfg, dataset, work_dir=workdir,
                               seed=LEARN_SEED, max_iters=iters,
                               log_interval=100, device=device, stats=stats)
    launches = kernel_counts()
    for name, count in TRAIN_PER_STEP.items():
        if launches[name] != count * iters:
            raise AssertionError(
                f"learn: {name} {launches[name]} launches in {iters} "
                f"iterations, expected {count} per iteration")
    losses = np.asarray(stats["losses"])
    first = float(losses[:LEARN_WINDOW].mean())
    last = float(losses[-LEARN_WINDOW:].mean())
    if stats["iters"] != iters or not np.isfinite(losses).all() \
            or not last < first:
        raise AssertionError(f"learn: {stats['iters']} iterations, loss "
                             f"mean {first} over the first and {last} over "
                             f"the last {LEARN_WINDOW}")
    out.update(
        iters=iters, train_s=stats["seconds"],
        iters_per_s=iters / stats["seconds"],
        loader_wait_s=stats["loader_wait_s"],
        loader_wait_share=stats["loader_wait_s"] / stats["seconds"],
        first_step_s=stats["first_step_s"],
        loss_mean_first=first, loss_mean_last=last, window=LEARN_WINDOW,
        workers=cfg.data.get("workers_per_gpu", 4),
        launches=launches, launches_per_iteration=TRAIN_PER_STEP,
        train_max_memory_allocated_gib=torch.cuda.max_memory_allocated()
        / 2**30,
    )
    t = time.perf_counter()
    calls = {"train": check_train_step_kernels(captured)}
    del captured
    out["gradients"] = check_learn_gradients(state, batch)
    out["checks_s"] = time.perf_counter() - t
    del state, batch

    model, step = load_detector(cfg, workdir, device)
    if step != iters:
        raise AssertionError(f"learn: checkpoint at step {step}")
    timers = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    pass2 = volume_calls(cfg.get("test_cfg2", cfg.test_cfg))
    with Capture(keep=keep_last(pass2)) as captured:
        stats, single, segm, quality = lb.evaluate_protocol(
            cfg, model, data[3], data[4], data[5], data[6], timers)
    out["eval_s"] = time.perf_counter() - t
    eval_launches = kernel_counts()
    for name in ("nms3d", "roi_align3d"):
        if not eval_launches[name]:
            raise AssertionError(f"learn: no {name} launch in the eval")
    for what, s in (("bbox", stats), ("single", single), ("segm", segm)):
        v = np.array(list(s.values()))
        if len(v) != 29 or not (np.isfinite(v).all() and (v <= 1).all()
                                and (v >= -1).all()):
            raise AssertionError(f"learn: {what} stats {s}")
    out.update(
        eval_launches=eval_launches, eval_timers=timers,
        eval_max_memory_allocated_gib=torch.cuda.max_memory_allocated()
        / 2**30,
        bbox={k: stats[k] for k in ("bbox_mAP", "bbox_mAP_0.5",
                                    "bbox_AR_100")},
        bbox_single_pass={k: single[k] for k in ("bbox_mAP", "bbox_mAP_0.5",
                                                 "bbox_AR_100")},
        segm={k: segm[k] for k in ("segm_mAP", "segm_mAP_0.5")},
        mask_quality=quality,
    )
    calls["eval"] = check_launches(captured, pass2, "evaluation volume")
    return out, data, calls


# ---------------------------------------------------------------------------
# phase 14: the serving loop over the val volumes
# ---------------------------------------------------------------------------


SERVE_VOLUMES = 4


def run_serve(device, workdir, data, cfg=None):
    """apis.serve.watch with the checkpoint `learn` left over an in-dir
    holding the val volumes (stop_after=SERVE_VOLUMES), the counters
    zeroed just before and read just after; each volume's json against
    run_inference's rows for it (same counts, PIPELINE_ATOL).  Both run
    the same detector (`InferenceRunner.simple_test`), so this holds the
    serving loop's file IO and its host-side twin against the dataset's,
    not the detector against a reference (the JAX comparison is the CPU
    test's); the detector's launches on this path, those of the last
    served volume, are recorded and each checked against its plain
    version.  Returns (the phase's record, the checked launches)."""
    import shutil

    import numpy as np

    from mrcnn3d_torch.apis.serve import watch
    from mrcnn3d_torch.apis.test_api import (
        InferenceRunner,
        load_detector,
        run_inference,
    )
    from mrcnn3d_torch.tools.common import test_dataset
    from mrcnn3d_torch.utils.config import Config

    cfg = cfg or Config.fromfile(CONFIG)
    ann_va, dir_va = data[3:5]
    te = cfg.data["test"]
    ds = test_dataset(te, ann_va, dir_va)
    in_dir = os.path.join(workdir, "serve_in")
    out_dir = os.path.join(workdir, "serve_out")
    os.makedirs(in_dir)
    for info in ds.img_infos:
        shutil.copy(os.path.join(dir_va, info["file_name"]), in_dir)
    model, step = load_detector(cfg, workdir, device)
    runner = InferenceRunner(cfg, model)
    timers = {}
    zero_counts()
    t = time.perf_counter()
    names = volume_calls(cfg.test_cfg)
    with Capture(keep=keep_last(names)) as captured:
        watch(runner, in_dir, out_dir, te["img_norm_cfg"],
              size_divisor=te.get("size_divisor", 32), poll_s=0.05,
              stop_after=SERVE_VOLUMES, timers=timers)
    wall = time.perf_counter() - t
    launches = kernel_counts()
    for name in ("nms3d", "roi_align3d"):
        if not launches[name]:
            raise AssertionError(f"serve: no {name} launch")
    results, infos = run_inference(cfg, model, ds, progress=False)[:2]
    if len(infos) != SERVE_VOLUMES or \
            len(os.listdir(out_dir)) != SERVE_VOLUMES:
        raise AssertionError(f"serve: {len(os.listdir(out_dir))} jsons")
    err, n = 0.0, 0
    for res, info in zip(results, infos):
        name = os.path.splitext(info["file_name"])[0] + ".json"
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        rows = [np.asarray(rec[f"class_{c + 1}"], np.float32).reshape(-1, 7)
                for c in range(len(res))]
        e, _, _ = compare_tiled((rows, [[]] * len(rows)),
                                (res, [[]] * len(res)), {}, PIPELINE_ATOL,
                                f"serve {name} against run_inference")
        err = max(err, e)
        n += sum(len(r) for r in rows)
    if n == 0:
        raise AssertionError("serve: no detections, vacuous")
    calls = check_launches(captured, names, "served volume")
    return dict(volumes=SERVE_VOLUMES, checkpoint_step=step,
                watch_s=wall, seconds_per_volume=wall / SERVE_VOLUMES,
                volume_s=timers["volume_s"], detections=n,
                max_abs_err=err, tol=PIPELINE_ATOL,
                launches=launches), calls


def _per_call(calls):
    return [{k: c[k] for k in ("name", "valid", "ms", "device_ms",
                               "device_ms_by_kernel", "plain_ms",
                               "bound_ms", "bound_by")}
            for c in calls]


def _step_sums(calls):
    """ms, device_ms, plain_ms and the bound summed over one step's
    launches."""
    b_ms, b_by = bound(sum(c["bytes"] for c in calls),
                       sum(c["ops"] for c in calls))
    return {"ms": sum(c["ms"] for c in calls),
            "device_ms": sum_or_none(c["device_ms"] for c in calls),
            "plain_ms": sum(c["plain_ms"] for c in calls),
            "bound_ms": b_ms, "bound_by": b_by}


def _path_sums(prefix, calls):
    """_step_sums and the per-launch records of one path's recorded
    launches, under keys that start with `prefix`."""
    return {**{f"{prefix}_{k}": v for k, v in _step_sums(calls).items()},
            f"{prefix}_calls": _per_call(calls)}


def kernels_line(nms_calls, align_calls, backward_calls, step_calls,
                 main_path, train_calls, train_path, tile_calls, wholevol,
                 learn, learn_calls, serve, serve_calls):
    """The {"kernels": [...]} record.  Per kernel: launches from the
    counted run of its path (K1 and K2: the inference main path, with the
    train path's beside them as train_* and the whole volume's as
    wholevol_*; K2's backward: the train path); ms (CUDA events),
    device_ms (profiler), plain_ms and the bound summed over one step's
    launches, each run alone on the arguments the path gave it (for the
    whole volume, one tile's: wholevol_tile_*); the profiled device time
    of the same kernel within one step (one whole volume); the largest
    error of every comparison (phase 3 and the steps', tile's, learning
    iteration's and volumes' calls).  The learning run's and the serving
    loop's counted launches stand beside them as learn_launches,
    learn_eval_launches and serve_launches; the same sums over the
    launches of the learning run's last iteration (learn_iter_*), of its
    evaluation's last volume pair (learn_eval_volume_*) and of the last
    served volume (serve_volume_*)."""
    profile = main_path["profile"] or {}
    train_profile = train_path["profile"] or {}
    wholevol_profile = wholevol["profile"] or {}
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
        paths = {"learn_iter": learn_calls["train"][name],
                 "learn_eval_volume": learn_calls["eval"][name],
                 "serve_volume": serve_calls[name]}
        train = _step_sums(train_calls[name])
        tile = _step_sums(tile_calls[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "launches_per_step": main_path["launches_per_step"][name],
            "max_abs_err": max(c["max_abs_err"]
                               for c in checked + calls + train_calls[name]
                               + tile_calls[name]
                               + sum(paths.values(), [])),
            **_step_sums(calls), "library_ms": None,
            "profiled_ms_per_step":
                profile.get("port_kernels_ms", {}).get(name),
            "matched": True,
            "per_step_calls": _per_call(calls),
            "train_launches": train_path["launches"][name],
            "train_launches_per_step": train_path["launches_per_step"][name],
            **{f"train_{k}": v for k, v in train.items()},
            "train_profiled_ms_per_step":
                train_profile.get("port_kernels_ms", {}).get(name),
            "train_per_step_calls": _per_call(train_calls[name]),
            "wholevol_launches": wholevol["launches"][name],
            "wholevol_launches_per_volume":
                wholevol["launches_per_volume"][name],
            "wholevol_profiled_ms_per_volume":
                wholevol_profile.get("port_kernels_ms", {}).get(name),
            **{f"wholevol_tile_{k}": v for k, v in tile.items()},
            "learn_launches": learn["launches"][name],
            "learn_eval_launches": learn["eval_launches"][name],
            "serve_launches": serve["launches"][name],
            **{k: v for prefix, c in paths.items()
               for k, v in _path_sums(prefix, c).items()},
        })
    calls = train_calls["roi_align3d_backward"]
    learn_back = learn_calls["train"]["roi_align3d_backward"]
    kernels.append({
        "name": "roi_align3d_backward", "route": "cuda",
        "source": "mrcnn3d_torch/csrc/roi_align3d.cu", "replaces": None,
        "note": "no TPU counterpart: the JAX package differentiates its "
                "dense XLA align (mrcnn3d/ops/roi_align3d.py:461) instead",
        "launches": train_path["launches"]["roi_align3d_backward"],
        "launches_per_step":
            train_path["launches_per_step"]["roi_align3d_backward"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in calls + learn_back + backward_calls),
        **_step_sums(calls), "library_ms": None,
        "profiled_ms_per_step":
            train_profile.get("port_kernels_ms", {}).get(
                "roi_align3d_backward"),
        "matched": True, "per_step_calls": _per_call(calls),
        "learn_launches": learn["launches"]["roi_align3d_backward"],
        "learn_eval_launches": learn["eval_launches"]["roi_align3d_backward"],
        "serve_launches": serve["launches"]["roi_align3d_backward"],
        **_path_sums("learn_iter", learn_back),
    })
    return {"kernels": kernels}


def run_train_phases(device):
    """Phases 8-9: the flagship's train step, then its launches alone."""
    t = time.perf_counter()
    train_path, captured = run_train_path(device)
    emit({"phase": "train", "ok": True, **train_path,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    train_calls = check_train_step_kernels(captured)
    del captured
    emit({"phase": "train_step_kernels", "ok": True, **train_calls,
          "seconds": time.perf_counter() - t})
    return train_path, train_calls


def run_learn_phases(device):
    """Phases 13-14: the learning protocol cut short, then serving its
    checkpoint, in a temporary work directory."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_learn_")
    try:
        t = time.perf_counter()
        learn, data, learn_calls = run_learn(device, workdir)
        emit({"phase": "learn", "ok": True, **learn,
              "kernel_checks": learn_calls,
              "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        serve, serve_calls = run_serve(device, workdir, data)
        emit({"phase": "serve", "ok": True, **serve,
              "kernel_checks": serve_calls,
              "seconds": time.perf_counter() - t})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return learn, learn_calls, serve, serve_calls


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=("train", "learn"),
                   help="run phases 1-2 and then only these")
    p.add_argument("--port", default=REPO,
                   help="the checkout whose mrcnn3d_torch is driven")
    args = p.parse_args(argv)
    port = os.path.abspath(args.port)
    t_start = time.perf_counter()
    require_card(port)
    import torch

    import mrcnn3d_torch

    if not mrcnn3d_torch.__file__.startswith(port + os.sep):
        raise SystemExit(f"chip_smoke.py: mrcnn3d_torch came from "
                         f"{mrcnn3d_torch.__file__}, not {port}")
    card = card_line()
    emit({"phase": "device", "ok": True, "card": card, "port": port,
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
    if args.only:
        {"train": run_train_phases, "learn": run_learn_phases}[args.only](
            device)
        print(card, flush=True)
        return 0

    from mrcnn3d_torch.entry import build

    t = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(5)
    nms_calls = check_nms(gen, device)
    shape_model = build(CONFIG, device=device, budgets=MAIN_BUDGET)
    align_calls = check_align(gen, shape_model, device)
    backward_calls = check_backward(gen, shape_model, device)
    del shape_model
    emit({"phase": "kernels", "ok": True, "nms3d": nms_calls,
          "roi_align3d": align_calls, "roi_align3d_backward": backward_calls,
          "seconds": time.perf_counter() - t})

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

    t = time.perf_counter()
    small_train = check_small_train(device)
    emit({"phase": "small_train", "ok": True, **small_train,
          "seconds": time.perf_counter() - t})

    train_path, train_calls = run_train_phases(device)

    t = time.perf_counter()
    small_tiled = check_small_tiled(device)
    emit({"phase": "small_tiled", "ok": True, **small_tiled,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    wholevol, captured = run_wholevol(device)
    emit({"phase": "wholevol", "ok": True, **wholevol,
          "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    tile_calls = check_step_kernels(captured)
    del captured
    emit({"phase": "wholevol_tile_kernels", "ok": True, **tile_calls,
          "seconds": time.perf_counter() - t})

    learn, learn_calls, serve, serve_calls = run_learn_phases(device)

    emit(kernels_line(nms_calls, align_calls, backward_calls, step_calls,
                      main_path, train_calls, train_path, tile_calls,
                      wholevol, learn, learn_calls, serve, serve_calls))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
