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
                 update within 2e-3 of the CPU update's largest magnitude;
                 the CPU pass's max-pools take the card's argmax per
                 window and its relus the card's branch per unit, each
                 window or unit where the two differ proven a tie (both
                 values, or the unit's input, within 1e-4 of the call's
                 largest input).
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
                 gradients on each batch of the loader's first epoch (the
                 12 train volumes) through the kernels against through
                 the plain versions on the card, from the same draws,
                 cuDNN pinned to its deterministic algorithms in both
                 passes (samples equal, losses and each parameter's
                 gradient within 2e-3 of its largest; every K2 forward
                 launch of the kernel pass within K2's gate of its plain
                 version; the plain pass takes the kernel pass's relu
                 branch at ties, each within 1e-4 of its call's largest
                 input; a failure names the kernel whose plain version
                 alone reproduces it); then the
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
                 Timed at the config; the comparison then serves again
                 the top 32 rows a volume at any score, so each volume
                 has rows to compare.
 15. variants -- the nine 3-D two-stage variants (VARIANTS, each the
                 flagship config by the JAX tests' recipe): each at the
                 narrow widths on the card against the CPU (inference:
                 valid, labels and the parcellations' arg-max equal, the
                 rest within 2e-3; one train step as in phase 7), then at
                 full width, bf16, budgets 2000, masks on: inference on
                 the headline geometry (three scales: a 144x1152x1152
                 third volume) and the train step on bench.py's (three
                 scales: a 144x288x288 third crop), 1 warm-up and 3
                 timed each, peak memory, the counters zeroed just
                 before and read just after (VARIANT_LAUNCHES a step);
                 the launches of one inference and one train step of
                 MaskRCNN3D and MaskRCNN3D3ScalesHeads each against
                 its plain version and timed alone, as in phases 6
                 and 9.
 16. families -- the single-stage and cascade families (FAMILIES:
                 configs/retinanet_3d.py as shipped, configs/htc_3d.py
                 with masks on, and that file as CascadeRCNN3D): each at
                 the narrow widths (budgets 64) on the card against the
                 CPU (inference as in phase 15, one train step as in
                 phase 7, HTC with a gt_semantic_seg), then at full
                 width, bf16, the config's own budgets: inference on the
                 headline 64x512x512 volume and the train step on
                 bench.py's training geometry (batch 2, 16 gt with
                 masks; HTC's gt_semantic_seg made from them at full
                 resolution), 1 warm-up and 3 timed each, peak memory,
                 the counters zeroed just before and read just after
                 (FAMILY_LAUNCHES a step); the launches of one
                 RetinaNet3D inference step (its 4256-row class-wise
                 K1), one HTC inference step and one HTC train step (the
                 one-level semantic aligns and their backward) each
                 against its plain version and timed alone.
 17. multicard -- (a) a process group of one rank under NCCL: the
                 flagship's train step at full width, bf16, on bench.py's
                 training geometry, one process's (as phase 8) and the
                 data-parallel one (mesh of one: normalizers and losses
                 summed over the group, the gradient all-reduced), 1
                 warm-up and 3 timed each, the counters zeroed just
                 before the data-parallel steps and read just after
                 (TRAIN_PER_STEP a step); the all-reduce's stage time and
                 its time alone; the host time of the parts the
                 data-parallel step adds or changes (HostSpans) and one
                 profiled step of each (device busy, idle share, NCCL);
                 evaluate_dataset on 2 synthetic volumes (29 finite
                 stats).  (b) two gloo processes on
                 the one card (parallel.launch.spawn, the kernels built
                 in phase 2), narrow widths, float32: one data-parallel
                 step against one process over the global batch of 2
                 (every update and gradient within MULTICARD_TOL of its
                 parameter's largest), make_batched_infer against serial
                 simple_test and sharded_simple_test (depth over the
                 two ranks) against the replicated one (valid and labels
                 equal, the rest within 2e-3); every rank's counters
                 show K1 and K2 (and K2's backward in the step); then
                 entry.dryrun_multichip(2) on the card (a data-parallel
                 and a hybrid step, two gloo processes).
 18. extras   -- the rest of the 3-D side.  (a) The flagship config with
                 each backbone of BACKBONES (ResNet3D-18, -34, -101,
                 -152, ResNeXt3D-50 at groups 32 and base width 4,
                 UNet3D at base 16), (b) with the R-CNN sampler
                 OHEMSampler, (c) test-time augmentation of single-scale
                 MaskRCNN3D at depth 50 over three views (identity,
                 W-flip, 1.5x by ops/resize3d.py): each at the narrow
                 widths on the card against the CPU (inference as in
                 phase 15, one train step as in phase 7, every sample
                 index equal), then at full width, bf16, budgets 2000,
                 masks on, R-CNN score threshold 0 (the mask stage at
                 the full budget whatever random weights score):
                 inference on the headline geometry (TTA: the
                 three views of 64x512x512) and the train step on
                 bench.py's (OHEM: its train step only, one timed), 1
                 warm-up and 3 timed, peak memory, the counters zeroed
                 just before and read just after (EXTRAS_LAUNCHES a
                 step); the launches of one inference and one train step
                 of each backbone and of one TTA call each against its
                 plain version and timed alone.  (d) The
                 host modules on the card's outputs, as a check that
                 they run: eval_map_3d of the TTA detections,
                 eval_recalls_3d of RPN3D's proposals, soft_nms_3d on the
                 TTA pre-NMS rows, roi_pool_3d on a full-width FPN level
                 against its numpy oracle (exactly).
 19. two_d    -- the 2-D legacy family (TWO_D: RPN, FasterRCNN,
                 FastRCNN, MaskRCNN, RetinaNet, CascadeRCNN,
                 HybridTaskCascade, each by two_d_config from
                 configs/faster_rcnn_2d.py): each at the JAX tests'
                 narrow recipe (ResNet-18 at width 8, FPN 32, 3 classes,
                 budgets 32, a 1x64x64 image) on the card against the
                 CPU (inference as in phase 15, one train step as in
                 phase 7 with the max-pool ties replayed), then at full
                 width, bf16: ResNet-50 at base width 64, FPN 256, 81
                 classes, the config's budgets, R-CNN score threshold 0;
                 inference on one 1x800x1344 image (FastRCNN on 1000
                 precomputed proposals) and the train step on 2 images
                 with 20 gt each (masks for MaskRCNN and HTC), 1 warm-up
                 and 3 timed each, peak memory, the counters zeroed just
                 before and read just after (TWO_D_LAUNCHES a step); the
                 launches of one inference and one train step of
                 FasterRCNN and MaskRCNN (the 80-segment class-wise K1,
                 the depth-1 K2 and its backward) each against its plain
                 version and timed alone; the flagship's train step at
                 bench.py's training geometry with and without
                 backbone.with_cp (time, peak memory, first updates
                 within 2e-3); the 2-D host modules on the card:
                 load_reference_checkpoint of a file it writes, DCN's
                 forward and backward on a full-width FPN level against
                 the CPU.
Then the kernels line, the card line and, last, the result line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
not 0 and no result line is printed.

    python3 chip_smoke.py \
        --only train|learn|variants|families|multicard|extras [--port DIR]

runs phases 1-2 and then only phases 8-9 (train), 13-14 (learn and
serve), 15 (variants), 16 (families), 17 (multicard) or 18 (extras), and
prints no result line:
the way to set two versions of the port side by side on one card.
--port takes another checkout (an older commit unpacked with git
archive) whose mrcnn3d_torch these phases then drive; run it from this
one, in turns with --port left out.

    python3 chip_smoke.py --only learn --learn-states N

also trains N more detectors as phase 13 does, from seeds 2025 on, and
holds each one's gradients to phase 13's gate (one line each): how near
trained states come to it.
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


def check_align_output(got, want, what):
    """K2's output `got` against its plain version's `want`: every value
    within ALIGN_TOL of the dtype, or one bf16 step.  Returns (largest
    error, tolerance); raises naming `what` otherwise."""
    import torch

    dtype = want.dtype
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
            f"{what} {dtype}: {int((~ok).sum())} values differ by more "
            f"than {tol} and one bf16 step; max error {err}")
    return err, tol


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
    err, tol = check_align_output(got, want, f"K2 {name}")
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


# the 3-D two-stage types besides the flagship, the paper's ablation arms
VARIANTS = ("RPN3D", "FasterRCNN3D", "MaskRCNN3D", "MaskRCNN3DParcel",
            "MaskRCNN3D2ScalesHeads", "MaskRCNN3D2ScalesHeadsRefinementHead",
            "MaskRCNN3D3ScalesHeads", "MaskRCNN3D3ScalesOnePathway",
            "MaskRCNN3D2ScalesOnePathwayOneRPN")
SINGLE_SCALE = ("RPN3D", "FasterRCNN3D", "MaskRCNN3D", "MaskRCNN3DParcel")


def variant_recipe(cfg, type_name):
    """A variant's config from the flagship's, in place, by the JAX
    tests' recipe (tests/test_variants.py:17-37, without its narrowing):
    the type set, rpn_head_2 dropped for single-scale types, the mask
    (and refinement) heads dropped where the type has none."""
    m = cfg.model
    m["type"] = type_name
    drop = []
    if type_name in SINGLE_SCALE:
        drop.append("rpn_head_2")
    if type_name == "MaskRCNN3D2ScalesHeadsRefinementHead":
        drop += ["mask_head", "refinement_mask_head"]
    if type_name in ("RPN3D", "FasterRCNN3D"):
        drop += ["mask_head", "refinement_head", "refinement_mask_head"]
    for key in drop:
        m.pop(key, None)
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
    R-CNN sampler 32 rois (a quarter positive) per image
    (`entry.narrow_config`)."""
    from mrcnn3d_torch.entry import narrow_config

    return narrow_config(main_config(), SMALL_BUDGET)


def small_train_batch(seed, batch_size=2, max_gt=4, shapes=SMALL_SHAPES):
    """numpy training batch of the small shapes (NCDHW volumes; `shapes`
    of the two scales): gt boxes inside the volume (the 1.5x twin's
    scaled by 1.5), the last gt of each image invalid, labels 1, gt masks
    that fill each box's central part."""
    import numpy as np

    rng = np.random.RandomState(seed)
    (d, h, w), shape2 = shapes
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


# the small inputs of each scale: the flagship's two, and a 2.25x third
VARIANT_SHAPES = SMALL_SHAPES + [(18, 72, 72)]
PARCELLATIONS = 15


def variant_inputs(seed, scales):
    """numpy NCDHW volumes of the small pipeline for `scales` scales."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"imgs" + ("", "_2", "_3")[s]:
            rng.randn(1, 3, *VARIANT_SHAPES[s]).astype(np.float32)
            for s in range(scales)}


def variant_train_batch(seed, scales, parcel):
    """small_train_batch for `scales` scales: the third scale's volume
    (2.25x) and gt (boxes times 2.25), and with `parcel` each gt's brain
    region (0 to PARCELLATIONS - 1)."""
    import numpy as np

    batch = small_train_batch(seed)
    rng = np.random.RandomState(seed + 1)
    b = batch["imgs"].shape[0]
    if scales == 1:
        batch = {k: v for k, v in batch.items() if not k.endswith("_2")}
    if scales == 3:
        batch["imgs_3"] = rng.randn(b, 3, *VARIANT_SHAPES[2]).astype(
            np.float32)
        batch["gt_boxes_3"] = batch["gt_boxes"] * np.float32(2.25)
        batch["gt_labels_3"] = batch["gt_labels"]
        batch["gt_valid_3"] = batch["gt_valid"]
    if parcel:
        batch["gt_bregions"] = rng.randint(
            0, PARCELLATIONS, batch["gt_labels"].shape).astype(np.int32)
    return batch


# the small shapes of UNet3D, whose three poolings and crops need sides
# divisible by 8
UNET_SMALL_SHAPES = [(16, 32, 32), (24, 48, 48)]
# phase 18's backbones: name -> the config's backbone keys (ResNeXt3D
# takes the JAX defaults, groups 32 and 4 channels a group at 64 planes,
# its stem width from base_width; UNet3D its base_channels 16)
BACKBONES = {
    "ResNet3D-18": dict(type="ResNet3D", depth=18),
    "ResNet3D-34": dict(type="ResNet3D", depth=34),
    "ResNet3D-101": dict(type="ResNet3D", depth=101),
    "ResNet3D-152": dict(type="ResNet3D", depth=152),
    "ResNeXt3D-50": dict(type="ResNeXt3D", depth=50),
    "UNet3D": dict(type="UNet3D"),
}


def backbone_recipe(cfg, name):
    """The config with backbone `name` (BACKBONES), in place."""
    cfg.model["backbone"].update(BACKBONES[name])
    return cfg


# the single-stage and cascade families and the config each is built from
# (configs/htc_3d.py with model.type set for CascadeRCNN3D, whose row
# has no mask head; the semantic keys are read only under HTC)
FAMILIES = ("RetinaNet3D", "CascadeRCNN3D", "HybridTaskCascade3D")
FAMILY_FILES = {"RetinaNet3D": "retinanet_3d.py",
                "CascadeRCNN3D": "htc_3d.py",
                "HybridTaskCascade3D": "htc_3d.py"}
def family_config(type_name, config_cls=None):
    """A family's full config: configs/retinanet_3d.py as shipped,
    configs/htc_3d.py with masks on (return_bbox_only False), or that
    file with model.type CascadeRCNN3D.  config_cls: the package's Config
    class (the port's by default)."""
    if config_cls is None:
        from mrcnn3d_torch.utils.config import Config as config_cls
    cfg = config_cls.fromfile(os.path.join(REPO, "configs",
                                           FAMILY_FILES[type_name]))
    cfg.model["type"] = type_name
    if type_name != "RetinaNet3D":
        cfg.test_cfg["return_bbox_only"] = False
    return cfg


def family_narrow(cfg, budget):
    """A family config cut in place to the narrow widths (base width 4,
    FPN 8, fcs 32; depth 50 kept) and `budget` proposals, anchors kept
    per level and detections; each R-CNN stage samples `budget` // 2
    rois an image."""
    m = cfg.model
    m["backbone"]["base_width"] = 4
    m["neck"]["out_channels"] = 8
    m["bbox_head"]["fc_out_channels"] = 32
    m.pop("refinement_head", None)
    m.pop("refinement_mask_head", None)
    tc = cfg.test_cfg
    tc["rpn"]["nms_pre"] = budget
    tc["rcnn"]["max_per_img"] = budget // 2
    if m["type"] != "RetinaNet3D":
        for k in ("nms_post", "max_num"):
            tc["rpn"][k] = budget
        for k in ("nms_pre", "nms_post", "max_num"):
            cfg.train_cfg["rpn_proposal"][k] = budget
        for rc in cfg.train_cfg["rcnn"]:
            rc["sampler"]["num"] = budget // 2
    return cfg


def family_train_batch(seed, type_name):
    """small_train_batch on the 1.0x volume; for HTC a gt_semantic_seg at
    full resolution (class 1 on the voxels of the gt masks, 0 elsewhere,
    the first z slice ignored with 255), which the semantic loss resizes
    nearest to its grid."""
    import numpy as np

    batch = variant_train_batch(seed, 1, False)
    if type_name == "HybridTaskCascade3D":
        masks = batch["gt_masks"] * batch["gt_valid"][..., None, None, None]
        seg = masks.max(1).astype(np.int32)
        seg[:, 0] = 255
        batch["gt_semantic_seg"] = seg
    return batch


# the 2-D legacy family (ROADMAP A11.8 (a)): depth-1 images through the
# shipped 2-D config, each type by its recipe (two_d_config)
TWO_D_CONFIG = os.path.join(REPO, "configs", "faster_rcnn_2d.py")
TWO_D = ("RPN", "FasterRCNN", "FastRCNN", "MaskRCNN", "RetinaNet",
         "CascadeRCNN", "HybridTaskCascade")
TWO_D_MASKED = ("MaskRCNN", "HybridTaskCascade")
TWO_D_CASCADES = ("CascadeRCNN", "HybridTaskCascade")
# the shipped config's image: img_scale (1333, 800) padded to its
# size_divisor 32, one depth slice
TWO_D_SHAPE = (1, 800, 1344)
# the narrow image, as the JAX tests' (tests/test_2d_family.py:59)
TWO_D_SMALL_SHAPE = (1, 64, 64)


def two_d_config(type_name, config_cls=None):
    """A 2-D type's full config from configs/faster_rcnn_2d.py (as
    shipped for FasterRCNN, FastRCNN and RPN): MaskRCNN and HTC add the
    JAX tests' mask recipe (tests/test_2d_family.py:143-151: a 14x14x1
    align, 28x28x1 targets) at the config's widths, four convs, masks on;
    RetinaNet takes configs/retinanet_3d.py's focal head, assigner and
    test budgets over the config's 2-D anchors; the cascades take
    mmdet's three stages (IoU 0.5, 0.6, 0.7; loss weights 1, 0.5, 0.25)
    over the config's R-CNN sampler, and HTC the semantic branch of the
    JAX tests' HTC recipe (3 classes; stride 8, depth 1)."""
    if config_cls is None:
        from mrcnn3d_torch.utils.config import Config as config_cls
    cfg = config_cls.fromfile(TWO_D_CONFIG)
    m = cfg.model
    m["type"] = type_name
    fpn = m["neck"]["out_channels"]
    classes = m["bbox_head"]["num_classes"]
    strides = m["bbox_roi_extractor"]["featmap_strides"]
    if type_name in TWO_D_MASKED:
        m["mask_roi_extractor"] = dict(
            roi_layer=dict(out_size=14, out_size_depth=1, sample_num=2),
            out_channels=fpn, featmap_strides=list(strides),
            featmap_strides_depth=[1] * len(strides))
        m["mask_head"] = dict(num_convs=4, conv_out_channels=fpn,
                              num_classes=classes)
        cfg.test_cfg["return_bbox_only"] = False
    if type_name == "RetinaNet":
        m.pop("bbox_roi_extractor")
        m["bbox_head"] = dict(num_classes=classes, stacked_convs=4)
        cfg.train_cfg = dict(rpn=dict(
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                          neg_iou_thr=0.4, min_pos_iou=0.0,
                          ignore_iof_thr=-1),
            allowed_border=-1, gamma=2.0, alpha=0.25, pos_weight=-1,
            smoothl1_beta=1 / 9.0, debug=False))
        cfg.test_cfg = dict(
            rpn=dict(nms_pre=1000),
            rcnn=dict(score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                      max_per_img=100, mask_thr_binary=0.5),
            return_bbox_only=True)
    if type_name in TWO_D_CASCADES:
        base = dict(cfg.train_cfg["rcnn"])
        stages = []
        for thr in (0.5, 0.6, 0.7):
            st = dict(base)
            st["assigner"] = dict(base["assigner"], pos_iou_thr=thr,
                                  neg_iou_thr=thr, min_pos_iou=thr)
            stages.append(st)
        cfg.train_cfg["rcnn"] = stages
        cfg.train_cfg["stage_loss_weights"] = [1, 0.5, 0.25]
        m["bbox_head"]["reg_class_agnostic"] = True
    if type_name == "HybridTaskCascade":
        m["semantic_head"] = dict(
            type="FusedSemanticHead", num_ins=5, fusion_level=1,
            num_convs=4, num_classes=3, ignore_label=255, loss_weight=0.2)
        m["semantic_roi_extractor"] = dict(
            roi_layer=dict(out_size=14, out_size_depth=1, sample_num=2),
            out_channels=fpn, featmap_strides=[8],
            featmap_strides_depth=[1])
        m["semantic_fusion"] = ("bbox", "mask")
        m["interleaved"] = True
        m["mask_info_flow"] = True
    return cfg


def two_d_narrow(cfg, budget=32):
    """A 2-D config cut in place to the JAX tests' cfg2d (tests/
    test_2d_family.py:37-51): ResNet-18 at base width 8, FPN 32, fcs 64,
    3 classes, `budget` proposals an image (and anchors kept per level),
    the RPN sampler 64 anchors and each R-CNN stage `budget` // 2 rois an
    image, `budget` // 2 detections; two mask convs."""
    m = cfg.model
    m["backbone"].update(depth=18, base_width=8)
    m["neck"]["out_channels"] = 32
    m["bbox_head"]["num_classes"] = 3
    if "fc_out_channels" in m["bbox_head"]:
        m["bbox_head"]["fc_out_channels"] = 64
    if "mask_head" in m:
        m["mask_head"].update(num_convs=2, conv_out_channels=32,
                              num_classes=3)
    tc = cfg.test_cfg
    tc["rcnn"]["max_per_img"] = budget // 2
    tc["rpn"]["nms_pre"] = budget
    if m["type"] != "RetinaNet":
        for k in ("nms_post", "max_num"):
            tc["rpn"][k] = budget
        for k in ("nms_pre", "nms_post", "max_num"):
            cfg.train_cfg["rpn_proposal"][k] = budget
        cfg.train_cfg["rpn"]["sampler"]["num"] = 64
        rcnn = cfg.train_cfg["rcnn"]
        for rc in rcnn if isinstance(rcnn, (list, tuple)) else [rcnn]:
            rc["sampler"]["num"] = budget // 2
    return cfg


def two_d_inputs(seed, shape=TWO_D_SMALL_SHAPE, proposals=False):
    """numpy NCDHW depth-1 images; with `proposals`, FastRCNN's 12
    precomputed proposals an image (z [0, 0]), the last two invalid."""
    import numpy as np

    rng = np.random.RandomState(seed)
    _, h, w = shape
    batch = {"imgs": rng.randn(1, 3, *shape).astype(np.float32)}
    if proposals:
        m = 12
        xy = rng.uniform(0, 0.6, (m, 2)) * np.array([w, h])
        size = rng.uniform(0.1, 0.35, (m, 2)) * np.array([w, h])
        props = np.concatenate([xy, np.minimum(xy + size, [w - 1, h - 1]),
                                np.zeros((m, 2))], 1)
        valid = np.ones(m, bool)
        valid[-2:] = False
        batch.update(proposals=props[None].astype(np.float32),
                     proposals_valid=valid[None])
    return batch


def two_d_train_batch(seed, type_name, shape=TWO_D_SMALL_SHAPE, max_gt=4,
                      batch_size=2):
    """numpy training batch of depth-1 images: gt boxes with z [0, 0]
    (the last of each image invalid), labels 1 and 2 in turn, masks
    that fill each box's central part (MaskRCNN, HTC), and HTC's
    gt_semantic_seg (each gt's label on its mask, 255 on the first row)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    _, h, w = shape
    b, g = batch_size, max_gt
    xy = rng.uniform(0.05, 0.55, (b, g, 2)) * np.array([w, h])
    size = rng.uniform(0.15, 0.4, (b, g, 2)) * np.array([w, h])
    boxes = np.concatenate([xy, np.minimum(xy + size, [w - 1, h - 1]),
                            np.zeros((b, g, 2))], -1).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[:, -1] = False
    labels = (np.arange(g)[None].repeat(b, 0) % 2 + 1).astype(np.int32)
    batch = {"imgs": rng.randn(b, 3, *shape).astype(np.float32),
             "gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}
    if type_name in TWO_D_MASKED:
        masks = np.zeros((b, g, 1, h, w), np.uint8)
        for i in range(b):
            for j in range(g):
                x1, y1, x2, y2 = np.round(boxes[i, j, :4]).astype(int)
                masks[i, j, 0, y1 + 1:y2, x1 + 1:x2] = 1
        batch["gt_masks"] = masks
    if type_name == "HybridTaskCascade":
        seg = np.zeros((b, 1, h, w), np.int32)
        for i in range(b):
            for j in range(g - 1):
                seg[i][batch["gt_masks"][i, j] > 0] = labels[i, j]
        seg[:, :, 0] = 255
        batch["gt_semantic_seg"] = seg
    return batch


def small_run(det, batch, scale=1.0):
    """The small pipeline on `det`'s device; numpy outputs."""
    import torch

    tb = {k: torch.from_numpy(v).to(det.device) for k, v in batch.items()}
    for k in ("imgs", "imgs_2", "imgs_3"):
        if k in tb:
            tb[k] = tb[k] * scale
    out = det.simple_test(tb)
    return {k: v.cpu().numpy() for k, v in out.items()}


def compare_outputs(a, b, atol, what):
    """valid and labels equal; dets, mask logits and parcellation scores
    (those the outputs hold) of valid rows within atol, and the
    parcellations' arg-max equal.  Returns the largest difference."""
    import numpy as np

    if set(a) != set(b):
        raise AssertionError(f"{what}: outputs {sorted(a)} against "
                             f"{sorted(b)}")
    for key in ("valid", "labels"):
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"{what}: {key} differ")
    v = a["valid"].reshape(-1)
    if "parcellations" in a:
        arg = [x["parcellations"].reshape(len(v), -1)[v].argmax(-1)
               for x in (a, b)]
        if not np.array_equal(*arg):
            raise AssertionError(f"{what}: parcellation arg-max differ")
    err = 0.0
    for key in ("dets", "mask_logits", "parcellations"):
        if key not in a:
            continue
        rows, other = (x[key].reshape(len(v), -1) for x in (a, b))
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
    nccl = [(e - s) / 1e3 for s, e, name in spans if "nccl" in name.lower()]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the operator that launched each kernel, with its input shapes
    ops = sorted(
        prof.key_averages(group_by_input_shape=True),
        key=lambda a: -a.self_device_time_total,
    )[:top]
    return dict(
        kernels=len(spans), busy_ms=busy / 1e3, span_ms=span_ms,
        idle_share=1.0 - busy / 1e3 / span_ms, port_kernels_ms=port_ms,
        nccl_kernels=len(nccl), nccl_ms=sum(nccl),
        top_kernels_ms=[[name[:80], ms] for name, ms in ranked],
        top_ops_ms=[[a.key, str(a.input_shapes)[:120], a.count,
                     a.self_device_time_total / 1e3] for a in ops],
    )


# ---------------------------------------------------------------------------
# phase 7: one small train step, card against CPU
# ---------------------------------------------------------------------------


class SampleRecorder:
    """Within the block, records every anchor target (sampled, or the
    focal head's) and R-CNN sample that forward_train makes (on the
    CPU), by wrapping the three functions in the pipeline's namespace."""

    def __enter__(self):
        from mrcnn3d_torch.detectors import pipeline

        self.made = {"anchor_target_single": [], "sample_rcnn_single": [],
                     "anchor_target_focal_single": []}
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


class PoolArgmax:
    """Within the block, every max-pool module of `model` (ResNet3D's and
    ResNeXt3D's stem pool, 3x3x3 or the 2-D (1, 3, 3) one, and UNet3D's
    2x2x2 pool at each of its three calls) returns its input gathered at
    a recorded argmax per window: its own (F.max_pool3d's indices), or,
    given another pass's record (`take`), that pass's, so that the
    pool's value and its gradient follow the other pass's choice.  A
    window whose argmax differs between the passes is a flip; it must
    be a tie: both choices' values, on this pass's input, within
    TIE_TOL of the call's largest input magnitude (`check_pool_ties`).
    Each call's flips are recorded with the worst window, its two
    values and the call's largest input."""

    def __init__(self, model, take=None):
        self.model = model
        self.take = take

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        self.indices, self.flips = [], []

        def gather(x, idx):
            out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            if x.is_contiguous(memory_format=torch.channels_last_3d):
                out = out.contiguous(memory_format=torch.channels_last_3d)
            return out

        def hook(mod, inp, out):
            x = inp[0]
            _, own = F.max_pool3d(x, mod.kernel_size, mod.stride,
                                  mod.padding, mod.dilation,
                                  ceil_mode=mod.ceil_mode,
                                  return_indices=True)
            i = len(self.indices)
            self.indices.append(own.detach().cpu())
            if self.take is None:
                return gather(x, own)
            if i >= len(self.take) or self.take[i].shape != own.shape:
                raise AssertionError("pool argmax: the passes differ in "
                                     f"their max-pool calls at call {i}")
            want = self.take[i].to(own.device)
            flip = want != own
            if bool(flip.any()):
                a = gather(x, own).detach()
                b = gather(x, want).detach()
                diff = torch.where(flip, (a - b).abs(),
                                   torch.zeros((), dtype=a.dtype,
                                               device=a.device))
                w = int(diff.flatten().argmax())
                self.flips.append(dict(
                    call=i, shape=list(x.shape), windows=int(flip.sum()),
                    window=[int(v) for v in torch.unravel_index(
                        torch.tensor(w), tuple(own.shape))],
                    own_max=float(a.flatten()[w]),
                    other_choice=float(b.flatten()[w]),
                    max_abs_diff=float(diff.flatten()[w]),
                    call_max_abs_input=float(x.detach().abs().max())))
            return gather(x, want)

        self._hooks = [m.register_forward_hook(hook)
                       for m in self.model.modules()
                       if isinstance(m, torch.nn.MaxPool3d)]
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        return False


def check_pool_ties(flips, what):
    """Every max-pool window whose argmax differs between the passes is
    a tie (the rule of check_relu_ties): otherwise fail, naming the
    call, the window and both values."""
    for f in flips:
        if not f["max_abs_diff"] <= TIE_TOL * f["call_max_abs_input"]:
            raise AssertionError(f"{what}: a max-pool argmax differs off a "
                                 f"tie: {f}")


def small_train_step(device, cfg=None, batch=None, pools=None,
                     relus=None):
    """One train step of the narrow config (or `cfg`, on the numpy
    `batch`) on `device` from seed 0's
    weights and CountedDraws(7): (losses, {name: (update, parameter
    after the step)}, the recorded samples, the draws' counts, the stem's
    tensors, the PoolArgmax record), all on the CPU.  The update is the
    step's learning rate times SGD's momentum buffer, as the optimizer
    applies it (the parameter's own rounding would hide it at a step
    this small).  Every max-pool of the backbone runs under PoolArgmax:
    its own argmax, or with `pools` (another pass's record's indices)
    that pass's.  The stem's tensors, per input shape: the max-pool's
    input and the gradient that reaches the stem conv's output (UNet3D:
    the input of each of its 2x2x2 max-pools, and no stem conv)."""
    import torch

    from mrcnn3d_torch.entry import build_trainer

    trainer = build_trainer(cfg or small_train_config(), device=device,
                            seed=0)
    trainer.draws = CountedDraws(7)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in (batch or small_train_batch(3)).items()}
    backbone = trainer.model.backbone
    pool = getattr(backbone, "maxpool", None) or backbone.pool
    stem = {"pool_in": {}, "conv_grad": {},
            "pool": (pool.kernel_size, pool.stride, pool.padding)}

    def on_conv(mod, inp, out):
        key = tuple(out.shape)
        out.register_hook(lambda g: stem["conv_grad"].__setitem__(
            key, g.detach().cpu()))

    def on_pool(mod, inp, out):
        stem["pool_in"][tuple(inp[0].shape)] = inp[0].detach().cpu()

    hooks = [pool.register_forward_hook(on_pool)]
    if hasattr(backbone, "conv1"):
        hooks.append(backbone.conv1.register_forward_hook(on_conv))
    with SampleRecorder() as rec, \
            PoolArgmax(trainer.model, pools) as argmax, \
            ReluBranches(relus) as branches:
        losses = trainer.step(batch)
    for h in hooks:
        h.remove()
    opt = trainer.state.optimizer
    lr = opt.param_groups[0]["lr"]
    updates = {n: ((lr * opt.state[p]["momentum_buffer"]).cpu(),
                   p.detach().cpu())
               for n, p in trainer.model.named_parameters()}
    return ({k: float(v) for k, v in losses.items()}, updates, rec.made,
            trainer.draws.highs, stem, argmax, branches)


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
        _, i_cpu = F.max_pool3d(x_cpu, *cpu_stem["pool"],
                                return_indices=True)
        _, i_gpu = F.max_pool3d(x_gpu, *cpu_stem["pool"],
                                return_indices=True)
        rec = out["x".join(map(str, shape[2:]))] = dict(
            pool_in_max_diff=float((x_gpu - x_cpu).abs().max()),
            argmax_flips=int((i_gpu != i_cpu).sum()), windows=i_cpu.numel())
        if shape in cpu_stem["conv_grad"]:
            g_cpu = cpu_stem["conv_grad"][shape]
            g_gpu = gpu_stem["conv_grad"][shape]
            rec.update(conv_grad_max_diff=float((g_gpu - g_cpu).abs().max()),
                       conv_grad_max=float(g_cpu.abs().max()))
    return out


# float entries of the recorded targets and samples: from boxes decoded
# (proposals) or encoded (deltas) in float32 on either device
SAMPLE_FLOATS = ("bbox_targets", "rois")
# parameter updates, card against CPU: within UPDATE_TOL of the CPU
# update's largest magnitude (PIPELINE_ATOL for a parameter it does not
# name).  The stem conv's weights sit under the stem max-pool and
# UNet3D's encoder convs under its 2x2x2 pools, whose argmax between two
# values equal to float32 rounding follows each device's convolution
# rounding; a flipped window routes its gradient to the neighbouring
# voxel, which moved the stem conv's update by about 1% of its largest
# before the CPU pass took the card's argmax (PoolArgmax, each flip
# proven a tie by check_pool_ties).  A relu whose input lies within
# rounding of 0 flips the same way: UNet3D's enc0/enc1 convs moved by
# 2.2e-3 and 3.4e-3 after the pool replay, and by under 4e-6 once the CPU
# pass also took the card's relu branches (ReluBranches, each unit proven
# a tie by check_relu_ties; one H100 run).  The phase reports the flips,
# the ties and the gradient they move (`stem_divergence`).
UPDATE_TOL = {}
# the same gradients held against the JAX package (the CPU tests): its
# max-pools cannot take the port's argmax, so a tie flipped between the
# packages keeps the stem conv (and UNet3D's encoder convs) at 2e-2
JAX_UPDATE_TOL = {"backbone.conv1.weight": 2e-2,
                  **dict.fromkeys((f"backbone.enc{i}_conv{j}.{k}"
                                   for i in range(3) for j in (0, 1)
                                   for k in ("weight", "bias")), 2e-2)}


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


def check_small_train(device, cfg=None, batch=None, what="small train"):
    """The narrow train step (or `cfg`'s on the numpy `batch`, as
    small_train_step) on the card against the CPU: every draw's
    count, anchor target and R-CNN sample equal (float boxes and deltas
    within PIPELINE_ATOL), the losses within PIPELINE_ATOL, each
    parameter's update within PIPELINE_ATOL of the CPU update's largest
    magnitude (UPDATE_TOL where it names one), and each parameter after
    the step within that and its own float32 spacing.  The CPU pass's
    max-pools take the card's argmax and its relus the card's branches,
    each window or unit where the two differ proven a tie (PoolArgmax
    and check_pool_ties, ReluBranches and check_relu_ties)."""
    import math

    import torch

    gpu = small_train_step(device, cfg, batch)
    cpu = small_train_step("cpu", cfg, batch, pools=gpu[5].indices,
                           relus=gpu[6].branches)
    check_pool_ties(cpu[5].flips, what)
    check_relu_ties(cpu[6].ties, what)
    made_err, loss_err = compare_samples(gpu, cpu, what)
    update_err = {}
    for name, (want, p_cpu) in cpu[1].items():
        got, p_gpu = gpu[1][name]
        scale = float(want.abs().max())
        tol = UPDATE_TOL.get(name, PIPELINE_ATOL) * scale
        e = float((got - want).abs().max())
        if not e <= tol:
            raise AssertionError(f"{what}: {name} update differs by "
                                 f"{e}, largest {scale}")
        # the parameters after the step: the same, plus the float32
        # spacing of each parameter (its rounding after the update)
        spacing = (torch.nextafter(p_cpu, torch.full_like(p_cpu, math.inf))
                   - p_cpu)
        if not bool(((p_gpu - p_cpu).abs() <= tol + spacing).all()):
            raise AssertionError(f"{what}: {name} after the step "
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
        pool_ties=dict(calls=len(cpu[5].indices), flips=cpu[5].flips),
        relu_ties=cpu[6].ties,
        tol=PIPELINE_ATOL, update_tol=UPDATE_TOL,
    )


# ---------------------------------------------------------------------------
# phase 8: the full-width train step
# ---------------------------------------------------------------------------


def train_batch(gen, device, scales=2, parcel=False):
    """bench.py's synthetic training batch (make_batch), NCDHW: per scale
    f = 1.0, 1.5 (2.25 for a third), random bf16 volumes of the crop
    times f; TRAIN_MAX_GT valid gt boxes per image with x1 = y1 ~ U(4,
    0.6 H), extent ~ U(8, 0.3 H), z from 2 to 14; labels 1; gt masks all
    ones at 1.0x; with `parcel`, brain regions ~ U{0..PARCELLATIONS-1}.
    The 1.5x boxes are the 1.0x boxes times 1.5, so both scales hold the
    same objects.  That departs from bench.py on purpose: bench.py maps
    the shared draws onto the 1.5x crop's own H before scaling by 1.5,
    so its 1.5x boxes are not its 1.0x boxes scaled."""
    import torch

    d, h, w = TRAIN_CROP
    b, g = TRAIN_BATCH, TRAIN_MAX_GT
    x1 = 4 + torch.rand((b, g, 1), generator=gen, device=device) \
        * (h * 0.6 - 4)
    size = 8 + torch.rand((b, g, 1), generator=gen, device=device) \
        * (h * 0.3 - 8)
    batch = {}
    for s in range(scales):
        f = 1.5 ** s
        sfx = ("", "_2", "_3")[s]
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
    if parcel:
        batch["gt_bregions"] = torch.randint(
            0, PARCELLATIONS, (b, g), generator=gen, device=device,
            dtype=torch.int32)
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


def check_train_step_kernels(captured, names=None):
    """Each launch of one train step, on the arguments it was given
    there, against its plain version and timed alone.  Each backward
    launch takes the name of the forward launch whose rois it got.
    names: the forward launches' names (TRAIN_STEP_CALLS, the
    flagship's, by default)."""
    names = names or TRAIN_STEP_CALLS
    got = {k: len(v) for k, v in captured.calls.items()}
    want = {**{k: len(v) for k, v in names.items()},
            "roi_align3d_backward": len(names["roi_align3d"])}
    if got != want:
        raise AssertionError(f"launches in the captured train step: {got}, "
                             f"expected {want}")
    # a launch is known by its rois and its level count: HTC aligns the
    # same rois on the FPN and on the one-level semantic map
    by_rois = {(args[1].data_ptr(), len(args[0])): name for name, args in
               zip(names["roi_align3d"], captured.calls["roi_align3d"])}
    if len(by_rois) != len(names["roi_align3d"]):
        raise AssertionError("two K2 launches of the step share their rois "
                             "and level count")
    back = [(by_rois[(args[2].data_ptr(), len(args[1]))], args)
            for args in captured.calls["roi_align3d_backward"]]
    if sorted(n for n, _ in back) != sorted(names["roi_align3d"]):
        raise AssertionError("K2 backward launches do not match the "
                             "forward launches one to one")
    import torch

    # the recorded levels are activations that require a gradient
    with torch.no_grad():
        return {
            "nms3d": [nms_case(name, *args) for name, args in
                      zip(names["nms3d"], captured.calls["nms3d"])],
            "roi_align3d": [align_case(name, args) for name, args in
                            zip(names["roi_align3d"],
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
    for bit, the volumes NCDHW in channels_last_3d storage.  Returns what
    was checked."""
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
                imgs_2=list(batch["imgs_2"].shape))


class PlainKernels:
    """Within the block, the kernels' wrappers (those named in `wrappers`,
    all by default) run their plain PyTorch versions (on the card's
    tensors, uncounted)."""

    SWAPS = (("nms3d", "greedy_scan_cuda", "greedy_scan_plain"),
             ("roi_align3d", "roi_align_3d_cuda", "roi_align_3d_plain"),
             ("roi_align3d", "roi_align_3d_backward_cuda",
              "roi_align_3d_backward_plain"))

    def __init__(self, wrappers=None):
        self.wrappers = wrappers

    def __enter__(self):
        from mrcnn3d_torch.ops import nms3d, roi_align3d

        mods = {"nms3d": nms3d, "roi_align3d": roi_align3d}
        self._saved = []
        for name, attr, plain in self.SWAPS:
            if self.wrappers is not None and attr not in self.wrappers:
                continue
            mod = mods[name]
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, getattr(mod, plain))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


class ReluBranches:
    """Within the block, every `torch.relu` of the port's model records
    its branch per unit (input > 0), in call order; given the branches
    of another pass (`take`), each call takes those where its own
    differ: the output is the input where the other pass's branch is
    on, else 0 (its gradient likewise).  Such units are ties: a unit
    whose input lies within rounding of 0 takes either branch by
    rounding, and both are right to rounding.  Every tie's input is
    recorded, against the largest magnitude of its call's input, so
    that a unit which is not a tie shows."""

    def __init__(self, take=None):
        self.take = take

    def __enter__(self):
        import torch

        self.branches, self.ties = [], []
        self._relu = relu = torch.relu

        def branch(x):
            on = x > 0
            i = len(self.branches)
            self.branches.append(on)
            if self.take is None:
                return relu(x)
            if i >= len(self.take) or self.take[i].shape != on.shape:
                raise AssertionError("relu branches: the passes differ in "
                                     f"their relu calls at call {i}")
            want = self.take[i].to(on.device)
            tie = want != on
            if bool(tie.any()):
                mag = x.detach().abs()
                self.ties.append(dict(
                    call=i, shape=list(x.shape), units=int(tie.sum()),
                    max_abs_input=float(mag[tie].max()),
                    call_max_abs_input=float(mag.max())))
            return torch.where(want, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))

        torch.relu = branch
        return self

    def __exit__(self, *exc):
        import torch

        torch.relu = self._relu
        return False


def learn_gradients(state, batch, plain, branches=None):
    """forward_train and its backward with the weights `state` holds, on
    `batch`, the samplers drawing from CountedDraws(LEARN_SEED); with
    `plain`, the plain versions in place of the kernels (True: all of
    them; a tuple: the wrappers it names, as PlainKernels); with
    `branches` (a ReluBranches' record), every relu takes those branches
    at its ties.  Returns (losses, {parameter: gradient}, the recorded
    samples, the draws' counts, the ReluBranches of the pass), on the
    CPU but the last; the parameters' gradients are cleared."""
    import contextlib

    from mrcnn3d_torch.detectors.pipeline import forward_train, scale_shapes

    model = state.model
    sets = state.anchor_sets(scale_shapes(model, batch))
    model.zero_grad(set_to_none=True)
    draws = CountedDraws(LEARN_SEED)
    swap = (PlainKernels(None if plain is True else plain) if plain
            else contextlib.nullcontext())
    relus = ReluBranches(branches)
    with SampleRecorder() as rec, swap, relus:
        total, losses = forward_train(model, batch, state.cfg, sets, draws)
        total.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            rec.made, draws.highs, relus)


def _grad_errors(got, want):
    """{parameter: (largest difference, largest magnitude of want)}."""
    if set(got) != set(want):
        raise AssertionError("learn gradients: different parameters")
    return {name: (float((got[name] - w).abs().max()), float(w.abs().max()))
            for name, w in want.items()}


def _worst_by_module(errors):
    out = {}
    for name, (e, scale) in errors.items():
        mod = name.split(".")[0]
        out[mod] = max(out.get(mod, 0.0), e / scale if scale else 0.0)
    return out


# a relu unit whose branch differs between the kernel pass and the plain
# pass is a tie when its input lies within TIE_TOL of its call's largest
# input: K2's own float32 gate, so that the flips a K2 difference within
# that gate can cause are ties and a larger one fails (PERF.md §6, PR 7)
TIE_TOL = ALIGN_TOL["float32"]


def check_relu_ties(ties, what):
    """Every unit where the passes' relu branches differ is a tie."""
    for tie in ties:
        if not tie["max_abs_input"] <= TIE_TOL * tie["call_max_abs_input"]:
            raise AssertionError(f"{what}: a relu's branches differ off a "
                                 f"tie: {tie}")


class AlignAgainstPlain:
    """Within the block, every launch of K2's forward is held against its
    plain version on the same arguments (`check_align_output`, K2's own
    gate); the largest error is kept in `max_abs_err`."""

    def __enter__(self):
        from mrcnn3d_torch.ops import roi_align3d as ra

        self.launches, self.max_abs_err = 0, 0.0
        self._fn = fn = ra.roi_align_3d_cuda

        def checked(*args):
            import torch

            got = fn(*args)
            with torch.no_grad():
                want = ra.roi_align_3d_plain(*args)
            err, _ = check_align_output(got, want, "K2 in the learn check")
            self.launches += 1
            self.max_abs_err = max(self.max_abs_err, err)
            return got

        ra.roi_align_3d_cuda = checked
        return self

    def __exit__(self, *exc):
        from mrcnn3d_torch.ops import roi_align3d as ra

        ra.roi_align_3d_cuda = self._fn
        return False


class PinnedCudnn:
    """Within the block, cuDNN takes its deterministic algorithms by its
    heuristics instead of the fastest by timing (`cudnn.benchmark`): the
    same algorithms in every pass and every run, whatever an earlier
    phase timed; the flags are restored after."""

    def __enter__(self):
        import torch

        cudnn = torch.backends.cudnn
        self._saved = (cudnn.benchmark, cudnn.deterministic)
        cudnn.benchmark, cudnn.deterministic = False, True
        return self

    def __exit__(self, *exc):
        import torch

        cudnn = torch.backends.cudnn
        cudnn.benchmark, cudnn.deterministic = self._saved
        return False


def attribute_gradient_error(state, batch, kern, name):
    """Where a parameter's gradient through the kernels and through their
    plain versions differ: `name`'s largest difference from the kernel
    pass `kern` (learn_gradients' record) when only one kernel runs its
    plain version (each in turn, on the kernel pass's relu branches), and
    when the kernel pass is run again, each over the kernel pass's
    largest magnitude."""
    scale = float(kern[1][name].abs().max()) or 1.0
    out = {}
    for _, attr, _ in PlainKernels.SWAPS:
        g = learn_gradients(state, batch, plain=(attr,),
                            branches=kern[4].branches)[1][name]
        out[f"only {attr} plain"] = float((g - kern[1][name]).abs().max()) \
            / scale
    g = learn_gradients(state, batch, plain=False)[1][name]
    out["kernel pass again"] = float((g - kern[1][name]).abs().max()) / scale
    return out


def check_learn_gradients(state, batches):
    """The trained detector's gradients on each of `batches` (the
    loader's first epoch), through the kernels against through their
    plain versions, on the card, from the same draws, with cuDNN pinned
    to the same deterministic algorithms in both passes (`PinnedCudnn`),
    so that the kernels are all the passes differ by.  Every K2 forward
    launch of the kernel pass is held against its plain version on its
    own arguments (`AlignAgainstPlain`).  K2's forward differs from its
    plain version in the last bits, so a relu whose input lies within
    rounding of 0 may take the other branch in the other pass; after
    training the mask heads' gradients rest on few rois, and one such
    unit can move a parameter's gradient by more than PIPELINE_ATOL of
    its largest (PERF.md §6).  So the plain pass takes the kernel pass's
    branch at those ties (`ReluBranches`), each of which must be one
    (`check_relu_ties`).  Then every draw's count and sample equal, the
    losses within PIPELINE_ATOL, and each parameter's gradient within
    PIPELINE_ATOL of the plain gradient's largest magnitude; a parameter
    past it fails with `attribute_gradient_error`'s reading.  Reports, a
    batch, the ties by call, the largest relative error of each module
    and K2's largest forward error."""
    out = []
    with PinnedCudnn():
        for i, batch in enumerate(batches):
            what = f"learn gradients, batch {i}"
            with AlignAgainstPlain() as aligns:
                kern = learn_gradients(state, batch, plain=False)
            if not aligns.launches:
                raise AssertionError(f"{what}: no K2 launch")
            plain = learn_gradients(state, batch, plain=True,
                                    branches=kern[4].branches)
            made_err, loss_err = compare_samples(kern[:4], plain[:4], what)
            check_relu_ties(plain[4].ties, what)
            errors = _grad_errors(kern[1], plain[1])
            for name, (e, scale) in errors.items():
                if not e <= PIPELINE_ATOL * scale:
                    raise AssertionError(
                        f"{what}: {name} differs by {e}, largest {scale}; "
                        f"relu ties {plain[4].ties}; K2's largest forward "
                        f"error {aligns.max_abs_err}; relative to the "
                        "kernel pass: "
                        f"{attribute_gradient_error(state, batch, kern, name)}")
            out.append(dict(
                losses=kern[0], max_loss_err=loss_err,
                positives=[h for site, _, h in plain[3] if site[-1] == "pos"],
                max_sample_float_err=made_err, relu_ties=plain[4].ties,
                align_launches=aligns.launches,
                align_max_abs_err=aligns.max_abs_err,
                worst_grad_rel_err_by_module=_worst_by_module(errors)))
    return dict(batches=out, tie_tol=TIE_TOL, tol=PIPELINE_ATOL,
                align_tol=ALIGN_TOL["float32"])


def learn_epoch(cfg, data, device):
    """The learning run's loader's first epoch (seed LEARN_SEED), one
    batch a train volume, on `device`."""
    from mrcnn3d_torch.data.loader import Prefetcher
    from mrcnn3d_torch.tools.learning_bench import train_dataset

    loader = Prefetcher(train_dataset(cfg, data[1], data[2], LEARN_SEED), 1,
                        seed=LEARN_SEED, num_workers=1, device=device)
    try:
        return list(loader)
    finally:
        loader.close()


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
    each batch of the loader's first epoch through the kernels against
    through the plain versions.  Returns (the phase's record, the data,
    the checked launches).  cfg / geometry replace the flagship and the
    pinned data (the CPU rehearsal)."""
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
    out["first_batch"] = check_first_batch(cfg, data, device)
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
    out["gradients"] = check_learn_gradients(
        state, learn_epoch(cfg, data, device))
    out["checks_s"] = time.perf_counter() - t
    del state

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
# the comparison serves the top SERVE_MAX_DETS rows a volume at any
# score: it then has rows whatever score 200 iterations reach (the
# config's score_thr 0.2 left none in one run of eight)
SERVE_MAX_DETS = 32


def serve_config(cfg):
    """A copy of `cfg` whose rcnn stage keeps the top SERVE_MAX_DETS rows
    a volume at any score."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg.test_cfg["rcnn"]["score_thr"] = 0.0
    cfg.test_cfg["rcnn"]["max_per_img"] = SERVE_MAX_DETS
    return cfg


def served_against(out_dir, cfg, model, ds):
    """Each volume's json under `out_dir` against run_inference's rows
    for it under `cfg` (same counts, PIPELINE_ATOL): (the largest
    difference, the rows compared)."""
    import numpy as np

    from mrcnn3d_torch.apis.test_api import run_inference

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
    return err, n


def run_serve(device, workdir, data, cfg=None):
    """apis.serve.watch with the checkpoint `learn` left over an in-dir
    holding the val volumes (stop_after=SERVE_VOLUMES), at the config,
    timed, the counters zeroed just before and read just after; each
    volume's json against run_inference's rows for it (same counts,
    PIPELINE_ATOL).  Both run the same detector (`InferenceRunner.
    simple_test`), so this holds the serving loop's file IO and its
    host-side twin against the dataset's, not the detector against a
    reference (the JAX comparison is the CPU test's); the detector's
    launches on this path, those of the last served volume, are recorded
    and each checked against its plain version.  The config's score_thr
    may leave a short-trained detector no row, so the volumes are then
    served again, untimed, under `serve_config` (the top SERVE_MAX_DETS
    rows at any score) and held against run_inference under it: that
    comparison has rows by construction.  Returns (the phase's record,
    the checked launches)."""
    import shutil

    from mrcnn3d_torch.apis.serve import watch
    from mrcnn3d_torch.apis.test_api import InferenceRunner, load_detector
    from mrcnn3d_torch.tools.common import test_dataset
    from mrcnn3d_torch.utils.config import Config

    cfg = cfg or Config.fromfile(CONFIG)
    ann_va, dir_va = data[3:5]
    te = cfg.data["test"]
    ds = test_dataset(te, ann_va, dir_va)
    in_dir = os.path.join(workdir, "serve_in")
    os.makedirs(in_dir)
    for info in ds.img_infos:
        shutil.copy(os.path.join(dir_va, info["file_name"]), in_dir)
    model, step = load_detector(cfg, workdir, device)

    def serve(cfg, out_dir, timers=None):
        watch(InferenceRunner(cfg, model), in_dir, out_dir,
              te["img_norm_cfg"], size_divisor=te.get("size_divisor", 32),
              poll_s=0.05, stop_after=SERVE_VOLUMES, timers=timers)

    timers = {}
    out_dir = os.path.join(workdir, "serve_out")
    zero_counts()
    t = time.perf_counter()
    names = volume_calls(cfg.test_cfg)
    with Capture(keep=keep_last(names)) as captured:
        serve(cfg, out_dir, timers)
    wall = time.perf_counter() - t
    launches = kernel_counts()
    for name in ("nms3d", "roi_align3d"):
        if not launches[name]:
            raise AssertionError(f"serve: no {name} launch")
    err, n = served_against(out_dir, cfg, model, ds)
    wide = serve_config(cfg)
    wide_dir = os.path.join(workdir, "serve_out_top")
    serve(wide, wide_dir)
    wide_err, wide_n = served_against(wide_dir, wide, model, ds)
    if wide_n == 0:
        raise AssertionError("serve: no detections, vacuous")
    calls = check_launches(captured, names, "served volume")
    return dict(volumes=SERVE_VOLUMES, checkpoint_step=step,
                watch_s=wall, seconds_per_volume=wall / SERVE_VOLUMES,
                volume_s=timers["volume_s"], detections=n,
                max_abs_err=max(err, wide_err), top_detections=wide_n,
                max_dets_per_volume=SERVE_MAX_DETS, tol=PIPELINE_ATOL,
                launches=launches), calls


# ---------------------------------------------------------------------------
# phase 15: the 3-D two-stage variants
# ---------------------------------------------------------------------------


# launches a step, read from the pipeline (detectors/pipeline.py): (K1,
# K2) an inference step with masks on -- one K1 per scale's proposals
# and one for the class-wise NMS, one K2 per scale's bbox align, the
# refinement and the mask stage; (K1, K2, K2's backward) a train step --
# one K1 per scale's proposals, one K2 (and its backward) per scale's
# bbox align, the refinement, the mask and the refinement mask.  RPN3D
# makes no proposals in training (`mrcnn3d/detectors/pipeline.py:617-620`)
VARIANT_LAUNCHES = {
    "RPN3D": ((1, 0), (0, 0, 0)),
    "FasterRCNN3D": ((2, 1), (1, 1, 1)),
    "MaskRCNN3D": ((2, 2), (1, 2, 2)),
    "MaskRCNN3DParcel": ((2, 2), (1, 2, 2)),
    "MaskRCNN3D2ScalesHeads": ((3, 3), (2, 3, 3)),
    "MaskRCNN3D2ScalesHeadsRefinementHead": ((3, 3), (2, 3, 3)),
    "MaskRCNN3D3ScalesHeads": ((4, 4), (3, 4, 4)),
    "MaskRCNN3D3ScalesOnePathway": ((4, 4), (3, 4, 4)),
    "MaskRCNN3D2ScalesOnePathwayOneRPN": ((3, 4), (2, 5, 5)),
}
# a three-scale inference step's third volume: 2.25x the headline's
VARIANT_MAIN_SHAPES = MAIN_SHAPES + [(144, 1152, 1152)]
# the types whose full-width launches are recorded and checked alone
VARIANT_CHECKED = ("MaskRCNN3D", "MaskRCNN3D3ScalesHeads")
SCALE_NAMES = ("1.0x", "1.5x", "2.25x")


def variant_calls(type_name, train):
    """The names of one step's K1 and K2 launches of a type, in the
    order the pipeline makes them (masks on)."""
    from mrcnn3d_torch.detectors.build import detector_flags

    f = detector_flags(variant_recipe(main_config(), type_name))
    scales = SCALE_NAMES[:f["num_scales"]]
    if not f["with_bbox"]:
        return {"nms3d": [] if train else ["proposals_1.0x"],
                "roi_align3d": []}
    align = [f"bbox_{x}" for x in scales]
    if f["with_refinement"]:
        align.append("refinement_1.0x")
    if f["with_mask"]:
        align.append("mask_1.0x")
        if train and f["with_refinement_mask"]:
            align.append("mask_refinement_1.0x")
    nms = [f"proposals_{x}" for x in scales]
    return {"nms3d": nms if train else nms + ["classwise"],
            "roi_align3d": align}


def variant_per_step(type_name):
    """VARIANT_LAUNCHES of a type as counter dicts (inference, train),
    checked against the launches `variant_calls` reads from the code."""
    (k1, k2), (t1, t2, tb) = VARIANT_LAUNCHES[type_name]
    infer = {"nms3d": k1, "roi_align3d": k2}
    train = {"nms3d": t1, "roi_align3d": t2, "roi_align3d_backward": tb}
    for per_step, is_train in ((infer, False), (train, True)):
        calls = variant_calls(type_name, is_train)
        got = {k: len(v) for k, v in calls.items()}
        if is_train:
            got["roi_align3d_backward"] = got["roi_align3d"]
        if got != per_step:
            raise AssertionError(f"{type_name}: the pipeline makes {got} "
                                 f"launches a step, the table {per_step}")
    return infer, train


def _check_counts(launches, per_step, steps, what):
    for name, count in per_step.items():
        if launches[name] != count * steps:
            raise AssertionError(f"{what}: {name} {launches[name]} launches "
                                 f"in {steps} steps, expected {count} a step")


def check_small_variant(device, type_name):
    """A variant at the narrow widths (budgets 64) on the card against
    the CPU: its inference (valid, labels and the parcellations' arg-max
    equal; dets, mask logits and parcellation scores within
    PIPELINE_ATOL) and one train step as check_small_train holds it;
    the card's launches, one step each, as VARIANT_LAUNCHES says."""
    from mrcnn3d_torch.entry import build

    infer, train = variant_per_step(type_name)
    cfg = variant_recipe(small_config(), type_name)
    gpu = build(cfg, device=device, budgets=SMALL_BUDGET)
    cpu = build(cfg, device="cpu", budgets=SMALL_BUDGET)
    scales = gpu.model.num_scales
    batch = variant_inputs(7, scales)
    zero_counts()
    a = small_run(gpu, batch)
    _check_counts(kernel_counts(), infer, 1, f"small {type_name}")
    err = compare_outputs(a, small_run(cpu, batch), PIPELINE_ATOL,
                          f"small {type_name}")
    n = int(a["valid"].sum())
    if n == 0:
        raise AssertionError(f"small {type_name}: no detections, vacuous")
    tb = variant_train_batch(3, scales, gpu.model.num_parcellations > 0)
    zero_counts()
    trained = check_small_train(
        device, variant_recipe(small_train_config(), type_name), tb,
        f"small train {type_name}")
    _check_counts(kernel_counts(), train, 1, f"small train {type_name}")
    return dict(detections=n, max_abs_err=err,
                outputs=sorted(a), train=trained)


def _timed(step, per_step, steps, what):
    """1 warm-up and `steps` timed calls of `step`, the counters zeroed
    just before and read just after the timed ones, the peak memory."""
    import numpy as np
    import torch

    from mrcnn3d_torch.ops import roi_align3d

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last = step()
    torch.cuda.synchronize()
    zero_counts()
    roi_align3d.reset_path_counts()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        last = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _check_counts(kernel_counts(), per_step, steps, what)
    return last, dict(
        step_s=walls, median_step_s=float(np.median(walls)),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_per_step=per_step,
        k2_rois_by_path=roi_align3d.path_counts())


def _check_result(res, name):
    """A full-width step's outputs: at least one detection and every
    output but valid and labels finite; returns their record."""
    import torch

    n_det = int(res["valid"].sum())
    if n_det == 0:
        raise AssertionError(f"{name}: no detections at full width")
    for key, v in res.items():
        if key not in ("valid", "labels") and \
                not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"{name}: non-finite {key}")
    return dict(detections=n_det, outputs=sorted(res),
                shapes={k: list(v.shape) for k, v in res.items()})


def run_variant(device, type_name, steps=3, record=False):
    """A variant at full width, bf16, every budget 2000, masks on: its
    inference on the bench.py headline geometry (a 144x1152x1152 third
    volume for three scales) and its train step at bench.py's training
    geometry (batch 2, the third pathway at 2.25x); each 1 warm-up and
    `steps` timed, the counters zeroed just before and read just after
    the timed ones, the peak memory of each.  record: one more step of
    each whose launches are recorded.  Returns (the record, the captured
    inference step, the captured train step)."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build, build_trainer

    infer, train = variant_per_step(type_name)
    torch.backends.cudnn.benchmark = True
    cfg = variant_recipe(main_config(), type_name)
    det = build(cfg, device=device, dtype=torch.bfloat16,
                budgets=MAIN_BUDGET, seed=0)
    model = det.model
    gen = torch.Generator(device=device).manual_seed(11)
    batch = {"imgs" + ("", "_2", "_3")[s]: torch.randn(
        (1, 3, *VARIANT_MAIN_SHAPES[s]), generator=gen, device=device).to(
            torch.bfloat16) for s in range(model.num_scales)}
    out = {}
    res, out["inference"] = _timed(lambda: det.simple_test(batch), infer,
                                   steps, f"{type_name} inference")
    out["inference"].update(_check_result(res, type_name))
    captured = None
    if record:
        with Capture() as captured:
            det.simple_test(batch)
        torch.cuda.synchronize()
    del det, batch, res

    trainer = build_trainer(cfg, device=device, seed=0,
                            compute_dtype=torch.bfloat16)
    tb = train_batch(torch.Generator(device=device).manual_seed(17), device,
                     model.num_scales, model.num_parcellations > 0)
    losses, out["train"] = _timed(lambda: trainer.step(tb), train, steps,
                                  f"{type_name} train")
    losses = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{type_name} train: non-finite {losses}")
    out["train"].update(losses_last=losses, batch=TRAIN_BATCH,
                        volumes_per_s=TRAIN_BATCH
                        / out["train"]["median_step_s"])
    train_captured = None
    if record:
        with Capture(tuple(TRAIN_PER_STEP)) as train_captured:
            trainer.step(tb)
        torch.cuda.synchronize()
    return out, captured, train_captured


def run_variants(device):
    """Phase 15: every variant's small check, card against CPU, then
    each at full width; the launches of VARIANT_CHECKED's steps each
    checked alone against the plain versions (as phases 6 and 9).
    Returns (the per-type records, the checked launches by type)."""
    import torch

    records, checks = {}, {}
    for type_name in VARIANTS:
        t = time.perf_counter()
        rec = {"small": check_small_variant(device, type_name)}
        checked = type_name in VARIANT_CHECKED
        full, cap, train_cap = run_variant(device, type_name,
                                           record=checked)
        rec.update(full)
        if checked:
            with torch.no_grad():
                checks[type_name] = {
                    "inference": check_launches(
                        cap, variant_calls(type_name, False),
                        f"{type_name} step"),
                    "train": check_train_step_kernels(
                        train_cap, variant_calls(type_name, True)),
                }
            del cap, train_cap
        rec["seconds"] = time.perf_counter() - t
        records[type_name] = rec
        torch.cuda.empty_cache()
    return records, checks


# ---------------------------------------------------------------------------
# phase 16: the single-stage and cascade families
# ---------------------------------------------------------------------------


# launches a step, read from the pipeline (detectors/pipeline.py): (K1,
# K2) an inference step -- RetinaNet3D one class-wise K1 over every
# level's decoded rows; a cascade one K1 for the proposals and one for
# the class-wise NMS, one K2 per stage's bbox align, HTC one more per
# stage on the semantic map and, with masks, the mask align on the FPN
# and on the semantic map.  (K1, K2, K2's backward) a train step --
# RetinaNet3D makes no proposals and aligns nothing; a cascade one K1
# for the proposals and one K2 per stage, HTC four per stage (bbox and
# mask, each on the FPN and on the semantic map)
FAMILY_LAUNCHES = {
    "RetinaNet3D": ((1, 0), (0, 0, 0)),
    "CascadeRCNN3D": ((2, 3), (1, 3, 3)),
    "HybridTaskCascade3D": ((2, 8), (1, 12, 12)),
}
# the types whose full-width launches are recorded and checked alone
# (inference: both; train: HTC, RetinaNet's train step launches nothing)
FAMILY_CHECKED = ("RetinaNet3D", "HybridTaskCascade3D")


def pipeline_calls(cfg, train, proposals_given=False):
    """The names of one step's K1 and K2 launches of `cfg`'s type, in
    the order the pipeline makes them, read from its flags: a
    single-stage type's class-wise K1 (none in training), an RPN-only
    type's proposals, a cascade's per-stage aligns (HTC's semantic ones
    beside them), a one-scale two-stage type's bbox and mask aligns.
    proposals_given: inference on precomputed proposals (FastRCNN), no
    proposal K1."""
    from mrcnn3d_torch.detectors.build import detector_flags

    f = detector_flags(cfg)
    if f["single_stage"]:
        return {"nms3d": [] if train else ["classwise"], "roi_align3d": []}
    if not f["with_bbox"]:
        return {"nms3d": [] if train else ["proposals"], "roi_align3d": []}
    nms = [] if proposals_given and not train else ["proposals"]
    if not f["cascade_stages"]:
        align = ["bbox"] + (["mask"] if f["with_mask"] else [])
        return {"nms3d": nms if train else nms + ["classwise"],
                "roi_align3d": align}
    sem = f["with_semantic"]
    fusion = cfg.model.get("semantic_fusion", ("bbox", "mask"))
    masks = f["with_mask"] and f["htc"]
    align = []
    for t in range(f["cascade_stages"]):
        align.append(f"bbox_s{t}")
        if sem and "bbox" in fusion:
            align.append(f"semantic_bbox_s{t}")
        if train and masks:
            align.append(f"mask_s{t}")
            if sem and "mask" in fusion:
                align.append(f"semantic_mask_s{t}")
    if not train and masks:
        align.append("mask")
        if sem and "mask" in fusion:
            align.append("semantic_mask")
    return {"nms3d": nms if train else nms + ["classwise"],
            "roi_align3d": align}


def family_calls(type_name, train):
    """The names of one step's K1 and K2 launches of a family, in the
    order the pipeline makes them, read from its config's flags."""
    return pipeline_calls(family_config(type_name), train)


def family_per_step(type_name):
    """FAMILY_LAUNCHES of a type as counter dicts (inference, train),
    checked against the launches `family_calls` reads from the code."""
    (k1, k2), (t1, t2, tb) = FAMILY_LAUNCHES[type_name]
    infer = {"nms3d": k1, "roi_align3d": k2}
    train = {"nms3d": t1, "roi_align3d": t2, "roi_align3d_backward": tb}
    for per_step, is_train in ((infer, False), (train, True)):
        got = {k: len(v) for k, v in family_calls(type_name,
                                                  is_train).items()}
        if is_train:
            got["roi_align3d_backward"] = got["roi_align3d"]
        if got != per_step:
            raise AssertionError(f"{type_name}: the pipeline makes {got} "
                                 f"launches a step, the table {per_step}")
    return infer, train


def check_small_family(device, type_name):
    """A family at the narrow widths (budgets 64) on the card against the
    CPU: its inference (valid and labels equal; dets and mask logits
    within PIPELINE_ATOL) and one train step as check_small_train holds
    it; the card's launches, one step each, as FAMILY_LAUNCHES says."""
    from mrcnn3d_torch.entry import build

    infer, train = family_per_step(type_name)
    cfg = family_narrow(family_config(type_name), SMALL_BUDGET)
    gpu = build(cfg, device=device)
    cpu = build(cfg, device="cpu")
    batch = variant_inputs(7, 1)
    zero_counts()
    a = small_run(gpu, batch)
    _check_counts(kernel_counts(), infer, 1, f"small {type_name}")
    err = compare_outputs(a, small_run(cpu, batch), PIPELINE_ATOL,
                          f"small {type_name}")
    n = int(a["valid"].sum())
    if n == 0:
        raise AssertionError(f"small {type_name}: no detections, vacuous")
    zero_counts()
    trained = check_small_train(device, cfg, family_train_batch(3, type_name),
                                f"small train {type_name}")
    _check_counts(kernel_counts(), train, 1, f"small train {type_name}")
    return dict(detections=n, max_abs_err=err, outputs=sorted(a),
                train=trained)


def semantic_seg(batch):
    """HTC's gt_semantic_seg for bench.py's training batch, at full
    resolution: class 1 on the voxels of each gt's mask inside its box,
    0 elsewhere (the semantic loss resizes it nearest to its grid)."""
    import torch

    masks = batch["gt_masks"].bool()
    b, g, d, h, w = masks.shape
    dev = masks.device
    boxes = batch["gt_boxes"]
    z = torch.arange(d, device=dev)[:, None, None]
    y = torch.arange(h, device=dev)[None, :, None]
    x = torch.arange(w, device=dev)[None, None, :]
    seg = torch.zeros((b, d, h, w), dtype=torch.int32, device=dev)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2, z1, z2 = boxes[i, j].tolist()
            inside = ((x >= x1) & (x <= x2) & (y >= y1) & (y <= y2)
                      & (z >= z1) & (z <= z2))
            seg[i][inside & masks[i, j]] = 1
    return seg


def run_family(device, type_name, steps=3, record=False):
    """A family at full width from its config (its own budgets, masks on
    for HTC), bf16: inference on the headline 1.0x volume and the train
    step on bench.py's training geometry (batch 2, 16 gt with masks; for
    HTC a gt_semantic_seg from them), each 1 warm-up and `steps` timed,
    the counters zeroed just before and read just after the timed ones,
    the peak memory of each.  record: one more step of each whose
    launches are recorded.  Returns (the record, the captured inference
    step, the captured train step)."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build, build_trainer

    infer, train = family_per_step(type_name)
    torch.backends.cudnn.benchmark = True
    cfg = family_config(type_name)
    det = build(cfg, device=device, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=device).manual_seed(11)
    batch = {"imgs": torch.randn((1, 3, *MAIN_SHAPES[0]), generator=gen,
                                 device=device).to(torch.bfloat16)}
    out = {}
    res, out["inference"] = _timed(lambda: det.simple_test(batch), infer,
                                   steps, f"{type_name} inference")
    out["inference"].update(_check_result(res, type_name))
    b = cfg.test_cfg["rcnn"]["max_per_img"]
    if tuple(res["dets"].shape) != (1, b, 7) or \
            ("mask_logits" in res) != (type_name == "HybridTaskCascade3D"):
        shapes = {k: tuple(v.shape) for k, v in res.items()}
        raise AssertionError(f"{type_name}: outputs {shapes}")
    captured = None
    if record:
        with Capture() as captured:
            det.simple_test(batch)
        torch.cuda.synchronize()
    del det, batch, res

    trainer = build_trainer(cfg, device=device, seed=0,
                            compute_dtype=torch.bfloat16)
    tb = train_batch(torch.Generator(device=device).manual_seed(17), device,
                     scales=1)
    if type_name == "HybridTaskCascade3D":
        tb["gt_semantic_seg"] = semantic_seg(tb)
    losses, out["train"] = _timed(lambda: trainer.step(tb), train, steps,
                                  f"{type_name} train")
    losses = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{type_name} train: non-finite {losses}")
    out["train"].update(losses_last=losses, batch=TRAIN_BATCH,
                        volumes_per_s=TRAIN_BATCH
                        / out["train"]["median_step_s"])
    train_captured = None
    if record and any(train.values()):
        with Capture(tuple(TRAIN_PER_STEP)) as train_captured:
            trainer.step(tb)
        torch.cuda.synchronize()
    return out, captured, train_captured


def run_families(device):
    """Phase 16: each family's small check, card against CPU, then each at
    full width; the launches of FAMILY_CHECKED's steps each checked alone
    against the plain versions (as phases 6 and 9).  Returns (the
    per-type records, the checked launches by type)."""
    import torch

    records, checks = {}, {}
    for type_name in FAMILIES:
        t = time.perf_counter()
        rec = {"small": check_small_family(device, type_name)}
        checked = type_name in FAMILY_CHECKED
        full, cap, train_cap = run_family(device, type_name, record=checked)
        rec.update(full)
        if checked:
            with torch.no_grad():
                checks[type_name] = {"inference": check_launches(
                    cap, family_calls(type_name, False),
                    f"{type_name} step")}
                if train_cap is not None:
                    checks[type_name]["train"] = check_train_step_kernels(
                        train_cap, family_calls(type_name, True))
            del cap, train_cap
        rec["seconds"] = time.perf_counter() - t
        records[type_name] = rec
        torch.cuda.empty_cache()
    return records, checks


# ---------------------------------------------------------------------------
# phase 17: multicard
# ---------------------------------------------------------------------------

# N ranks' step against one process's over the global batch: each
# parameter's update and gradient, relative to that parameter's largest
MULTICARD_TOL = 1e-5
# the narrow world-2 runs: global batch, the depth-sharded inference's
# volumes (depths that shard over 2 ranks down to stage 3, and to stage 2)
MULTICARD_ROWS = 2
SHARDED_SHAPES = [(16, 32, 32), (24, 48, 48)]


class RecordDraws:
    """A draw source that records each draw by (site, n, high)."""

    def __init__(self, draws):
        self.draws = draws
        self.table = {}

    def __call__(self, site, n, high):
        r = self.draws(site, n, high)
        self.table[(tuple(site), n, int(high))] = r.cpu()
        return r


class ReplayDraws:
    """Replays a RecordDraws table; a draw it never saw (another site,
    count or bound) raises KeyError."""

    def __init__(self, table):
        self.table = table

    def __call__(self, site, n, high):
        return self.table[(tuple(site), n, int(high))].to(high.device)


def tensors(batch, device, dtype=None):
    """A numpy batch as tensors on `device`, its floating arrays in
    `dtype` if given."""
    import torch

    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in out.items()}
    return out


def step_record(trainer, batch, draws=None):
    """One train step: its losses and each parameter's update (the
    learning rate times SGD's momentum buffer), gradient (clipped) and
    value after the step, on the CPU.  draws: the trainer's own unless
    given."""
    from mrcnn3d_torch.train.step import train_step

    if draws is None:
        losses = trainer.step(batch)
    else:
        losses = train_step(trainer.state, batch, draws)
    opt = trainer.state.optimizer
    lr = opt.param_groups[0]["lr"]
    named = list(trainer.model.named_parameters())
    return dict(
        losses={k: float(v) for k, v in losses.items()},
        updates={n: (lr * opt.state[p]["momentum_buffer"]).cpu()
                 for n, p in named},
        grads={n: p.grad.detach().cpu() for n, p in named},
        params={n: p.detach().cpu() for n, p in named})


def serial_train(cfg, weights, batch, device, draws=None, dtype=None):
    """One process's step over the whole numpy `batch` from `weights`,
    drawing by site (`KeyedDraws`) unless `draws` is given; the model
    and the batch in `dtype` if given."""
    from mrcnn3d_torch.entry import build_trainer

    trainer = build_trainer(cfg, device=device, keyed_draws=True)
    trainer.model.load_state_dict(weights)
    trainer.model.to(dtype)
    return step_record(trainer, tensors(batch, device, dtype), draws)


def _rank_setup(device):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(device)


def dist_train_rank(rank, world, cfg, weights, batch, layout, device,
                    table=None, dtype=None):
    """A rank of one multi-process train step on an (n_data, n_depth)
    `layout`, from `weights`, on its rows of the numpy global `batch`
    (draws replayed from `table`, else keyed by site): step_record plus
    this rank's kernel launches."""
    from mrcnn3d_torch.entry import build_trainer
    from mrcnn3d_torch.parallel.mesh import local_rows, make_mesh2

    device = _rank_setup(device)
    mesh = make_mesh2(*layout)
    trainer = build_trainer(cfg, device=device, mesh=mesh)
    trainer.model.load_state_dict(weights)
    trainer.model.to(dtype)
    rows = local_rows(tensors(batch, device, dtype), mesh.data_rank,
                      mesh.n_data)
    zero_counts()
    rec = step_record(trainer, rows,
                      None if table is None else ReplayDraws(table))
    rec["launches"] = kernel_counts()
    return rec


def dist_infer_rank(rank, world, cfg, batches, device):
    """A rank of multi-process inference with seed 0's weights on numpy
    global batches, by mode: "batched" (`make_batched_infer`), "sharded"
    (`sharded_simple_test`, depth over the world).  {mode: (the outputs
    as numpy, this rank's kernel launches)}."""
    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.parallel.batched import make_batched_infer
    from mrcnn3d_torch.parallel.spatial import sharded_simple_test

    device = _rank_setup(device)
    det = build(cfg, device=device, seed=0)
    runs = {"batched": make_batched_infer(det),
            "sharded": lambda b: dict(zip(("dets", "labels", "valid"),
                                          sharded_simple_test(det)(b)))}
    out = {}
    for mode, batch in batches.items():
        zero_counts()
        got = runs[mode](tensors(batch, device))
        out[mode] = ({k: v.cpu().numpy() for k, v in got.items()},
                     kernel_counts())
    return out


def serial_infer(cfg, batch, device):
    """`simple_test` in one process with seed 0's weights; numpy."""
    from mrcnn3d_torch.entry import build

    det = build(cfg, device=device, seed=0)
    out = det.simple_test(tensors(batch, device))
    return {k: v.cpu().numpy() for k, v in out.items()}


def compare_steps(got, want, tol, what, keys=("updates", "grads")):
    """Each parameter's update and gradient within `tol` of the largest
    magnitude of `want`'s, the losses within `tol` relative.  Returns the
    worst of those ratios."""
    worst = 0.0
    for kind in keys:
        for name, w in want[kind].items():
            scale = float(w.abs().max())
            err = float((got[kind][name] - w).abs().max())
            if not err <= tol * scale:
                raise AssertionError(f"{what}: {kind} of {name} differ by "
                                     f"{err}, largest {scale}")
            worst = max(worst, err / scale if scale else 0.0)
    for k, v in want["losses"].items():
        err = abs(got["losses"][k] - v)
        if not err <= tol * max(abs(v), 1.0):
            raise AssertionError(f"{what}: {k} {got['losses'][k]} against "
                                 f"{v}")
    return worst


def train_job(cfg, batch, layout, device, dtype=None):
    """A multi-process step on `layout` against one process's over the
    same global batch, from the same weights and keyed draws, the model
    and batch in `dtype` if given.  Returns (job, check): job, the rank
    function and its arguments; check(the ranks' returns), every rank's
    record within MULTICARD_TOL -> (worst ratio, the ranks' launches)."""
    from mrcnn3d_torch.detectors.build import build_detector

    weights = build_detector(cfg, device="cpu", seed=0,
                             train=True).state_dict()
    want = serial_train(cfg, weights, batch, device, dtype=dtype)

    def check(ranks):
        worst = max(compare_steps(r, want, MULTICARD_TOL,
                                  f"{layout} rank {i}")
                    for i, r in enumerate(ranks))
        return worst, [r["launches"] for r in ranks]

    return (dist_train_rank, (cfg, weights, batch, layout, str(device),
                              None, dtype)), check


def infer_job(cfg, batches, device):
    """Two ranks' inference of each mode (`dist_infer_rank`) against
    serial simple_test on its batch.  Returns (job, check): check(the
    ranks' returns), valid and labels equal, the rest within
    PIPELINE_ATOL -> {mode: (error, the ranks' launches)}."""
    wants = {mode: serial_infer(cfg, batch, device)
             for mode, batch in batches.items()}

    def check(ranks):
        out = {}
        for mode, want in wants.items():
            keys = want if mode == "batched" else ("dets", "labels",
                                                   "valid")
            err = max(compare_outputs(r[mode][0], {k: want[k] for k in keys},
                                      PIPELINE_ATOL, f"{mode} rank {i}")
                      for i, r in enumerate(ranks))
            out[mode] = (err, [r[mode][1] for r in ranks])
        return out

    return (dist_infer_rank, (cfg, batches, str(device))), check


def run_jobs(rank, world, jobs):
    """Several rank functions, in turn, in one spawned process."""
    return [fn(rank, world, *args) for fn, args in jobs]


def check_dist_train(cfg, batch, layout, device, workdir=None, dtype=None):
    """`train_job` spawned and checked."""
    from mrcnn3d_torch.parallel.launch import spawn

    (fn, args), check = train_job(cfg, batch, layout, device, dtype)
    return check(spawn(fn, layout[0] * layout[1], args, workdir=workdir))


def check_dist_infer(cfg, batches, device, workdir=None):
    """`infer_job` spawned on two ranks and checked."""
    from mrcnn3d_torch.parallel.launch import spawn

    (fn, args), check = infer_job(cfg, batches, device)
    return check(spawn(fn, 2, args, workdir=workdir))


def sharded_batch(seed=3):
    """numpy volumes of SHARDED_SHAPES, one row."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {k: rng.randn(1, 3, *s).astype(np.float32)
            for k, s in zip(("imgs", "imgs_2"), SHARDED_SHAPES)}


def run_multicard_world2(device):
    """Phase 17 (b): two gloo processes on the one card (one spawn),
    narrow widths, float32: the data-parallel step against one process
    over the global batch, batched inference against serial,
    depth-sharded inference against replicated; every rank launches K1
    and K2 (and K2's backward in the step)."""
    from mrcnn3d_torch.parallel.launch import spawn

    icfg = small_config()
    for k in ("nms_pre", "nms_post", "max_num"):
        icfg.test_cfg["rpn"][k] = SMALL_BUDGET
    icfg.test_cfg["rcnn"]["max_per_img"] = SMALL_BUDGET
    icfg.test_cfg["return_bbox_only"] = False
    volumes = {k: v for k, v in small_train_batch(4, MULTICARD_ROWS).items()
               if k.startswith("imgs")}
    t = time.perf_counter()
    train, train_check = train_job(
        small_train_config(), small_train_batch(3, MULTICARD_ROWS), (2, 1),
        device)
    infer, infer_check = infer_job(
        icfg, {"batched": volumes, "sharded": sharded_batch()}, device)
    t_serial = time.perf_counter() - t
    t = time.perf_counter()
    ranks = spawn(run_jobs, 2, ([train, infer],))
    t_ranks = time.perf_counter() - t
    step_err, step_launches = train_check([r[0] for r in ranks])
    infer = infer_check([r[1] for r in ranks])
    runs = {"train": step_launches, **{m: r[1] for m, r in infer.items()}}
    for what, per_rank in runs.items():
        for i, launches in enumerate(per_rank):
            need = ("nms3d", "roi_align3d") + (
                ("roi_align3d_backward",) if what == "train" else ())
            if not all(launches[k] > 0 for k in need):
                raise AssertionError(f"world 2 {what}: rank {i} launches "
                                     f"{launches}")
    return dict(step_worst_ratio=step_err,
                batched_max_err=infer["batched"][0],
                sharded_max_err=infer["sharded"][0], launches=runs,
                serial_s=t_serial, ranks_s=t_ranks)


class HostSpans:
    """Within the block, the host time (perf_counter, no sync) and the
    calls of the parts a data-parallel step adds or changes: the
    normalizers' all-reduces (`global_sum`, at each of its import
    sites), the zero-fill of gradients, the gradient all-reduce and the
    samplers' draws; `take()` returns {part: [ms, calls]} since the
    last take."""

    # (module, class or None, attribute, part)
    SITES = (("detectors.pipeline", None, "global_sum", "global_sum"),
             ("ops.losses", None, "global_sum", "global_sum"),
             ("train.step", None, "global_sum", "global_sum"),
             ("train.step", None, "_fill_grads", "fill_grads"),
             ("train.step", None, "allreduce_grads", "allreduce_grads"),
             ("core.targets", "KeyedDraws", "__call__", "draws"),
             ("core.targets", "TorchDraws", "__call__", "draws"))

    def __enter__(self):
        import importlib

        self.parts, self._saved = {}, []
        for module, cls, name, label in self.SITES:
            owner = importlib.import_module("mrcnn3d_torch." + module)
            owner = getattr(owner, cls) if cls else owner
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._timed(fn, label))
        return self

    def _timed(self, fn, label):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                part = self.parts.setdefault(label, [0.0, 0])
                part[0] += (time.perf_counter() - t0) * 1e3
                part[1] += 1

        return timed

    def take(self):
        parts, self.parts = self.parts, {}
        return parts

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def run_multicard_world1(device, steps=3):
    """Phase 17 (a): a process group of one rank under NCCL.  The
    flagship's train step at full width, bf16, on bench.py's training
    geometry, one process's (as phase 8) and the data-parallel one's
    (mesh of one), 1 warm-up each, then `steps` timed each in turns
    (plain, dp, dp, plain, ...), the counters zeroed just before each
    data-parallel step and read just after (TRAIN_PER_STEP a step), the
    host time of each part the data-parallel step adds or changes
    (`HostSpans`) in the timed steps; one profiled step each, in turns;
    the gradient all-reduce's stage time and its time alone; then
    `evaluate_dataset` on a synthetic set."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from mrcnn3d_torch.apis.test_api import evaluate_dataset
    from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
    from mrcnn3d_torch.entry import build, build_trainer
    from mrcnn3d_torch.parallel.mesh import (allreduce_grads, get_dist_info,
                                             make_mesh)
    from mrcnn3d_torch.tools.common import test_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_multicard_")
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method="file://" + os.path.join(tmp, "store"))
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        torch.backends.cudnn.benchmark = True
        batch = train_batch(torch.Generator(device=device).manual_seed(17),
                            device)
        trainers = {name: build_trainer(CONFIG, device=device, seed=0,
                                        compute_dtype=torch.bfloat16,
                                        mesh=mesh)
                    for name, mesh in (("plain", None), ("dp", make_mesh(1)))}
        runs = {name: dict(step_s=[], stages=[], parts=[], losses=[],
                           launches=dict.fromkeys(TRAIN_PER_STEP, 0),
                           max_memory_allocated_gib=0.0)
                for name in trainers}
        # one warm-up each, then in turns: plain, dp, dp, plain, ...
        order = ["plain", "dp"] + [
            name for i in range(steps)
            for name in (("plain", "dp"), ("dp", "plain"))[i % 2]]
        with HostSpans() as spans:
            for i, name in enumerate(order):
                run, trainer = runs[name], trainers[name]
                timer = StageTimer()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                spans.take()
                t0 = time.perf_counter()
                out = trainer.step(batch, mark=timer)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                for k, v in kernel_counts().items():
                    run["launches"][k] += v
                run["max_memory_allocated_gib"] = max(
                    run["max_memory_allocated_gib"],
                    torch.cuda.max_memory_allocated() / 2**30)
                run["losses"].append(float(out["loss"]))
                if i >= 2:
                    run["step_s"].append(wall)
                    run["stages"].append(timer.stages_ms())
                    run["parts"].append(spans.take())
        for name, run in runs.items():
            if not all(math.isfinite(v) for v in run["losses"]):
                raise AssertionError(f"multicard {name}: {run['losses']}")
            stages, parts = run.pop("stages"), run.pop("parts")
            run["median_step_s"] = float(np.median(run["step_s"]))
            run["stage_ms"] = {k: float(np.median([s[k] for s in stages]))
                               for k in stages[0]}
            # {part: [median host ms a step, calls a step]}
            run["host_parts_ms"] = {
                k: [float(np.median([p.get(k, [0.0, 0])[0] for p in parts])),
                    parts[0].get(k, [0.0, 0])[1]]
                for k in sorted({k for p in parts for k in p})}
        # one more step each under the profiler, in turns: device busy
        # time and idle share, NCCL's kernels
        for name in ("plain", "dp", "dp", "plain"):
            prof = profile_step(lambda: trainers[name].step(batch))
            runs[name].setdefault("profiled", []).append(None if prof is None
                else {k: prof[k] for k in ("busy_ms", "span_ms", "idle_share",
                                           "kernels", "nccl_kernels",
                                           "nccl_ms")})
        params = list(trainers["dp"].model.parameters())
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        runs["dp"].update(
            allreduce_alone_ms=time_ms(lambda: allreduce_grads(params)),
            # its parts: the flatten into one buffer, NCCL on that buffer
            flatten_alone_ms=time_ms(lambda: torch.cat(
                [g.reshape(-1) for g in grads])),
            nccl_alone_ms=time_ms(lambda: dist.all_reduce(flat)),
            gradient_mib=flat.numel() * 4 / 2**20)
        # the data-parallel trainer's keyed draws (a generator seeded a
        # draw) against the one-process trainer's generator, for one
        # step's 20 sampler draws (2 scales' RPN and R-CNN, the
        # refinement; 2 images; positives and negatives)
        high = torch.tensor(1000, device=device)
        sites = [(stage, s, i, kind) for stage in ("rpn", "rcnn", "refine")
                 for s in ((0, 1) if stage != "refine" else (1,))
                 for i in range(TRAIN_BATCH) for kind in ("pos", "neg")]
        for name in ("plain", "dp"):
            draws = trainers[name].draws
            draws = draws.at(0) if name == "dp" else draws
            t0 = time.perf_counter()
            for site in sites:
                draws(site, 256, high)
            torch.cuda.synchronize()
            runs[name]["draws_ms_per_step"] = (time.perf_counter() - t0) * 1e3
        del trainers, params, grads, flat
        torch.cuda.empty_cache()
        n_steps = 1 + steps
        for k, count in TRAIN_PER_STEP.items():
            if runs["dp"]["launches"][k] != count * n_steps:
                raise AssertionError(
                    f"multicard dp: {k} {runs['dp']['launches'][k]} "
                    f"launches in {n_steps} steps, expected {count} a step")
        # the eval's shapes are new: no autotuning for one pass
        torch.backends.cudnn.benchmark = False
        rank, world = get_dist_info()
        cfg = main_config()
        ann, img = make_synthetic_coco3d(os.path.join(tmp, "data"),
                                         num_volumes=2, hw=128, depth=32,
                                         seed=7)
        ds = test_dataset(cfg.data["test"], ann, img, 2)
        model = build(cfg, device=device, seed=0).model
        t = time.perf_counter()
        stats = evaluate_dataset(cfg, model, ds, rank=rank, world=world)
        eval_s = time.perf_counter() - t
        if len(stats) != 29 or not all(math.isfinite(v)
                                       for v in stats.values()):
            raise AssertionError(f"multicard evaluate_dataset: {stats}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(runs=runs, eval_stats=stats, eval_s=eval_s,
                dp_over_plain=runs["dp"]["median_step_s"]
                / runs["plain"]["median_step_s"])


def run_multicard_phase(device):
    """Phase 17: world 1 under NCCL at full width, then world 2 under
    gloo at narrow widths, both on the one card, then the entry point
    `dryrun_multichip(2)` on the card (one data-parallel and one hybrid
    step, two gloo processes)."""
    from mrcnn3d_torch.entry import dryrun_multichip

    t = time.perf_counter()
    world1 = run_multicard_world1(device)
    world2 = run_multicard_world2(device)
    t_dry = time.perf_counter()
    dp, hybrid = dryrun_multichip(2)
    world2["dryrun"] = dict(loss_dp=dp, loss_hybrid=hybrid,
                            seconds=time.perf_counter() - t_dry)
    emit({"phase": "multicard", "ok": True, "world1": world1,
          "world2": world2, "seconds": time.perf_counter() - t})
    return world1, world2


# ---------------------------------------------------------------------------
# phase 18: the other backbones, OHEM, test-time augmentation, host modules
# ---------------------------------------------------------------------------


# the runs whose full-width launches are recorded and checked alone
EXTRAS_CHECKED = (*BACKBONES, "TTA")
# the test-time views of phase 18: identity, W-flip, 1.5x on every axis
TTA_METAS = [dict(scale_factor=1.0, flip=False),
             dict(scale_factor=1.0, flip=True),
             dict(scale_factor=1.5, flip=False)]
# launches a step, read from the code: every backbone and OHEM run the
# flagship's pipeline (VARIANT_LAUNCHES's rule for MaskRCNN3D2Scales:
# inference K1 3, K2 4; train K1 2, K2 and its backward 5); TTA over V
# views (detectors/aug.py) K1 V + 2 (each view's proposals, the merge,
# the class-wise NMS) and K2 2V (each view's bbox and mask aligns)
EXTRAS_LAUNCHES = {**{name: ((3, 4), (2, 5, 5)) for name in BACKBONES},
                   "OHEM": ((3, 4), (2, 5, 5)),
                   "TTA": ((5, 6), None)}


def extras_recipe(cfg, name):
    """The config of a phase-18 run, in place: a BACKBONES backbone,
    "OHEM" (the R-CNN sampler OHEMSampler) or "TTA" (single-scale
    MaskRCNN3D by the JAX aug_test recipe, tests/test_aug_test.py:80-89,
    at depth 50).  The full-width runs also set the R-CNN score
    threshold to 0 (`extras_full`)."""
    if name in BACKBONES:
        return backbone_recipe(cfg, name)
    if name == "OHEM":
        cfg.train_cfg["rcnn"]["sampler"]["type"] = "OHEMSampler"
        return cfg
    return variant_recipe(cfg, "MaskRCNN3D")


def extras_full(cfg):
    """The full-width runs' config: R-CNN score threshold 0, so every
    class-1 row enters the class-wise NMS and the mask stage sees the
    2000-row budget whatever random weights score (ResNet3D-101's seed-0
    weights score no row above the config's 0.2 on the headline pair,
    measured on one H100)."""
    cfg.test_cfg["rcnn"]["score_thr"] = 0.0
    return cfg


def tta_calls():
    """The names of one aug_test's launches over TTA_METAS, in the order
    aug.py makes them (masks on)."""
    views = range(len(TTA_METAS))
    return {"nms3d": [f"proposals_view{v}" for v in views]
            + ["merge", "classwise"],
            "roi_align3d": [f"bbox_view{v}" for v in views]
            + [f"mask_view{v}" for v in views]}


def extras_calls(name, train):
    """The names of one step's launches of a phase-18 run."""
    if name == "TTA":
        return tta_calls()
    return variant_calls("MaskRCNN3D2Scales", train)


def extras_per_step(name):
    """EXTRAS_LAUNCHES of a run as counter dicts (inference, train; None
    where it has none), checked against the launches read from the
    code."""
    (k1, k2), tr = EXTRAS_LAUNCHES[name]
    infer = {"nms3d": k1, "roi_align3d": k2}
    train = None if tr is None else dict(zip(
        ("nms3d", "roi_align3d", "roi_align3d_backward"), tr))
    for per_step, is_train in ((infer, False), (train, True)):
        if per_step is None:
            continue
        got = {k: len(v) for k, v in extras_calls(name, is_train).items()}
        if is_train:
            got["roi_align3d_backward"] = got["roi_align3d"]
        if got != per_step:
            raise AssertionError(f"{name}: the code makes {got} launches "
                                 f"a step, the table {per_step}")
    return infer, train


def tta_views(vol):
    """TTA_METAS's views of (B, 3, D, H, W) volumes: the volume, its
    W-flip, and its 1.5x trilinear resize (`ops/resize3d.py`)."""
    from mrcnn3d_torch.ops.resize3d import jax_resize

    big = jax_resize(vol, tuple(int(n * 1.5) for n in vol.shape[2:]),
                     "trilinear")
    return [dict(imgs=vol), dict(imgs=vol.flip(-1)), dict(imgs=big)]


def tta_run(det, vol, scale=1.0):
    """aug_test of `det` over tta_views of the numpy volume; numpy
    outputs."""
    import torch

    x = torch.from_numpy(vol).to(det.device) * scale
    out = det.aug_test(tta_views(x), TTA_METAS)
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_small_extra(device, name):
    """A phase-18 run at the narrow widths (budgets 64) on the card
    against the CPU: its inference (valid and labels equal, the rest
    within PIPELINE_ATOL) and, but for TTA, one train step as
    check_small_train holds it (every sample index equal: OHEM's ranked
    negatives among them); the card's launches, one step each, as
    EXTRAS_LAUNCHES says."""
    import numpy as np

    from mrcnn3d_torch.entry import build

    infer, train = extras_per_step(name)
    cfg = extras_recipe(small_config(), name)
    gpu = build(cfg, device=device, budgets=SMALL_BUDGET)
    cpu = build(cfg, device="cpu", budgets=SMALL_BUDGET)
    # UNet3D's poolings and crops need sides divisible by 8 (the
    # full-width shapes are)
    shapes = UNET_SMALL_SHAPES if name == "UNet3D" else SMALL_SHAPES
    rng = np.random.RandomState(7)
    if name == "TTA":
        vol = rng.randn(1, 3, *shapes[0]).astype(np.float32)
        zero_counts()
        a = tta_run(gpu, vol)
        _check_counts(kernel_counts(), infer, 1, f"small {name}")
        b = tta_run(cpu, vol)
        a["mask_logits"], b["mask_logits"] = (x.pop("mask_probs")
                                              for x in (a, b))
    else:
        batch = {k: rng.randn(1, 3, *s).astype(np.float32)
                 for k, s in zip(("imgs", "imgs_2"), shapes)}
        zero_counts()
        a = small_run(gpu, batch)
        _check_counts(kernel_counts(), infer, 1, f"small {name}")
        b = small_run(cpu, batch)
    err = compare_outputs(a, b, PIPELINE_ATOL, f"small {name}")
    n = int(a["valid"].sum())
    if n == 0:
        raise AssertionError(f"small {name}: no detections, vacuous")
    rec = dict(detections=n, max_abs_err=err, outputs=sorted(a))
    if train is not None:
        zero_counts()
        rec["train"] = check_small_train(
            device, extras_recipe(small_train_config(), name),
            small_train_batch(3, shapes=shapes), f"small train {name}")
        _check_counts(kernel_counts(), train, 1, f"small train {name}")
    return rec


class PreNms:
    """Within the block, records the inputs of aug.py's class-wise NMS
    (the merged views' boxes, scores and valid rows)."""

    def __enter__(self):
        from mrcnn3d_torch.detectors import aug

        self._fn = fn = aug.multiclass_nms_3d
        self.rows = None

        def record(boxes, scores, valid, *args):
            self.rows = (boxes, scores, valid)
            return fn(boxes, scores, valid, *args)

        aug.multiclass_nms_3d = record
        return self

    def __exit__(self, *exc):
        from mrcnn3d_torch.detectors import aug

        aug.multiclass_nms_3d = self._fn
        return False


def run_extra(device, name, steps=3, record=False):
    """A phase-18 run at full width, bf16, every budget 2000, masks on:
    inference on the headline geometry (the flagship's two volumes; for
    TTA the three views of the 64x512x512 volume) and, but for TTA, the
    train step on bench.py's training geometry; each 1 warm-up and
    `steps` timed (OHEM: its train step only), the counters zeroed just
    before and read just after the timed ones, the peak memory.  record:
    one more step of each whose launches are recorded.  Returns (the
    record, the captured inference step, the captured train step, the
    inference's last result)."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build, build_trainer

    infer, train = extras_per_step(name)
    torch.backends.cudnn.benchmark = True
    cfg = extras_full(extras_recipe(main_config(), name))
    out, captured, res = {}, None, None
    gen = torch.Generator(device=device).manual_seed(11)
    if name != "OHEM":
        det = build(cfg, device=device, dtype=torch.bfloat16,
                    budgets=MAIN_BUDGET, seed=0)
        if name == "TTA":
            views = tta_views(torch.randn(
                (1, 3, *MAIN_SHAPES[0]), generator=gen,
                device=device).to(torch.bfloat16))

            def step():
                return det.aug_test(views, TTA_METAS)
        else:
            batch = {k: torch.randn((1, 3, *s), generator=gen,
                                    device=device).to(torch.bfloat16)
                     for k, s in zip(("imgs", "imgs_2"), MAIN_SHAPES)}

            def step():
                return det.simple_test(batch)

        res, out["inference"] = _timed(step, infer, steps,
                                       f"{name} inference")
        out["inference"].update(_check_result(res, name))
        if name == "TTA":
            out["inference"]["views"] = [list(v["imgs"].shape)
                                         for v in views]
            with PreNms() as pre:
                step()
            out["pre_nms"] = pre.rows
        if record:
            with Capture() as captured:
                step()
            torch.cuda.synchronize()
        del det, step
    train_captured = None
    if train is not None:
        trainer = build_trainer(cfg, device=device, seed=0,
                                compute_dtype=torch.bfloat16)
        tb = train_batch(torch.Generator(device=device).manual_seed(17),
                         device)
        losses, out["train"] = _timed(lambda: trainer.step(tb), train,
                                      1 if name == "OHEM" else steps,
                                      f"{name} train")
        losses = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{name} train: non-finite {losses}")
        out["train"].update(losses_last=losses, batch=TRAIN_BATCH,
                            volumes_per_s=TRAIN_BATCH
                            / out["train"]["median_step_s"])
        if record:
            with Capture(tuple(TRAIN_PER_STEP)) as train_captured:
                trainer.step(tb)
            torch.cuda.synchronize()
        del trainer, tb
    return out, captured, train_captured, res


def extras_gt(seed=23, n=8):
    """A seeded gt of n boxes inside the headline volume, (n, 6)
    xyxyzz."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d, h, w = MAIN_SHAPES[0]
    ext = rng.uniform(8, 40, (n, 3)) * np.array([1, 1, 0.25])
    lo = rng.uniform(0, 1, (n, 3)) * (np.array([w, h, d]) - ext - 1)
    hi = lo + ext
    return np.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2],
                     hi[:, 2]], 1).astype(np.float32)


def check_host_modules(device, tta_res, pre_nms):
    """Phase 18 (d): the host-side modules on the card's outputs, as a
    check that they run (the numbers are no claim): eval_map_3d of the
    TTA detections against a seeded gt; eval_recalls_3d of full-width
    RPN3D's proposals on the headline volume; soft_nms_3d (linear,
    gaussian, naive) on the 1000 valid TTA pre-NMS rows with the highest
    class-1 scores; roi_pool_3d on a full-width FPN level (the flagship's
    level 1 of the headline volume) against its numpy oracle, exactly."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.eval.mean_ap import eval_map_3d
    from mrcnn3d_torch.eval.recall import eval_recalls_3d
    from mrcnn3d_torch.ops.nms3d import soft_nms_3d
    from mrcnn3d_torch.ops.roi_pool3d import roi_pool_3d

    out = {}
    gt = extras_gt()
    v = tta_res["valid"][0]
    dets = tta_res["dets"][0][v].float().cpu().numpy()
    t = time.perf_counter()
    ap, rec, prec = eval_map_3d([dets], [gt])
    out["eval_map_3d"] = dict(ap=ap, dets=len(dets), gts=len(gt),
                              seconds=time.perf_counter() - t)

    rpn = build(variant_recipe(main_config(), "RPN3D"), device=device,
                dtype=torch.bfloat16, budgets=MAIN_BUDGET, seed=0)
    gen = torch.Generator(device=device).manual_seed(11)
    vol = torch.randn((1, 3, *MAIN_SHAPES[0]), generator=gen,
                      device=device).to(torch.bfloat16)
    props = rpn.simple_test(dict(imgs=vol))
    pv = props["valid"][0]
    p = props["dets"][0][pv].float().cpu().numpy()
    t = time.perf_counter()
    recalls = eval_recalls_3d([gt], [p], (100, 300, 1000, 2000),
                              (0.1, 0.3, 0.5))
    out["eval_recalls_3d"] = dict(recalls=recalls.tolist(),
                                  proposals=len(p),
                                  seconds=time.perf_counter() - t)

    boxes, scores, valid = pre_nms
    rows = torch.cat([boxes[0, :, 6:12], scores[0, :, 1:2]], 1)[valid[0]]
    rows = rows[torch.argsort(rows[:, 6], descending=True)[:1000]]
    out["soft_nms_3d"] = {"rows": int(rows.shape[0])}
    for method in ("linear", "gaussian", "naive"):
        t = time.perf_counter()
        kept, idx = soft_nms_3d(rows, 0.3, method)
        out["soft_nms_3d"][method] = dict(kept=len(idx),
                                          seconds=time.perf_counter() - t)

    level = rpn.model.extract_feat(vol)[1].float()
    stride, stride_d = 8, 4
    rng = np.random.RandomState(5)
    d, h, w = MAIN_SHAPES[0]
    # some rois start outside the volume, some end past it
    lo = rng.uniform(0, 1, (64, 3)) * np.array([w, h, d]) - \
        np.array([16, 16, 2])
    ext = rng.uniform(8, 160, (64, 3)) * np.array([1, 1, 0.2])
    rois = np.concatenate([np.zeros((64, 1)), lo[:, :2], lo[:, :2]
                           + ext[:, :2], lo[:, 2:], lo[:, 2:] + ext[:, 2:]],
                          1).astype(np.float32)
    t = time.perf_counter()
    got = roi_pool_3d(level, torch.from_numpy(rois).to(device), 7, 3,
                      1.0 / stride, 1.0 / stride_d).cpu().numpy()
    pool_s = time.perf_counter() - t
    want = roi_pool_3d_oracle(level.permute(0, 2, 3, 4, 1).cpu().numpy(),
                              rois, 7, 3, 1.0 / stride, 1.0 / stride_d)
    if not np.array_equal(got, want):
        raise AssertionError("roi_pool_3d: the card differs from the "
                             "numpy oracle")
    out["roi_pool_3d"] = dict(rois=64, level=list(level.shape),
                              max_abs_out=float(np.abs(got).max()),
                              seconds=pool_s)
    return out


def roi_pool_3d_oracle(feats, rois, out_size, out_size_depth,
                       spatial_scale, depth_scale):
    """The scalar numpy oracle of RoIPool3D, a copy of
    `mrcnn3d/ops/roi_pool3d.py:roi_pool_3d_numpy`: feats (B, D, H, W,
    C); returns (N, C, od, o, o)."""
    import numpy as np

    fb, fd, fh, fw, c = feats.shape
    n = rois.shape[0]
    out = np.zeros((n, out_size_depth, out_size, out_size, c), np.float32)
    for i, roi in enumerate(np.asarray(rois)):
        bi = int(roi[0])
        x1 = int(round(roi[1] * spatial_scale))
        y1 = int(round(roi[2] * spatial_scale))
        x2 = int(round(roi[3] * spatial_scale))
        y2 = int(round(roi[4] * spatial_scale))
        z1 = int(round(roi[5] * depth_scale))
        z2 = int(round(roi[6] * depth_scale))
        w = max(x2 - x1 + 1, 1)
        h = max(y2 - y1 + 1, 1)
        d = max(z2 - z1 + 1, 1)
        for oz in range(out_size_depth):
            zs = max(min(z1 + int(np.floor(oz * d / out_size_depth)), fd), 0)
            ze = max(min(z1 + int(np.ceil((oz + 1) * d / out_size_depth)),
                         fd), 0)
            for oy in range(out_size):
                ys = max(min(y1 + int(np.floor(oy * h / out_size)), fh), 0)
                ye = max(min(y1 + int(np.ceil((oy + 1) * h / out_size)),
                             fh), 0)
                for ox in range(out_size):
                    xs = max(min(x1 + int(np.floor(ox * w / out_size)), fw),
                             0)
                    xe = max(min(x1 + int(np.ceil((ox + 1) * w / out_size)),
                                 fw), 0)
                    if zs >= ze or ys >= ye or xs >= xe:
                        continue
                    out[i, oz, oy, ox] = feats[
                        bi, zs:ze, ys:ye, xs:xe].max(axis=(0, 1, 2))
    return np.moveaxis(out, -1, 1)


def run_extras(device):
    """Phase 18: each backbone, OHEM and TTA, card against CPU at the
    narrow widths, then at full width; the launches of EXTRAS_CHECKED's
    steps each checked alone against the plain versions (as
    phases 6 and 9); then the host-side modules on the card's outputs.
    Returns (the per-run records, the checked launches by run, the host
    modules' record)."""
    import torch

    records, checks = {}, {}
    tta_res = pre_nms = None
    for name in (*BACKBONES, "OHEM", "TTA"):
        t = time.perf_counter()
        rec = {"small": check_small_extra(device, name)}
        checked = name in EXTRAS_CHECKED
        full, cap, train_cap, res = run_extra(device, name, record=checked)
        if name == "TTA":
            tta_res, pre_nms = res, full.pop("pre_nms")
        rec.update(full)
        if checked:
            with torch.no_grad():
                checks[name] = {"inference": check_launches(
                    cap, extras_calls(name, False), f"{name} step")}
                if train_cap is not None:
                    checks[name]["train"] = check_train_step_kernels(
                        train_cap, extras_calls(name, True))
            del cap, train_cap
        rec["seconds"] = time.perf_counter() - t
        records[name] = rec
        del res
        torch.cuda.empty_cache()
    t = time.perf_counter()
    host = check_host_modules(device, tta_res, pre_nms)
    host["seconds"] = time.perf_counter() - t
    return records, checks, host


def run_extras_phase(device):
    """Phase 18: the other backbones, OHEM, TTA and the host modules."""
    t = time.perf_counter()
    extras, checks, host = run_extras(device)
    emit({"phase": "extras", "ok": True, "runs": extras,
          "kernel_checks": checks, "host_modules": host,
          "seconds": time.perf_counter() - t})
    return extras, checks


# ---------------------------------------------------------------------------
# phase 19: the 2-D family, with_cp and the 2-D host modules
# ---------------------------------------------------------------------------

# the narrow recipe's budgets (the JAX tests' cfg2d)
TWO_D_BUDGET = 32
# full width: gt boxes an image in the train step, FastRCNN's proposals
TWO_D_MAX_GT = 20
TWO_D_PROPOSALS = 1000
# (K1, K2) launches an inference step and (K1, K2, K2's backward) a
# train step: an RPN-only type's proposals (none in training), the
# one-scale bbox and mask aligns, RetinaNet's class-wise K1 (nothing in
# training), FastRCNN's precomputed proposals (no proposal K1 at
# inference), the cascades' as phase 16's
TWO_D_LAUNCHES = {
    "RPN": ((1, 0), (0, 0, 0)),
    "FasterRCNN": ((2, 1), (1, 1, 1)),
    "FastRCNN": ((1, 1), (1, 1, 1)),
    "MaskRCNN": ((2, 2), (1, 2, 2)),
    "RetinaNet": ((1, 0), (0, 0, 0)),
    "CascadeRCNN": ((2, 3), (1, 3, 3)),
    "HybridTaskCascade": ((2, 8), (1, 12, 12)),
}
# the types whose full-width launches are recorded and checked alone
TWO_D_CHECKED = ("FasterRCNN", "MaskRCNN")


def two_d_calls(type_name, train):
    """The names of one step's K1 and K2 launches of a 2-D type."""
    return pipeline_calls(two_d_config(type_name), train,
                          proposals_given=type_name == "FastRCNN")


def two_d_per_step(type_name):
    """TWO_D_LAUNCHES of a type as counter dicts (inference, train),
    checked against the launches `two_d_calls` reads from the code."""
    (k1, k2), (t1, t2, tb) = TWO_D_LAUNCHES[type_name]
    infer = {"nms3d": k1, "roi_align3d": k2}
    train = {"nms3d": t1, "roi_align3d": t2, "roi_align3d_backward": tb}
    for per_step, is_train in ((infer, False), (train, True)):
        got = {k: len(v) for k, v in two_d_calls(type_name,
                                                 is_train).items()}
        if is_train:
            got["roi_align3d_backward"] = got["roi_align3d"]
        if got != per_step:
            raise AssertionError(f"{type_name}: the pipeline makes {got} "
                                 f"launches a step, the table {per_step}")
    return infer, train


def check_small_two_d(device, type_name):
    """A 2-D type at the narrow recipe (two_d_narrow) on the card against
    the CPU: inference on a 64x64 image (FastRCNN on precomputed
    proposals; valid and labels equal, dets and mask logits within
    PIPELINE_ATOL) and one train step as check_small_train holds it (the
    max-pool ties replayed); the card's launches, one step each, as
    TWO_D_LAUNCHES says."""
    from mrcnn3d_torch.entry import build

    infer, train = two_d_per_step(type_name)
    cfg = two_d_narrow(two_d_config(type_name), TWO_D_BUDGET)
    gpu = build(cfg, device=device)
    cpu = build(cfg, device="cpu")
    batch = two_d_inputs(7, proposals=type_name == "FastRCNN")
    zero_counts()
    a = small_run(gpu, batch)
    _check_counts(kernel_counts(), infer, 1, f"small {type_name}")
    err = compare_outputs(a, small_run(cpu, batch), PIPELINE_ATOL,
                          f"small {type_name}")
    n = int(a["valid"].sum())
    if n == 0:
        raise AssertionError(f"small {type_name}: no detections, vacuous")
    zero_counts()
    trained = check_small_train(device, cfg,
                                two_d_train_batch(3, type_name),
                                f"small train {type_name}")
    _check_counts(kernel_counts(), train, 1, f"small train {type_name}")
    return dict(detections=n, max_abs_err=err, outputs=sorted(a),
                train=trained)


def two_d_full_config(type_name):
    """A 2-D type's full config with the R-CNN (and RetinaNet) score
    threshold at 0: random weights score each of the 80 classes near
    1/81, under the config's 0.05, and the class-wise NMS and the mask
    stage should run at the full budget."""
    cfg = two_d_config(type_name)
    cfg.test_cfg["rcnn"]["score_thr"] = 0.0
    return cfg


def two_d_proposals(gen, k, device):
    """k random proposals (1, k, 6) inside TWO_D_SHAPE, z [0, 0]."""
    import torch

    _, h, w = TWO_D_SHAPE
    xy = torch.rand((1, k, 2), generator=gen, device=device) \
        * torch.tensor([w * 0.8, h * 0.8], device=device)
    size = 8 + torch.rand((1, k, 2), generator=gen, device=device) \
        * (min(h, w) * 0.2)
    return torch.cat([xy, xy + size, torch.zeros((1, k, 2), device=device)],
                     -1)


def two_d_train_batch_full(gen, device, type_name, num_classes):
    """The full-width 2-D train batch on the card: TRAIN_BATCH random
    bf16 images of TWO_D_SHAPE, TWO_D_MAX_GT valid gt boxes each (x1,
    y1 ~ U(4, 0.6 side), extent ~ U(16, 0.3 H), z [0, 0]) with labels
    drawn from the num_classes - 1 classes; gt masks all ones (MaskRCNN,
    HTC) and HTC's gt_semantic_seg from them (semantic_seg)."""
    import torch

    _, h, w = TWO_D_SHAPE
    b, g = TRAIN_BATCH, TWO_D_MAX_GT
    lo = 4 + torch.rand((b, g, 2), generator=gen, device=device) \
        * torch.tensor([w * 0.6 - 4, h * 0.6 - 4], device=device)
    size = 16 + torch.rand((b, g, 2), generator=gen, device=device) \
        * (h * 0.3 - 16)
    batch = {
        "imgs": torch.randn((b, 3, *TWO_D_SHAPE), generator=gen,
                            device=device).to(torch.bfloat16),
        "gt_boxes": torch.cat([lo, lo + size,
                               torch.zeros((b, g, 2), device=device)], -1),
        "gt_valid": torch.ones((b, g), dtype=torch.bool, device=device),
        "gt_labels": torch.randint(1, num_classes, (b, g), generator=gen,
                                   device=device, dtype=torch.int32),
    }
    if type_name in TWO_D_MASKED:
        batch["gt_masks"] = torch.ones((b, g, *TWO_D_SHAPE),
                                       dtype=torch.uint8, device=device)
    if type_name == "HybridTaskCascade":
        batch["gt_semantic_seg"] = semantic_seg(batch)
    return batch


def run_two_d(device, type_name, steps=3, record=False):
    """A 2-D type at full width (two_d_full_config: the shipped 2-D
    config, ResNet-50 at base width 64, FPN 256, 81 classes, its own
    budgets), bf16: inference on one 1x800x1344 image (FastRCNN on
    TWO_D_PROPOSALS precomputed proposals) and the train step on
    TRAIN_BATCH images with TWO_D_MAX_GT gt each, 1 warm-up and `steps`
    timed, the counters zeroed just before and read just after the
    timed ones, the peak memory of each.  record: one more step of each
    whose launches are recorded.  Returns (the record, the captured
    inference step, the captured train step)."""
    import numpy as np
    import torch

    from mrcnn3d_torch.entry import build, build_trainer

    infer, train = two_d_per_step(type_name)
    torch.backends.cudnn.benchmark = True
    cfg = two_d_full_config(type_name)
    det = build(cfg, device=device, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=device).manual_seed(11)
    batch = {"imgs": torch.randn((1, 3, *TWO_D_SHAPE), generator=gen,
                                 device=device).to(torch.bfloat16)}
    if type_name == "FastRCNN":
        batch["proposals"] = two_d_proposals(gen, TWO_D_PROPOSALS, device)
        batch["proposals_valid"] = torch.ones(
            (1, TWO_D_PROPOSALS), dtype=torch.bool, device=device)
    out = {}
    res, out["inference"] = _timed(lambda: det.simple_test(batch), infer,
                                   steps, f"{type_name} inference")
    out["inference"].update(_check_result(res, type_name))
    b = cfg.test_cfg["rcnn"]["max_per_img"] if type_name != "RPN" \
        else cfg.test_cfg["rpn"]["max_num"]
    has_masks = type_name in TWO_D_MASKED
    if tuple(res["dets"].shape) != (1, b, 7) or \
            ("mask_logits" in res) != has_masks or \
            (has_masks and tuple(res["mask_logits"].shape[2:])
             != (1, 28, 28)) or \
            bool((res["dets"][..., 4:6] != 0).any()):
        shapes = {k: tuple(v.shape) for k, v in res.items()}
        raise AssertionError(f"{type_name}: outputs {shapes}, or boxes "
                             f"off the z = 0 plane")
    captured = None
    if record:
        with Capture() as captured:
            det.simple_test(batch)
        torch.cuda.synchronize()
    del det, batch, res

    trainer = build_trainer(cfg, device=device, seed=0,
                            compute_dtype=torch.bfloat16)
    tb = two_d_train_batch_full(
        torch.Generator(device=device).manual_seed(17), device, type_name,
        cfg.model["bbox_head"]["num_classes"])
    losses, out["train"] = _timed(lambda: trainer.step(tb), train, steps,
                                  f"{type_name} train")
    losses = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{type_name} train: non-finite {losses}")
    out["train"].update(losses_last=losses, batch=TRAIN_BATCH,
                        images_per_s=TRAIN_BATCH
                        / out["train"]["median_step_s"])
    train_captured = None
    if record and any(train.values()):
        with Capture(tuple(TRAIN_PER_STEP)) as train_captured:
            trainer.step(tb)
        torch.cuda.synchronize()
    return out, captured, train_captured


def run_with_cp(device, steps=3):
    """The flagship's train step at bench.py's training geometry (phase
    8's) with and without backbone.with_cp: first one float32 step each
    from seed 0's weights on the same batch and CountedDraws(7), cuDNN
    pinned (PinnedCudnn), whose updates (learning rate times SGD's
    momentum buffer) must agree within PIPELINE_ATOL of each parameter's
    largest (in bf16 the K2 backward's float atomics, whose order varies,
    move the stem conv's update by about 1% between any two runs); then,
    in bf16, 1 warm-up and `steps` timed steps with the peak memory, the
    counters zeroed just before and read just after."""
    import copy

    import torch

    from mrcnn3d_torch.entry import build_trainer

    out, updates = {}, {}
    for name, with_cp in (("plain", False), ("with_cp", True)):
        cfg = copy.deepcopy(main_config())
        cfg.model["backbone"]["with_cp"] = with_cp
        tb = train_batch(torch.Generator(device=device).manual_seed(17),
                         device)
        trainer = build_trainer(cfg, device=device, seed=0)
        if trainer.model.backbone.with_cp != with_cp:
            raise AssertionError("with_cp: the backbone did not read it")
        trainer.draws = CountedDraws(7)
        with PinnedCudnn():
            trainer.step({k: v.float() if v.dtype == torch.bfloat16 else v
                          for k, v in tb.items()})
        opt = trainer.state.optimizer
        lr = opt.param_groups[0]["lr"]
        updates[name] = {n: (lr * opt.state[p]["momentum_buffer"]).cpu()
                         for n, p in trainer.model.named_parameters()}
        del trainer
        trainer = build_trainer(cfg, device=device, seed=0,
                                compute_dtype=torch.bfloat16)
        torch.backends.cudnn.benchmark = True
        _, out[name] = _timed(lambda: trainer.step(tb), TRAIN_PER_STEP,
                              steps, f"flagship train, {name}")
        del trainer, tb
        torch.cuda.empty_cache()
    worst, worst_name = 0.0, None
    for n, want in updates["plain"].items():
        scale = float(want.abs().max())
        e = float((updates["with_cp"][n] - want).abs().max())
        if not e <= PIPELINE_ATOL * scale:
            raise AssertionError(f"with_cp: {n} update differs by {e}, "
                                 f"largest {scale}")
        if scale and e / scale > worst:
            worst, worst_name = e / scale, n
    out["max_update_rel_err"] = worst
    out["worst_parameter"] = worst_name
    out["memory_ratio"] = (out["with_cp"]["max_memory_allocated_gib"]
                           / out["plain"]["max_memory_allocated_gib"])
    out["time_ratio"] = (out["with_cp"]["median_step_s"]
                         / out["plain"]["median_step_s"])
    return out


# DCN card against CPU, relative to each output's and gradient's largest;
# in float64: the bilinear sampler's slope jumps where a sample crosses
# an integer coordinate, and in float32 a sample within rounding of one
# takes the other side's slope on one device
DCN_TOL = 1e-4


def _rel_err(got, want):
    scale = float(want.abs().max())
    return float((got.detach().cpu() - want).abs().max()) / (scale or 1.0)


def check_two_d_host_modules(device):
    """The 2-D host modules on the card, as a check that they run: (a)
    load_reference_checkpoint of a file written here (the full-width
    FasterRCNN's state_dict wrapped Runner-style under `module.`, plus
    an excluded projection key) into another seed's detector: every key
    loaded and the outputs equal to the source detector's; (b) DCN's
    forward and backward on a full-width FPN level (stride 8, 256
    channels of the shipped 2-D config's 1x800x1344 image), card
    against the same computation on the CPU in float64, offsets drawn
    so that every tap moves: DeformConv2dPack (v1 and modulated) and
    DeformRoIPoolingPack (modulated, 128 rois), outputs and gradients
    within DCN_TOL of their largest."""
    import os
    import tempfile

    import torch

    from mrcnn3d_torch.compat.reference_ckpt import load_reference_checkpoint
    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.ops.dcn import DeformConv2dPack, DeformRoIPoolingPack

    out = {}
    t = time.perf_counter()
    cfg = two_d_full_config("FasterRCNN")
    src = build(cfg, device=device, seed=0)
    dst = build(cfg, device=device, seed=1)
    fd, path = tempfile.mkstemp(suffix=".pth")
    os.close(fd)
    try:
        sd = {f"module.{k}": v.cpu() for k, v in
              src.model.state_dict().items()}
        sd["module.backbone.projection_original_features.weight"] = \
            torch.zeros(3)
        torch.save({"state_dict": sd, "meta": {}}, path)
        left = load_reference_checkpoint(dst.model, path)
    finally:
        os.unlink(path)
    if left:
        raise AssertionError(f"reference checkpoint: {left} not loaded")
    gen = torch.Generator(device=device).manual_seed(3)
    img = {"imgs": torch.randn((1, 3, *TWO_D_SHAPE), generator=gen,
                               device=device)}
    a, b = src.simple_test(img), dst.simple_test(img)
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"reference checkpoint: {k} differs")
    out["reference_checkpoint"] = dict(
        keys=len(sd), detections=int(a["valid"].sum()),
        seconds=time.perf_counter() - t)
    del src, dst, a, b

    t = time.perf_counter()
    _, h, w = TWO_D_SHAPE
    level = torch.randn((1, 256, h // 8, w // 8), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(4))
    errs = {}
    for modulated in (False, True):
        torch.manual_seed(5)
        layer = DeformConv2dPack(256, 256, 3, modulated=modulated).double()
        with torch.no_grad():
            layer.conv_offset.weight.normal_(0.0, 0.02)
            layer.conv_offset.bias.uniform_(-2.0, 2.0)
        runs = []
        for dev in (device, torch.device("cpu")):
            lay = layer.to(dev)
            x = level.to(dev, copy=True).requires_grad_(True)
            y = lay(x)
            (y * y).mean().backward()
            runs.append((y.detach().cpu(), x.grad.cpu(),
                         lay.weight.grad.cpu(),
                         lay.conv_offset.weight.grad.cpu()))
            lay.zero_grad(set_to_none=True)
        key = "deform_conv2d_v2" if modulated else "deform_conv2d"
        errs[key] = [_rel_err(g, w_) for g, w_ in zip(*runs)]
    torch.manual_seed(6)
    pool = DeformRoIPoolingPack(out_size=7, out_channels=256,
                                spatial_scale=1.0 / 8,
                                modulated=True).double()
    with torch.no_grad():
        for fcs in (pool.offset_fcs, pool.mask_fcs):
            fcs[-1].weight.normal_(0.0, 0.02)
    rgen = torch.Generator().manual_seed(7)
    xy = torch.rand((128, 2), generator=rgen) * torch.tensor([w * 0.8,
                                                              h * 0.8])
    rois = torch.cat([torch.zeros((128, 1)), xy,
                      xy + 16 + torch.rand((128, 2), generator=rgen) * 200],
                     1).double()
    runs = []
    for dev in (device, torch.device("cpu")):
        p = pool.to(dev)
        x = level.to(dev, copy=True).requires_grad_(True)
        y = p(x, rois.to(dev))
        (y * y).mean().backward()
        runs.append((y.detach().cpu(), x.grad.cpu(),
                     p.offset_fcs[0].weight.grad.cpu()))
        p.zero_grad(set_to_none=True)
    errs["deform_roi_pool"] = [_rel_err(g, w_) for g, w_ in zip(*runs)]
    for k, e in errs.items():
        if not max(e) <= DCN_TOL:
            raise AssertionError(f"{k}: card against CPU (output, input "
                                 f"gradient, weight gradients) {e} > "
                                 f"{DCN_TOL}")
    out["dcn"] = dict(rel_err=errs, level=list(level.shape), rois=128,
                      dtype="float64", tol=DCN_TOL,
                      seconds=time.perf_counter() - t)
    return out


def run_two_d_phase(device):
    """Phase 19: each 2-D type's small check, card against CPU, then
    each at full width; the launches of TWO_D_CHECKED's steps each
    checked alone against the plain versions (as phases 6 and 9); the
    flagship's train step with and without with_cp; the 2-D host
    modules.  Returns (the per-type records, the checked launches)."""
    import torch

    t0 = time.perf_counter()
    records, checks = {}, {}
    for type_name in TWO_D:
        t = time.perf_counter()
        rec = {"small": check_small_two_d(device, type_name)}
        checked = type_name in TWO_D_CHECKED
        full, cap, train_cap = run_two_d(device, type_name, record=checked)
        rec.update(full)
        if checked:
            with torch.no_grad():
                checks[type_name] = {"inference": check_launches(
                    cap, two_d_calls(type_name, False),
                    f"{type_name} step")}
            checks[type_name]["train"] = check_train_step_kernels(
                train_cap, two_d_calls(type_name, True))
            del cap, train_cap
        rec["seconds"] = time.perf_counter() - t
        records[type_name] = rec
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with_cp = run_with_cp(device)
    with_cp["seconds"] = time.perf_counter() - t
    host = check_two_d_host_modules(device)
    emit({"phase": "two_d", "ok": True, "types": records,
          "kernel_checks": checks, "with_cp": with_cp,
          "host_modules": host, "seconds": time.perf_counter() - t0})
    return records, checks


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


def extras_keys(extras, checks, name, train_only=False):
    """Phase 18's keys of kernel `name` in the kernels line: each run's
    launches a step (extras_launches, by part) and, for the checked
    runs, the sums over their steps' launches."""
    parts = ("train",) if train_only else ("inference", "train")
    counts = {run: {k: r[k]["launches_per_step"][name] for k in parts
                    if k in r}
              for run, r in extras.items()}
    sums = {}
    for run, c in checks.items():
        for part, prefix in (("inference", "step"), ("train", "train_step")):
            if part in c and part in parts:
                sums.update(_path_sums(f"{run}_{prefix}", c[part][name]))
    return {"extras_launches": counts, **sums}


def kernels_line(nms_calls, align_calls, backward_calls, step_calls,
                 main_path, train_calls, train_path, tile_calls, wholevol,
                 learn, learn_calls, serve, serve_calls, variants,
                 variant_checks, families, family_checks, multicard,
                 extras, extras_checks, two_d, two_d_checks):
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
    served volume (serve_volume_*).  Each variant's launches a step
    (variant_launches_per_step, from its counted full-width runs), and
    for VARIANT_CHECKED the sums over its inference and train steps'
    launches (<type>_step_*, <type>_train_step_*); the same for the
    families (family_launches_per_step, and FAMILY_CHECKED's sums).  The
    multicard phase's: the data-parallel step's counted launches at
    world 1 under NCCL (multicard_launches) and each world-2 rank's per
    run (multicard_world2_launches).  Phase 18's: each backbone's, OHEM's
    and TTA's launches a step from its counted full-width runs
    (extras_launches), and for EXTRAS_CHECKED the sums over their steps'
    launches (<run>_step_*, <run>_train_step_*)."""
    profile = main_path["profile"] or {}

    def group_keys(prefix, records, checks, name, train_only=False):
        parts = ("train",) if train_only else ("inference", "train")
        per_step = {t: {k: r[k]["launches_per_step"][name] for k in parts}
                    for t, r in records.items()}
        sums = {}
        for t, c in checks.items():
            if not train_only:
                sums.update(_path_sums(f"{t}_step", c["inference"][name]))
            if "train" in c:
                sums.update(_path_sums(f"{t}_train_step", c["train"][name]))
        return {f"{prefix}_launches_per_step": per_step, **sums}

    def variant_keys(name, train_only=False):
        return {**group_keys("variant", variants, variant_checks, name,
                             train_only),
                **group_keys("family", families, family_checks, name,
                             train_only),
                **group_keys("two_d", two_d, two_d_checks, name,
                             train_only),
                **extras_keys(extras, extras_checks, name, train_only)}

    def multicard_keys(name):
        world1, world2 = multicard
        return {"multicard_launches": world1["runs"]["dp"]["launches"][name],
                "multicard_world2_launches": {
                    run: [r[name] for r in ranks]
                    for run, ranks in world2["launches"].items()}}

    def variant_errs(name, train_only=False):
        parts = ("train",) if train_only else ("inference", "train")
        return [c for checks in (variant_checks, family_checks,
                                 extras_checks, two_d_checks)
                for v in checks.values() for part in parts if part in v
                for c in v[part][name]]

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
                               + sum(paths.values(), [])
                               + variant_errs(name)),
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
            **variant_keys(name), **multicard_keys(name),
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
                           for c in calls + learn_back + backward_calls
                           + variant_errs("roi_align3d_backward", True)),
        **_step_sums(calls), "library_ms": None,
        "profiled_ms_per_step":
            train_profile.get("port_kernels_ms", {}).get(
                "roi_align3d_backward"),
        "matched": True, "per_step_calls": _per_call(calls),
        "learn_launches": learn["launches"]["roi_align3d_backward"],
        "learn_eval_launches": learn["eval_launches"]["roi_align3d_backward"],
        "serve_launches": serve["launches"]["roi_align3d_backward"],
        **_path_sums("learn_iter", learn_back),
        **variant_keys("roi_align3d_backward", True),
        **multicard_keys("roi_align3d_backward"),
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


def run_variants_phase(device):
    """Phase 15: the variants, card against CPU and at full width."""
    t = time.perf_counter()
    variants, checks = run_variants(device)
    emit({"phase": "variants", "ok": True, "types": variants,
          "kernel_checks": checks, "seconds": time.perf_counter() - t})
    return variants, checks


def run_families_phase(device):
    """Phase 16: the families, card against CPU and at full width."""
    t = time.perf_counter()
    families, checks = run_families(device)
    emit({"phase": "families", "ok": True, "types": families,
          "kernel_checks": checks, "seconds": time.perf_counter() - t})
    return families, checks


def run_learn_states(device, states):
    """The learn gate (check_learn_gradients) on `states` more detectors,
    each trained as run_learn trains its own (the pinned data, the
    config, LEARN_ITERS iterations) but from seeds LEARN_SEED + 1, + 2,
    ..., on the loader's first epoch: one line a state with each batch's
    largest relative gradient error and its module.  A state past the
    gate fails as phase 13 does."""
    import shutil
    import tempfile

    from mrcnn3d_torch.apis.train_api import train_detector
    from mrcnn3d_torch.tools import learning_bench as lb
    from mrcnn3d_torch.utils.config import Config

    if not states:
        return
    cfg = Config.fromfile(CONFIG)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_states_")
    try:
        data = lb.generate_pinned_data(workdir,
                                       cfg.get("upscale_factor", 1.5))
        batches = learn_epoch(cfg, data, device)
        for k in range(1, states + 1):
            t = time.perf_counter()
            state_dir = os.path.join(workdir, f"state{k}")
            os.makedirs(state_dir)
            state = train_detector(
                cfg, lb.train_dataset(cfg, data[1], data[2], LEARN_SEED),
                work_dir=state_dir, seed=LEARN_SEED + k,
                max_iters=LEARN_ITERS, log_interval=LEARN_ITERS,
                device=device, stats={})
            grads = check_learn_gradients(state, batches)["batches"]
            del state
            worst = [max(b["worst_grad_rel_err_by_module"].items(),
                         key=lambda kv: kv[1]) for b in grads]
            emit({"phase": "learn_state", "ok": True, "seed": LEARN_SEED + k,
                  "worst_rel_err_by_batch": worst,
                  "max_rel_err": max(v for _, v in worst),
                  "relu_ties": sum(len(b["relu_ties"]) for b in grads),
                  "align_max_abs_err": max(b["align_max_abs_err"]
                                           for b in grads),
                  "seconds": time.perf_counter() - t})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


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
    p.add_argument("--only",
                   choices=("train", "learn", "variants", "families",
                            "multicard", "extras", "two_d"),
                   help="run phases 1-2 and then only these")
    p.add_argument("--port", default=REPO,
                   help="the checkout whose mrcnn3d_torch is driven")
    p.add_argument("--learn-states", type=int, default=0,
                   help="with --only learn: hold this many more trained "
                        "detectors to the learn gate")
    args = p.parse_args(argv)
    if args.learn_states and args.only != "learn":
        p.error("--learn-states goes with --only learn")
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
        if args.only == "learn":
            run_learn_phases(device)
            run_learn_states(device, args.learn_states)
        elif args.only == "variants":
            run_variants_phase(device)
        elif args.only == "families":
            run_families_phase(device)
        elif args.only == "multicard":
            run_multicard_phase(device)
        elif args.only == "extras":
            run_extras_phase(device)
        elif args.only == "two_d":
            run_two_d_phase(device)
        else:
            run_train_phases(device)
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

    variants, variant_checks = run_variants_phase(device)

    families, family_checks = run_families_phase(device)

    multicard = run_multicard_phase(device)

    extras, extras_checks = run_extras_phase(device)

    two_d, two_d_checks = run_two_d_phase(device)

    emit(kernels_line(nms_calls, align_calls, backward_calls, step_calls,
                      main_path, train_calls, train_path, tile_calls,
                      wholevol, learn, learn_calls, serve, serve_calls,
                      variants, variant_checks, families, family_checks,
                      multicard, extras, extras_checks, two_d,
                      two_d_checks))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
