"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
with nvcc and skips elsewhere.  On the card (JAX not needed):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: keep masks exactly equal; RoIAlign 1e-4 in float32 and, in
bfloat16, 2e-2 or one bf16 step (one rounding of the output; the sums run
in float32 in both versions, in another order); the sample taps (voxels
and weights) exactly equal; the small pipeline and the mask stage 2e-3
against the CPU.  K2's backward: float32 gradients within 1e-4 of the
largest (float atomics add in an order that varies), bfloat16 levels'
gradients within one bf16 rounding; the small train step as
`chip_smoke.check_small_train` states.  The whole-volume path: the 1.5x
twin derived on the card within 1e-5 of the CPU's in float32 (one bf16
rounding apart in bfloat16), and the small tiled sweep as
`chip_smoke.check_small_tiled` states.
"""
import pytest
import torch

from mrcnn3d_torch.ops import nms3d
from mrcnn3d_torch.ops import roi_align3d as ra

pytestmark = pytest.mark.cuda

STRIDES = [4, 8, 16, 32]
STRIDES_D = [2, 4, 8, 16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _segments(gen, counts, device, ties):
    import chip_smoke

    parts = [chip_smoke.proposal_boxes(gen, k, (32, 128, 128), device)
             for k in counts]
    boxes, scores, valid = (torch.cat(p) for p in zip(*parts))
    if ties:
        scores = torch.floor(scores * 4) / 4
    return boxes, scores, valid


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_kernel_matches_plain(cuda, thr, ties):
    gen = torch.Generator(device=cuda).manual_seed(1)
    counts = [1, 63, 64, 65, 130, 700, 2000]
    boxes, scores, valid = _segments(gen, counts, cuda, ties)
    order = nms3d.segment_order(scores, valid, counts)
    sboxes, svalid = boxes[order].contiguous(), valid[order]
    before = nms3d.launches
    got = nms3d.greedy_scan_cuda(sboxes, svalid, counts, thr)
    assert nms3d.launches == before + 1
    want = nms3d.greedy_scan_plain(sboxes, svalid, counts, thr)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(valid.sum())


def test_nms_segments_card_vs_cpu(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    counts = [300, 17, 900]
    boxes, scores, valid = _segments(gen, counts, cuda, True)
    got = nms3d.nms_3d_mask_segments(boxes, scores, valid, counts, 0.5)
    want = nms3d.nms_3d_mask_segments(boxes.cpu(), scores.cpu(),
                                      valid.cpu(), counts, 0.5)
    assert torch.equal(got.cpu(), want)


def _rois(gen, n, device):
    """Rois over a 256 x 256 x 32 volume: every level, edge crossings,
    degenerate and oversized extents."""
    u = torch.rand((n, 6), generator=gen, device=device)
    x1 = u[:, 0] * 290 - 30
    y1 = u[:, 1] * 290 - 30
    z1 = u[:, 2] * 40 - 6
    w = torch.exp(u[:, 3] * 5.3 + 0.7)
    h = w * torch.exp(u[:, 4] * 1.4 - 0.7)
    d = torch.exp(u[:, 5] * 4.1)
    b = torch.randint(0, 2, (n,), generator=gen, device=device).float()
    rois = torch.stack([b, x1, y1, x1 + w, y1 + h, z1, z1 + d], 1)
    rois[:4, 3] = rois[:4, 1] - 3.0
    rois[4:8, 6] = rois[4:8, 5]
    rois[8:12, 1:5] = torch.tensor([-40.0, -40.0, 300.0, 300.0])
    return rois


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("out,out_d", [(7, 3), (14, 10)])
def test_roi_align_kernel_matches_plain(cuda, dtype, tol, out, out_d):
    gen = torch.Generator(device=cuda).manual_seed(3)
    feats = [
        torch.randn((2, 16 >> i, 64 >> i, 64 >> i, 64), generator=gen,
                    device=cuda).to(dtype)
        for i in range(4)
    ]
    rois = _rois(gen, 300, cuda)
    valid = torch.rand((300,), generator=gen, device=cuda) > 0.2
    levels = ra.map_roi_levels(rois, 4)
    assert set(levels[valid].tolist()) == {0, 1, 2, 3}
    args = (feats, rois, levels, valid, out, out_d, STRIDES, STRIDES_D, 2)
    before = ra.launches
    got = ra.roi_align_3d_cuda(*args)
    assert ra.launches == before + 1
    want = ra.roi_align_3d_plain(*args)
    assert got.dtype == dtype and got.shape == (300, 64, out_d, out, out)
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert not got[~valid].any()


def _align_matches(got, want, tol):
    diff = (got.float() - want.float()).abs()
    ok = diff <= tol
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(want.float())
        ok |= diff <= torch.ldexp(torch.ones_like(diff), e - 8)
    return bool(ok.all())


def _main_levels(gen, dtype, device, shape=(64, 512, 512)):
    """Random (B, D, H, W, C) levels of the 1.0x main path's shapes."""
    d, h, w = shape
    return [
        torch.randn((1, d // sd, h // s, w // s, 64), generator=gen,
                    device=device).to(dtype)
        for s, sd in zip(STRIDES, STRIDES_D)
    ]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kind", ["proposals", "direct"])
def test_roi_align_mask_geometry_2000_rois(cuda, dtype, tol, kind):
    """K2 at mask geometry (14x14x10) over 2000 valid rois, both paths
    counted as the kernel's window rule gives them."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(4)
    feats = _main_levels(gen, dtype, cuda)
    if kind == "direct":
        rois = chip_smoke.direct_rois(gen, 2000, (64, 512, 512), cuda)
    else:
        boxes, _, _ = chip_smoke.proposal_boxes(gen, 2000, (64, 512, 512),
                                                cuda)
        rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    valid = torch.ones(2000, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    args = (feats, rois, levels, valid, 14, 10, STRIDES, STRIDES_D, 2)
    ra.reset_path_counts()
    got = ra.roi_align_3d_cuda(*args)
    paths = ra.path_counts()
    assert paths == chip_smoke.align_geometry(*args)["paths"]
    assert paths["window"] + paths["direct"] == 2000
    if kind == "direct":
        assert paths["direct"] == 2000
    else:
        assert paths["window"] > paths["direct"] > 0
    assert _align_matches(got, ra.roi_align_3d_plain(*args), tol)


@pytest.mark.parametrize("out,out_d", [(7, 3), (14, 10)])
def test_roi_align_taps_match_plain(cuda, out, out_d):
    """The kernel (built with multiply-add contraction) samples the same
    voxels with the same weights as the plain version on the CPU, whose
    operations all round to nearest.  (PyTorch on the card divides by a
    Python scalar through its reciprocal, so the plain version's bin sizes
    there may differ from these in the last bit.)"""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(5)
    feats = [
        torch.zeros((2, 16 >> i, 64 >> i, 64 >> i, 64), device=cuda)
        for i in range(4)
    ]
    rois = _rois(gen, 500, cuda)
    levels = ra.map_roi_levels(rois, 4)
    lo, hi, wl, wh, inr = ra.sample_taps_cuda(
        feats, rois, levels, out, out_d, STRIDES, STRIDES_D, 2)
    want = chip_smoke.axis_taps(rois.cpu(), levels.cpu(), feats, out, out_d,
                                STRIDES, STRIDES_D, 2)
    lo, hi, wl, wh, inr = (t.cpu() for t in (lo, hi, wl, wh, inr))
    cols = [0, 2 * out, 4 * out, 4 * out + 2 * out_d]
    for axis, (w_lo, w_hi, w_wl, w_wh, w_in) in enumerate(want):
        a, b = cols[axis], cols[axis + 1]
        assert torch.equal(lo[:, a:b].long(), w_lo)
        assert torch.equal(hi[:, a:b].long(), w_hi)
        assert torch.equal(wl[:, a:b], w_wl)
        assert torch.equal(wh[:, a:b], w_wh)
        assert torch.equal(inr[:, a:b], w_in)


def test_mask_stage_aligns_valid_rows_only(cuda):
    """The mask stage hands K2 only the valid detection rows; the logits
    match the CPU, zeros in invalid slots."""
    import chip_smoke
    from mrcnn3d_torch.detectors import pipeline
    from mrcnn3d_torch.entry import build

    cfg = chip_smoke.small_config()
    gpu = build(cfg, device=cuda, budgets=64)
    cpu = build(cfg, device="cpu", budgets=64)
    gen = torch.Generator().manual_seed(6)
    feats = [torch.randn((1, 8, 8 >> i, 32 >> i, 32 >> i), generator=gen)
             for i in range(4)]
    xy = torch.rand((1, 40, 2), generator=gen) * 24
    z = torch.rand((1, 40, 1), generator=gen) * 6
    dets = torch.cat([xy, xy + 4 + torch.rand((1, 40, 2), generator=gen)
                      * 8, z, z + 1, torch.rand((1, 40, 1),
                                                generator=gen)], -1)
    dvalid = torch.rand((1, 40), generator=gen) > 0.4
    refined = torch.rand(40, generator=gen) > 0.5
    mcfg = cfg.model["mask_roi_extractor"]
    before = ra.launches
    ra.reset_path_counts()
    got = pipeline.mask_stage(
        gpu.model, [f.to(cuda).contiguous(
            memory_format=torch.channels_last_3d) for f in feats],
        dets.to(cuda), dvalid.to(cuda), refined.to(cuda), mcfg)
    paths = ra.path_counts()
    assert ra.launches == before + 1
    assert paths["window"] + paths["direct"] == int(dvalid.sum())
    want = pipeline.mask_stage(cpu.model, feats, dets, dvalid, refined,
                               mcfg)
    assert got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 2e-3
    assert not got[~dvalid.reshape(-1).to(cuda)].any()


def _scan(boxes, scores, valid, counts, thr):
    order = nms3d.segment_order(scores, valid, counts)
    sboxes, svalid = boxes[order].contiguous(), valid[order]
    before = nms3d.launches
    got = nms3d.greedy_scan_cuda(sboxes, svalid, counts, thr)
    assert nms3d.launches == before + 1
    assert got.dtype == torch.bool
    assert torch.equal(got, nms3d.greedy_scan_plain(sboxes, svalid, counts,
                                                    thr))
    return got


def test_nms_kernel_long_and_degenerate_segments(cuda):
    """4000 rows (two words per lane), an all-invalid segment, a segment
    where every box suppresses the others, and sizes 1, 64, 65, 2048."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    counts = [4000, 300, 500, 1, 64, 65, 2048]
    boxes, scores, valid = _segments(gen, counts, cuda, False)
    valid[4000:4300] = False
    boxes[4300:4800] = torch.tensor([10.0, 10.0, 40.0, 40.0, 2.0, 9.0],
                                    device=cuda)
    valid[4300:4800] = True
    got = _scan(boxes, scores, valid, counts, 0.5)
    assert not got[4000:4300].any()
    assert int(got[4300:4800].sum()) == 1
    assert 0 < int(got[:4000].sum()) < int(valid[:4000].sum())


def test_wrapper_refuses_mixed_devices(cuda):
    feats = [torch.zeros((1, 4, 8, 8, 8), device=cuda)]
    rois = torch.zeros((3, 7))
    with pytest.raises(ValueError):
        ra.roi_align_3d_cuda(feats, rois, torch.zeros(3, dtype=torch.int32),
                             torch.ones(3, dtype=torch.bool), 7, 3, [4],
                             [2], 2)


def test_small_pipeline_card_vs_cpu(cuda):
    import chip_smoke

    result = chip_smoke.check_small_pipeline(cuda)
    assert result["rpn"]["detections"] > 4


# ---------------------------------------------------------------------------
# K2's backward and the train step
# ---------------------------------------------------------------------------


def _backward_matches(got, want, tol=1e-4):
    """float32 gradients within tol of the largest (float atomics add in
    an order that varies)."""
    scale = max(float(w.abs().max()) for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g - w).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out,out_d", [(7, 3), (14, 10)])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, out, out_d):
    """Rois over every level, with edge crossings, degenerate extents and
    invalid rois; with no valid roi the gradient is zero."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    shapes = [(2, 16 >> i, 64 >> i, 64 >> i, 64) for i in range(4)]
    rois = _rois(gen, 300, cuda)
    valid = torch.rand((300,), generator=gen, device=cuda) > 0.2
    levels = ra.map_roi_levels(rois, 4)
    assert set(levels[valid].tolist()) == {0, 1, 2, 3}
    grad = torch.randn((300, 64, out_d, out, out), generator=gen,
                       device=cuda).to(dtype)
    args = (grad, shapes, rois, levels, valid, out, out_d, STRIDES,
            STRIDES_D, 2)
    before = ra.backward_launches
    got = ra.roi_align_3d_backward_cuda(*args)
    assert ra.backward_launches == before + 1
    _backward_matches(got, ra.roi_align_3d_backward_plain(*args))
    none = ra.roi_align_3d_backward_cuda(grad, shapes, rois, levels,
                                         torch.zeros_like(valid), out, out_d,
                                         STRIDES, STRIDES_D, 2)
    assert not any(bool(g.any()) for g in none)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_one_spot(cuda, dtype):
    """150 rois on one spot, beside 150 spread ones: their windows add to
    the same voxels at once."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    shapes = [(2, 16 >> i, 64 >> i, 64 >> i, 64) for i in range(4)]
    rois = _rois(gen, 300, cuda)
    rois[:150] = torch.tensor([1.0, 60.0, 70.0, 84.0, 90.0, 10.0, 14.0],
                              device=cuda)
    rois[:150, 1:] += torch.rand((150, 6), generator=gen, device=cuda)
    valid = torch.ones(300, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    grad = torch.randn((300, 64, 10, 14, 14), generator=gen,
                       device=cuda).to(dtype)
    args = (grad, shapes, rois, levels, valid, 14, 10, STRIDES, STRIDES_D,
            2)
    _backward_matches(ra.roi_align_3d_backward_cuda(*args),
                      ra.roi_align_3d_backward_plain(*args))


@pytest.mark.parametrize("kind", ["proposals", "direct"])
def test_roi_align_backward_main_geometry(cuda, kind):
    """At mask geometry on the 1.0x main path's levels, rois that K2's
    forward stages in its window and rois it reads directly."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(9)
    shapes = [tuple(f.shape) for f in _main_levels(gen, torch.bfloat16,
                                                   cuda)]
    if kind == "direct":
        rois = chip_smoke.direct_rois(gen, 1000, (64, 512, 512), cuda)
    else:
        boxes, _, _ = chip_smoke.proposal_boxes(gen, 1000, (64, 512, 512),
                                                cuda)
        rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    valid = torch.ones(1000, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    grad = torch.randn((1000, 64, 10, 14, 14), generator=gen,
                       device=cuda).to(torch.bfloat16)
    args = (grad, shapes, rois, levels, valid, 14, 10, STRIDES, STRIDES_D,
            2)
    _backward_matches(ra.roi_align_3d_backward_cuda(*args),
                      ra.roi_align_3d_backward_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_function_gradient_matches_plain_autograd(cuda, dtype):
    """RoIAlign3DFunction on the card (K2 and its backward, one launch
    each) against torch.autograd of the plain version on the CPU in
    float32, on NCDHW channels_last_3d levels as the detector gives
    them; bfloat16 levels get a bfloat16 gradient (one rounding)."""
    from mrcnn3d_torch.ops.roi_align3d import multi_level_roi_align_3d

    gen = torch.Generator().manual_seed(10)
    base = [torch.randn((2, 8, 16 >> i, 64 >> i, 64 >> i), generator=gen)
            for i in range(4)]
    rois = _rois(torch.Generator(device=cuda).manual_seed(11), 60, cuda)
    valid = torch.rand((60,), generator=gen) > 0.2
    weights = torch.randn((60, 8, 3, 7, 7), generator=gen)
    feats = [b.to(cuda, dtype).contiguous(
        memory_format=torch.channels_last_3d).requires_grad_(True)
        for b in base]
    launches, backward = ra.launches, ra.backward_launches
    out = multi_level_roi_align_3d(feats, rois, 7, 3, STRIDES, STRIDES_D, 2,
                                   valid=valid.to(cuda))
    (out.float() * weights.to(cuda)).sum().backward()
    assert (ra.launches, ra.backward_launches) == (launches + 1,
                                                   backward + 1)
    leaves = [b.to(dtype).float().permute(0, 2, 3, 4, 1).requires_grad_(True)
              for b in base]
    levels = ra.map_roi_levels(rois.cpu(), 4)
    want = ra.roi_align_3d_plain(leaves, rois.cpu(), levels, valid, 7, 3,
                                 STRIDES, STRIDES_D, 2)
    (want * weights).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -8
    scale = max(float(leaf.grad.abs().max()) for leaf in leaves)
    for f, leaf in zip(feats, leaves):
        assert f.grad.dtype == dtype
        got = f.grad.float().cpu().permute(0, 2, 3, 4, 1)
        assert float((got - leaf.grad).abs().max()) <= tol * scale


def test_train_step_on_card(cuda):
    """One train step of the narrow flagship on the card: 2 K1, 5 K2 and
    5 backward launches, finite losses, every parameter group moved."""
    import chip_smoke
    from mrcnn3d_torch.entry import build_trainer

    trainer = build_trainer(chip_smoke.small_train_config(), device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in chip_smoke.small_train_batch(3).items()}
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    counts = (nms3d.launches, ra.launches, ra.backward_launches)
    losses = trainer.step(batch)
    after = (nms3d.launches, ra.launches, ra.backward_launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (2, 5, 5)
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    moved = {n.split(".")[0] for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == {n.split(".")[0] for n in before}


def test_small_train_card_vs_cpu(cuda):
    import chip_smoke

    result = chip_smoke.check_small_train(cuda)
    assert result["draws"] == 20 and max(result["positives"]) > 0


# ---------------------------------------------------------------------------
# whole-volume inference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((16, 64, 64), (24, 96, 96)),
                                       ((9, 30, 41), (13, 45, 61)),
                                       ((20, 40, 40), (7, 33, 50))])
def test_twin_card_vs_cpu(cuda, shape, out):
    from mrcnn3d_torch.ops.resize3d import resize_trilinear_3d

    gen = torch.Generator().manual_seed(12)
    vol = torch.randn((1, 3, *shape), generator=gen)
    got = resize_trilinear_3d(vol.to(cuda), out).cpu()
    want = resize_trilinear_3d(vol, out)
    assert float((got - want).abs().max()) <= 1e-5
    vb = vol.to(torch.bfloat16)
    got = resize_trilinear_3d(vb.to(cuda), out).cpu()
    want = resize_trilinear_3d(vb, out)
    assert got.dtype == torch.bfloat16
    assert _align_matches(got, want, 0.0)


def test_small_tiled_card_vs_cpu(cuda):
    import chip_smoke

    before = (nms3d.launches, ra.launches)
    result = chip_smoke.check_small_tiled(cuda)
    assert result["detections"] > 4
    # 27 tiles on the card, each 3 K1 and 4 K2 launches
    assert (nms3d.launches - before[0], ra.launches - before[1]) == (81, 108)


def test_path_counts_reset_after_a_launch_in_inference_mode(cuda):
    """K2's path counter made by a first launch under inference_mode (as
    `Flagship.run` and `tiled` launch it) can be reset afterwards."""
    feats = [torch.zeros((1, 2, 8, 8, 32), device=cuda)]
    rois = torch.tensor([[0.0, 1.0, 1.0, 6.0, 6.0, 0.0, 1.0]], device=cuda)
    one = torch.ones(1, dtype=torch.bool, device=cuda)
    ra.path_rois.clear()
    with torch.inference_mode():
        ra.roi_align_3d_cuda(feats, rois, torch.zeros(1, dtype=torch.int32,
                                                      device=cuda), one, 7,
                             3, [4], [2], 2)
    assert ra.path_counts() == {"window": 1, "direct": 0}
    ra.reset_path_counts()
    assert ra.path_counts() == {"window": 0, "direct": 0}


# ---------------------------------------------------------------------------
# the 3-D two-stage variants
# ---------------------------------------------------------------------------


VARIANTS = ("RPN3D", "FasterRCNN3D", "MaskRCNN3D", "MaskRCNN3DParcel",
            "MaskRCNN3D2ScalesHeads", "MaskRCNN3D2ScalesHeadsRefinementHead",
            "MaskRCNN3D3ScalesHeads", "MaskRCNN3D3ScalesOnePathway",
            "MaskRCNN3D2ScalesOnePathwayOneRPN")


@pytest.mark.parametrize("type_name", VARIANTS)
def test_variant_small_card_vs_cpu(cuda, type_name):
    """Each variant at the narrow widths, inference and a train step, on
    the card against the CPU, with its launches a step as
    `chip_smoke.VARIANT_LAUNCHES` says (`chip_smoke.check_small_variant`)."""
    import chip_smoke

    assert chip_smoke.VARIANTS == VARIANTS
    result = chip_smoke.check_small_variant(cuda, type_name)
    assert result["detections"] > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_roi_align_third_pathway_2000_rois(cuda, dtype, tol):
    """K2 at bbox geometry on the pyramid of the three-scale types' 2.25x
    volume (144x1152x1152 at inference), 2000 proposal-like rois, both
    paths counted as the kernel's window rule gives them."""
    import chip_smoke

    shape = (144, 1152, 1152)
    gen = torch.Generator(device=cuda).manual_seed(14)
    feats = _main_levels(gen, dtype, cuda, shape)
    boxes, _, _ = chip_smoke.proposal_boxes(gen, 2000, shape, cuda)
    rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    valid = torch.ones(2000, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    args = (feats, rois, levels, valid, 7, 3, STRIDES, STRIDES_D, 2)
    ra.reset_path_counts()
    got = ra.roi_align_3d_cuda(*args)
    paths = ra.path_counts()
    assert paths == chip_smoke.align_geometry(*args)["paths"]
    assert paths["window"] + paths["direct"] == 2000
    assert _align_matches(got, ra.roi_align_3d_plain(*args), tol)


def test_roi_align_backward_third_pathway(cuda):
    """K2's backward at bbox geometry on the three-scale train step's
    2.25x pyramid (144x288x288, batch 2), 1024 rois in bf16."""
    import chip_smoke

    shape = (144, 288, 288)
    gen = torch.Generator(device=cuda).manual_seed(15)
    shapes = [(2, shape[0] // sd, shape[1] // s, shape[2] // s, 64)
              for s, sd in zip(STRIDES, STRIDES_D)]
    boxes, _, _ = chip_smoke.proposal_boxes(gen, 1024, shape, cuda)
    rois = torch.cat([(torch.arange(1024, device=cuda) % 2)[:, None]
                      .float(), boxes], 1)
    valid = torch.ones(1024, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    grad = torch.randn((1024, 64, 3, 7, 7), generator=gen,
                       device=cuda).to(torch.bfloat16)
    args = (grad, shapes, rois, levels, valid, 7, 3, STRIDES, STRIDES_D, 2)
    _backward_matches(ra.roi_align_3d_backward_cuda(*args),
                      ra.roi_align_3d_backward_plain(*args))


# ---------------------------------------------------------------------------
# the single-stage and cascade families
# ---------------------------------------------------------------------------


FAMILIES = ("RetinaNet3D", "CascadeRCNN3D", "HybridTaskCascade3D")


@pytest.mark.parametrize("type_name", FAMILIES)
def test_family_small_card_vs_cpu(cuda, type_name):
    """Each family at the narrow widths, inference and a train step, on
    the card against the CPU, with its launches a step as
    `chip_smoke.FAMILY_LAUNCHES` says (`chip_smoke.check_small_family`)."""
    import chip_smoke

    assert chip_smoke.FAMILIES == FAMILIES
    result = chip_smoke.check_small_family(cuda, type_name)
    assert result["detections"] > 0


def _semantic_args(gen, dtype, device, n, out, out_d):
    """HTC's semantic align on the 1.0x headline volume: the one
    stride-8 level (16x64x64), n proposal-like rois, every roi mapped to
    that level."""
    import chip_smoke

    shape = (64, 512, 512)
    sem = torch.randn((1, 16, 64, 64, 64), generator=gen,
                      device=device).to(dtype)
    boxes, _, _ = chip_smoke.proposal_boxes(gen, n, shape, device)
    rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    valid = torch.rand((n,), generator=gen, device=device) > 0.1
    levels = ra.map_roi_levels(rois, 1)
    assert not levels.any()
    return ([sem], rois, levels, valid, out, out_d, [8], [4], 2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_roi_align_one_level_semantic_map(cuda, dtype, tol):
    """K2 at the semantic extractor's 14x14x10 over 2000 rois on the one
    stride-8 level, both paths counted as the kernel's window rule gives
    them; the backward into that level as the plain version's."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(16)
    args = _semantic_args(gen, dtype, cuda, 2000, 14, 10)
    ra.reset_path_counts()
    got = ra.roi_align_3d_cuda(*args)
    paths = ra.path_counts()
    assert paths == chip_smoke.align_geometry(*args)["paths"]
    assert paths["window"] + paths["direct"] == int(args[3].sum())
    assert _align_matches(got, ra.roi_align_3d_plain(*args), tol)
    grad = torch.randn(got.shape, generator=gen, device=cuda).to(dtype)
    bargs = (grad, [args[0][0].shape], *args[1:])
    _backward_matches(ra.roi_align_3d_backward_cuda(*bargs),
                      ra.roi_align_3d_backward_plain(*bargs))


def test_nms_sigmoid_classwise_4256_rows(cuda):
    """K1 on RetinaNet3D's class-wise problem: one 4256-row segment an
    image (1000 anchors on levels 0-3, 256 on level 4) of sigmoid scores,
    two images in one launch, keep masks equal to the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    counts = [4256, 4256]
    boxes, scores, valid = _segments(gen, counts, cuda, False)
    scores = torch.sigmoid(scores)
    order = nms3d.segment_order(scores, valid, counts)
    sboxes, svalid = boxes[order].contiguous(), valid[order]
    got = nms3d.greedy_scan_cuda(sboxes, svalid, counts, 0.5)
    assert torch.equal(got, nms3d.greedy_scan_plain(sboxes, svalid, counts,
                                                    0.5))
    assert 0 < int(got.sum()) < int(valid.sum())


# ---------------------------------------------------------------------------
# the other backbones' pyramids
# ---------------------------------------------------------------------------


# UNet3D's taps: strides 1, 2, 4, 8 on every axis
UNET_STRIDES = [1, 2, 4, 8]


def _unet_levels(gen, dtype, device, shape):
    d, h, w = shape
    return [torch.randn((1, d // s, h // s, w // s, 64), generator=gen,
                        device=device).to(dtype) for s in UNET_STRIDES]


def _far_rois(gen, n, shape, device):
    """Rois over the whole volume, half of them in its last quarter of
    depth (the far end of each level's storage)."""
    d, h, w = shape
    u = torch.rand((n, 6), generator=gen, device=device)
    x1, y1 = u[:, 0] * (w - 40), u[:, 1] * (h - 40)
    z1 = u[:, 2] * (d - 8)
    z1[: n // 2] = d * 0.75 + u[: n // 2, 2] * (d * 0.25 - 8)
    size = 4 + u[:, 3] * 32
    rois = torch.stack([torch.zeros_like(x1), x1, y1, x1 + size, y1 + size,
                        z1, z1 + 2 + u[:, 4] * 6], 1)
    return rois


@pytest.mark.parametrize("out,out_d", [(7, 3), (14, 10)])
def test_roi_align_unet_level0_past_2_31(cuda, out, out_d):
    """K2 on UNet3D's pyramid of the 96x768x768 twin in bf16 (level 0,
    64 channels at stride 1: 3.6e9 elements, past 2^31), at UNet3D's own
    strides, rois reaching the far end of each level: against the plain
    version."""
    shape = (96, 768, 768)
    gen = torch.Generator(device=cuda).manual_seed(21)
    feats = _unet_levels(gen, torch.bfloat16, cuda, shape)
    assert feats[0].numel() > 2**31
    rois = _far_rois(gen, 500, shape, cuda)
    valid = torch.ones(500, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    assert int((levels == 0).sum()) > 100
    args = (feats, rois, levels, valid, out, out_d, UNET_STRIDES,
            UNET_STRIDES, 2)
    got = ra.roi_align_3d_cuda(*args)
    assert _align_matches(got, ra.roi_align_3d_plain(*args), 2e-2)


def test_roi_align_backward_unet_level0(cuda):
    """K2's backward on UNet3D's pyramid of the 64x512x512 headline volume
    (level 0: 1.07e9 elements, 4.3 GB of float32 gradient), bf16 levels,
    at mask and bbox geometry, rois reaching the far end."""
    shape = (64, 512, 512)
    gen = torch.Generator(device=cuda).manual_seed(22)
    shapes = [tuple(f.shape) for f in
              _unet_levels(gen, torch.bfloat16, cuda, shape)]
    rois = _far_rois(gen, 500, shape, cuda)
    valid = torch.ones(500, dtype=torch.bool, device=cuda)
    levels = ra.map_roi_levels(rois, 4)
    for out, out_d in ((7, 3), (14, 10)):
        grad = torch.randn((500, 64, out_d, out, out), generator=gen,
                           device=cuda).to(torch.bfloat16)
        args = (grad, shapes, rois, levels, valid, out, out_d, UNET_STRIDES,
                UNET_STRIDES, 2)
        _backward_matches(ra.roi_align_3d_backward_cuda(*args),
                          ra.roi_align_3d_backward_plain(*args))


def test_roi_align_resnext_pyramid(cuda):
    """K2 and its backward on the FPN pyramid of the flagship with
    ResNeXt3D-50 at full width (seed 0's weights) on a 64x512x512 volume,
    bf16, at bbox and mask geometry: against the plain versions."""
    import chip_smoke
    from mrcnn3d_torch.entry import build

    cfg = chip_smoke.backbone_recipe(chip_smoke.main_config(),
                                     "ResNeXt3D-50")
    det = build(cfg, device=cuda, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((1, 3, 64, 512, 512), generator=gen,
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        feats = ra.channels_last_levels(det.model.extract_feat(x)[:4])
    boxes, _, valid = chip_smoke.proposal_boxes(gen, 1000, (64, 512, 512),
                                                cuda)
    rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    levels = ra.map_roi_levels(rois, 4)
    shapes = [tuple(f.shape) for f in feats]
    for out, out_d in ((7, 3), (14, 10)):
        args = (feats, rois, levels, valid, out, out_d, STRIDES, STRIDES_D,
                2)
        assert _align_matches(ra.roi_align_3d_cuda(*args),
                              ra.roi_align_3d_plain(*args), 2e-2)
        grad = torch.randn((1000, 64, out_d, out, out), generator=gen,
                           device=cuda).to(torch.bfloat16)
        bargs = (grad, shapes, rois, levels, valid, out, out_d, STRIDES,
                 STRIDES_D, 2)
        _backward_matches(ra.roi_align_3d_backward_cuda(*bargs),
                          ra.roi_align_3d_backward_plain(*bargs))


@pytest.mark.parametrize("name", ["ResNet3D-18", "ResNeXt3D-50", "UNet3D",
                                  "OHEM", "TTA"])
def test_extras_small_card_vs_cpu(cuda, name):
    """Each phase-18 run at the narrow widths, inference and (but for
    TTA) a train step, on the card against the CPU, with its launches a
    step as chip_smoke.EXTRAS_LAUNCHES says."""
    import chip_smoke

    assert chip_smoke.check_small_extra(cuda, name)["detections"] > 0


TWO_D = ("RPN", "FasterRCNN", "FastRCNN", "MaskRCNN", "RetinaNet",
         "CascadeRCNN", "HybridTaskCascade")


@pytest.mark.parametrize("type_name", TWO_D)
def test_two_d_small_card_vs_cpu(cuda, type_name):
    """Each 2-D type at the narrow recipe, inference and a train step
    (max-pool and relu ties replayed), on the card against the CPU, with
    its launches a step as `chip_smoke.TWO_D_LAUNCHES` says
    (`chip_smoke.check_small_two_d`)."""
    import chip_smoke

    assert chip_smoke.TWO_D == TWO_D
    result = chip_smoke.check_small_two_d(cuda, type_name)
    assert result["detections"] > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_roi_align_depth_one_levels(cuda, dtype, tol):
    """K2 on the 2-D family's depth-1 levels (256 channels of a 1x64x96
    image's FPN, strides 4-32, depth stride 1), out 7x7x1 and 14x14x1,
    boxes with z [0, 0]: both taps in z clamp to the one slice; against
    the plain version computed on the CPU."""
    from mrcnn3d_torch.ops import roi_align3d as ra

    gen = torch.Generator().manual_seed(21)
    feats = [torch.randn(1, 1, 64 // s, 96 // s, 256, generator=gen)
             for s in (4, 8, 16, 32)]
    n = 300
    xy = torch.rand(n, 2, generator=gen) * torch.tensor([80.0, 50.0])
    wh = 2 + torch.rand(n, 2, generator=gen) * 60
    rois = torch.cat([torch.zeros(n, 1), xy, xy + wh, torch.zeros(n, 2)], 1)
    levels = ra.map_roi_levels(rois, 4)
    valid = torch.ones(n, dtype=torch.bool)
    for out in (7, 14):
        args = ([f.to(dtype) for f in feats], rois, levels, valid, out, 1,
                [4, 8, 16, 32], [1, 1, 1, 1], 2)
        want = ra.roi_align_3d_plain(*args)
        got = ra.roi_align_3d_cuda(*(
            [f.to(cuda) for f in args[0]], *(a.to(cuda) for a in args[1:4]),
            *args[4:]))
        assert got.shape == want.shape
        err = float((got.float().cpu() - want.float()).abs().max())
        assert err <= tol * max(1.0, float(want.float().abs().max())), err
