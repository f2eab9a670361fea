"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
with nvcc and skips elsewhere.  On the card (JAX not needed):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: keep masks exactly equal; RoIAlign 1e-4 in float32 and 2e-2
in bfloat16 (one rounding of the output; the sums run in float32 in
both versions); the small pipeline 2e-3 against the CPU.
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
