"""Two flakes of `chip_smoke.py`'s learn and serve phases, pinned on the
CPU.

The learn gate holds the trained detector's gradients through the
kernels against those through the plain versions, each parameter within
2e-3 of its largest.  K2's forward differs from its plain version in the
last bits, so a relu whose input lies within rounding of 0 can take the
other branch in the other pass; the unit's whole gradient term then
comes or goes.  `test_one_ulp_moves_the_mask_head_gradient` builds the
smallest such input: one aligned-feature voxel feeding a one-channel mask
head whose upsample unit sits at 0, where the next float32 below the
voxel's value moves the upsample weight's gradient by its whole largest
magnitude.  `ReluBranches` (the plain pass takes the kernel pass's
branch at ties) brings the two back within rounding, and reports the tie,
which `check_relu_ties` accepts; a branch flipped at a unit far from 0 it
refuses (`test_a_flip_off_a_tie_fails_the_gate`).

Beside the ties, the check pins cuDNN to its deterministic algorithms in
both passes (`PinnedCudnn`), holds every K2 forward launch of the kernel
pass against its plain version at K2's own gate (`AlignAgainstPlain`,
`check_align_output`), and on a failure reads which kernel's plain
version alone reproduces it (`PlainKernels` over one wrapper).

The serve phase compared the served detections with run_inference's and
failed as vacuous when 200 iterations left no score above the config's
score_thr; the comparison now also serves under `chip_smoke.serve_config`,
which keeps the top rows at any score.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    ALIGN_TOL,
    main,
    PIPELINE_ATOL,
    SERVE_MAX_DETS,
    TIE_TOL,
    AlignAgainstPlain,
    PinnedCudnn,
    PlainKernels,
    ReluBranches,
    check_align_output,
    check_relu_ties,
    serve_config,
    small_config,
)
from mrcnn3d_torch.apis.test_api import InferenceRunner
from mrcnn3d_torch.entry import build
from mrcnn3d_torch.models.heads import FCNMaskHead3D
from mrcnn3d_torch.ops import nms3d, roi_align3d
from mrcnn3d_torch.ops.losses import mask_cross_entropy
from torch_port_fixtures import torch_threads  # noqa: F401


def _tie_head():
    """A one-channel mask head (one 3x3x3 conv, the 2x upsample, the
    logits) whose upsample unit 0 has input exactly 0 when the aligned
    feature is 1: conv centre 1, upsample weight -1 there and bias 1."""
    head = FCNMaskHead3D(channels=1, num_classes=2, num_convs=1)
    with torch.no_grad():
        for p in head.parameters():
            p.zero_()
        head.convs[0].conv.weight[0, 0, 1, 1, 1] = 1.0
        head.upsample.weight.copy_(torch.tensor(
            [-1.0, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]).reshape(
                1, 1, 2, 2, 2))
        head.upsample.bias.fill_(1.0)
        head.conv_logits.weight.copy_(torch.tensor([0.5, -1.5]).reshape(
            2, 1, 1, 1, 1))
    return head


def _upsample_grad(head, x, branches=None):
    """The mask loss's gradient at the upsample weight for the aligned
    features x (1, 1, 1, 1, 1), and the pass's ReluBranches."""
    head.zero_grad(set_to_none=True)
    target = torch.ones(1, 2, 2, 2)
    with ReluBranches(branches) as relus:
        loss = mask_cross_entropy(head(x), target,
                                  torch.ones(1, dtype=torch.long))
    loss.backward()
    return head.upsample.weight.grad.clone(), relus


def test_one_ulp_moves_the_mask_head_gradient():
    head = _tie_head()
    x = torch.ones(1, 1, 1, 1, 1)
    below = torch.nextafter(x, torch.zeros(()))
    assert float(x - below) == 2.0 ** -24  # one float32 step
    g, rec = _upsample_grad(head, x)
    g1, _ = _upsample_grad(head, below)
    scale = float(g.abs().max())
    err = float((g1 - g).abs().max())
    # the unit's whole term comes in: far past the gate
    assert err > PIPELINE_ATOL * scale
    assert err > 0.1 * scale
    # taking the first pass's branch at the tie: within rounding
    g2, relus = _upsample_grad(head, below, branches=rec.branches)
    assert float((g2 - g).abs().max()) <= 1e-6 * scale
    assert [t["units"] for t in relus.ties] == [1]
    tie = relus.ties[0]
    assert tie["shape"] == [1, 1, 2, 2, 2]
    # one float32 step of an input whose call's largest is 3
    assert tie["max_abs_input"] == 2.0 ** -24
    assert tie["call_max_abs_input"] == pytest.approx(3.0)
    check_relu_ties(relus.ties, "one-ulp tie")


def test_a_flip_off_a_tie_fails_the_gate():
    """The upsample's unit 1 has input 1.5 of its call's largest 3: a
    branch taken against it there reads 0.5 of the call's largest, 5000
    times TIE_TOL, and the gate refuses it."""
    head = _tie_head()
    x = torch.ones(1, 1, 1, 1, 1)
    g, rec = _upsample_grad(head, x)
    up = [i for i, b in enumerate(rec.branches) if b.shape == (1, 1, 2, 2, 2)]
    assert len(up) == 1
    flipped = [b.clone() for b in rec.branches]
    flipped[up[0]].view(-1)[1] = False
    g1, relus = _upsample_grad(head, x, branches=flipped)
    assert float((g1 - g).abs().max()) > PIPELINE_ATOL * float(g.abs().max())
    assert len(relus.ties) == 1
    tie = relus.ties[0]
    assert tie["max_abs_input"] / tie["call_max_abs_input"] == \
        pytest.approx(0.5)
    assert tie["max_abs_input"] > 1000 * TIE_TOL * tie["call_max_abs_input"]
    with pytest.raises(AssertionError, match="off a tie"):
        check_relu_ties(relus.ties, "planted flip")


def test_relu_branches_keep_relu_off_ties():
    """Without ties ReluBranches is torch.relu, value and gradient."""
    relu = torch.relu
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    with ReluBranches() as rec:
        y = torch.relu(x)
    (y * torch.arange(6.0)).sum().backward()
    g = x.grad.clone()
    x.grad = None
    with ReluBranches(rec.branches) as again:
        y2 = torch.relu(x)
    (y2 * torch.arange(6.0)).sum().backward()
    assert torch.equal(y, torch.relu(x.detach())) and torch.equal(y, y2)
    assert torch.equal(g, x.grad) and not again.ties
    assert torch.relu is relu  # restored


def test_relu_branches_refuse_other_calls():
    with ReluBranches() as rec:
        torch.relu(torch.ones(3))
    with pytest.raises(AssertionError, match="differ in their relu calls"):
        with ReluBranches(rec.branches):
            torch.relu(torch.ones(4))


def test_serve_config_is_never_vacuous():
    """A detector whose every score is below the config's score_thr
    serves no row under the config, and its top SERVE_MAX_DETS rows under
    serve_config."""
    cfg = small_config()
    det = build(cfg, device="cpu", budgets=64)
    with torch.no_grad():
        det.model.bbox_head.fc_cls.bias.copy_(torch.tensor([8.0, -8.0]))
    rng = np.random.RandomState(3)
    sample = {"imgs": rng.randn(8, 32, 32, 3).astype(np.float32),
              "imgs_2": rng.randn(12, 48, 48, 3).astype(np.float32)}
    _, _, valid = InferenceRunner(cfg, det.model)(sample)[:3]
    assert not valid.any()
    served = serve_config(cfg)
    assert cfg.test_cfg["rcnn"]["score_thr"] == 0.2  # the config kept
    dets, _, valid = InferenceRunner(served, det.model)(sample)[:3]
    assert int(valid.sum()) == SERVE_MAX_DETS
    assert (dets[valid, 6] < 0.2).all()


def _align_args():
    """A one-level align's arguments (roi_align_3d_plain's), two rois."""
    g = torch.Generator().manual_seed(4)
    feats = [torch.randn(1, 4, 8, 8, 4, generator=g)]
    rois = torch.tensor([[0, 1.0, 2.0, 20.0, 25.0, 0.0, 5.0],
                         [0, 4.0, 3.0, 12.0, 30.0, 1.0, 7.0]])
    return (feats, rois, torch.zeros(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.bool), 7, 3, [4], [2], 2)


def test_align_gate_float32_and_bfloat16():
    want = torch.linspace(-8.0, 8.0, 64)
    assert check_align_output(want.clone(), want, "equal") == (
        0.0, ALIGN_TOL["float32"])
    got = want + 0.5 * ALIGN_TOL["float32"]
    # half the gate, to the float32 rounding of values up to 8
    assert check_align_output(got, want, "within")[0] == pytest.approx(
        0.5 * ALIGN_TOL["float32"], rel=1e-2)
    with pytest.raises(AssertionError, match="1 values differ"):
        bad = want.clone()
        bad[3] += 2 * ALIGN_TOL["float32"]
        check_align_output(bad, want, "one past")
    # bfloat16: one step of the value's binade passes, two do not
    w16 = torch.tensor([3.0, 100.0], dtype=torch.bfloat16)
    step = torch.tensor([2.0 ** -6, 2.0 ** -1])  # 2^(e - 8), e = 2 and 7
    check_align_output((w16.float() + step).to(torch.bfloat16), w16, "step")
    with pytest.raises(AssertionError, match="one bf16 step"):
        check_align_output((w16.float() + 2 * step).to(torch.bfloat16), w16,
                           "two steps")


def test_align_against_plain_holds_each_launch(monkeypatch):
    """The learn check's K2 wrapper passes a launch equal to its plain
    version and refuses one that a value moves past K2's gate."""
    args = _align_args()
    plain = roi_align3d.roi_align_3d_plain
    monkeypatch.setattr(roi_align3d, "roi_align_3d_cuda", plain)
    with AlignAgainstPlain() as aligns:
        out = roi_align3d.roi_align_3d_cuda(*args)
        roi_align3d.roi_align_3d_cuda(*args)
    assert roi_align3d.roi_align_3d_cuda is plain  # restored
    assert aligns.launches == 2 and aligns.max_abs_err == 0.0
    assert torch.equal(out, plain(*args))

    def off(*a):
        got = plain(*a)
        got.view(-1)[5] += 10 * ALIGN_TOL["float32"]
        return got

    monkeypatch.setattr(roi_align3d, "roi_align_3d_cuda", off)
    with pytest.raises(AssertionError, match="K2 in the learn check"):
        with AlignAgainstPlain():
            roi_align3d.roi_align_3d_cuda(*args)
    assert roi_align3d.roi_align_3d_cuda is off


def test_plain_kernels_swaps_the_named_wrappers():
    saved = {a: getattr(m, a) for m, a in (
        (nms3d, "greedy_scan_cuda"), (roi_align3d, "roi_align_3d_cuda"),
        (roi_align3d, "roi_align_3d_backward_cuda"))}
    with PlainKernels(("roi_align_3d_backward_cuda",)):
        assert roi_align3d.roi_align_3d_backward_cuda is \
            roi_align3d.roi_align_3d_backward_plain
        assert roi_align3d.roi_align_3d_cuda is saved["roi_align_3d_cuda"]
        assert nms3d.greedy_scan_cuda is saved["greedy_scan_cuda"]
    with PlainKernels():
        assert roi_align3d.roi_align_3d_cuda is roi_align3d.roi_align_3d_plain
        assert nms3d.greedy_scan_cuda is nms3d.greedy_scan_plain
    assert saved == {a: getattr(m, a) for m, a in (
        (nms3d, "greedy_scan_cuda"), (roi_align3d, "roi_align_3d_cuda"),
        (roi_align3d, "roi_align_3d_backward_cuda"))}


def test_pinned_cudnn_restores_the_flags():
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    try:
        cudnn.benchmark, cudnn.deterministic = True, False
        with PinnedCudnn():
            assert (cudnn.benchmark, cudnn.deterministic) == (False, True)
        assert (cudnn.benchmark, cudnn.deterministic) == (True, False)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def test_learn_states_go_with_the_learn_phase(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--learn-states", "2"])
    assert exc.value.code == 2
    assert "--learn-states goes with --only learn" in capsys.readouterr().err
