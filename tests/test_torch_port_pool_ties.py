"""The max-pool tie replay of `chip_smoke.py`'s narrow train checks,
pinned on the CPU.

The card's and the CPU's convolutions round differently, so a max-pool
window whose two largest inputs lie within rounding of each other can
choose another voxel on each device; the window's whole gradient then
goes to another voxel, which moved the stem conv's update by about 1% of
its largest.  `PoolArgmax` makes the CPU pass take the card's argmax
(value and gradient) and records each window where the two differ;
`check_pool_ties` accepts such a flip only when both choices' values lie
within TIE_TOL of the call's largest input, and names the call, the
window and both values otherwise.
"""
import numpy as np
import pytest
import torch
from torch import nn

from chip_smoke import (
    TIE_TOL,
    UPDATE_TOL,
    PoolArgmax,
    check_pool_ties,
)
from mrcnn3d_torch.models.backbones_extra import ResNeXt3D, UNet3D
from mrcnn3d_torch.models.resnet3d import ResNet3D


class _Pooled(nn.Module):
    """A (1, 3, 3) stride-(1, 2, 2) max-pool (the 2-D stem's) between a
    scale and a sum weighted per output voxel."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))
        self.pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))

    def forward(self, x):
        y = self.pool(x * self.scale)
        w = torch.arange(1, y.numel() + 1, dtype=y.dtype).view(y.shape)
        return (y * w).sum()


def _tie_input(step=0.0):
    """A (1, 1, 1, 4, 4) input whose first window holds its maximum 2.0
    twice, at (0, 0) and at (0, 1); `step` raises the second by that."""
    x = torch.zeros(1, 1, 1, 4, 4)
    x[0, 0, 0, 0, 0] = 2.0
    x[0, 0, 0, 0, 1] = 2.0 + step
    x[0, 0, 0, 3, 3] = 3.0
    return x


def _pass(x, take=None):
    """The input's gradient, the scale's, and the pass's PoolArgmax."""
    model = _Pooled()
    x = x.clone().requires_grad_(True)
    with PoolArgmax(model, take) as rec:
        loss = model(x)
    loss.backward()
    return x.grad, model.scale.grad, rec


def test_one_ulp_flips_the_window():
    """One float32 step above the tie moves the window's argmax, and
    with it the whole window's gradient, to the other voxel."""
    g0, _, rec0 = _pass(_tie_input())
    g1, _, rec1 = _pass(_tie_input(2.0 ** -22))
    assert int(rec0.indices[0].flatten()[0]) == 0
    assert int(rec1.indices[0].flatten()[0]) == 1
    # the first window's term (weight 1) moves from (0, 0) to (0, 1),
    # which the second window (weight 2) takes in both passes
    assert float(g0[0, 0, 0, 0, 0]) == 1.0 and float(g1[0, 0, 0, 0, 0]) == 0
    assert float(g1[0, 0, 0, 0, 1] - g0[0, 0, 0, 0, 1]) == 1.0


def test_replay_routes_the_gradient_to_the_other_pass_argmax():
    """Taking the first pass's argmax, the second pass's gradient is the
    first's exactly; the flip is recorded with its window and values,
    and check_pool_ties accepts it."""
    g0, s0, rec0 = _pass(_tie_input())
    g1, s1, rec1 = _pass(_tie_input(2.0 ** -22), take=rec0.indices)
    assert torch.equal(g1, g0)
    assert float(s1) == pytest.approx(float(s0), rel=1e-6)
    assert [f["windows"] for f in rec1.flips] == [1]
    flip = rec1.flips[0]
    assert flip["call"] == 0 and flip["window"] == [0, 0, 0, 0, 0]
    assert flip["own_max"] == 2.0 + 2.0 ** -22
    assert flip["other_choice"] == 2.0
    assert flip["max_abs_diff"] == 2.0 ** -22
    assert flip["call_max_abs_input"] == 3.0
    check_pool_ties(rec1.flips, "one-ulp tie")


def test_a_flip_off_a_tie_fails():
    """A recorded argmax that points at a voxel far below the window's
    maximum (0.0 against 2.0, 2/3 of the call's largest) is refused,
    naming the call, the window and both values."""
    _, _, rec0 = _pass(_tie_input())
    forged = [i.clone() for i in rec0.indices]
    forged[0].view(-1)[0] = 4  # (1, 0): a zero of the first window
    _, _, rec1 = _pass(_tie_input(), take=forged)
    assert rec1.flips[0]["other_choice"] == 0.0
    with pytest.raises(AssertionError, match="off a tie") as err:
        check_pool_ties(rec1.flips, "forged")
    assert "'window': [0, 0, 0, 0, 0]" in str(err.value)


def test_tie_tolerance_is_relative_to_the_call():
    """The rule scales with the call's largest input: the same flip of
    1e-3 is a tie in a call whose largest is 100, not in one of 3."""
    flip = dict(max_abs_diff=1e-3, call_max_abs_input=100.0)
    check_pool_ties([flip], "large call")
    assert 1e-3 > TIE_TOL * 3.0
    with pytest.raises(AssertionError):
        check_pool_ties([dict(flip, call_max_abs_input=3.0)], "small call")


def test_passes_with_other_pool_calls_fail():
    model = _Pooled()
    with pytest.raises(AssertionError, match="differ in their max-pool"):
        with PoolArgmax(model, take=[]):
            model(_tie_input())


def _backbone(kind):
    torch.manual_seed(0)
    if kind == "resnet3d":
        return ResNet3D(depth=18, base_width=4), (1, 3, 8, 32, 32), 1
    if kind == "resnet2d":
        return (ResNet3D(depth=18, base_width=4, two_d=True),
                (1, 3, 1, 32, 32), 1)
    if kind == "resnext2d":
        return (ResNeXt3D(depth=50, width=4, groups=2, base_width=4,
                          two_d=True), (1, 3, 1, 32, 32), 1)
    return UNet3D(base_channels=4), (1, 3, 8, 16, 16), 3


@pytest.mark.parametrize("kind",
                         ["resnet3d", "resnet2d", "resnext2d", "unet3d"])
def test_backbone_pools_are_exact_without_flips(kind):
    """Every max-pool call of each backbone (UNet3D: three) runs under
    PoolArgmax, and with its own argmax the outputs and the input's
    gradient equal the plain pools' bit for bit."""
    model, shape, calls = _backbone(kind)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))

    def run(wrap):
        xx = x.clone().requires_grad_(True)
        if wrap:
            with PoolArgmax(model) as rec:
                outs = model(xx)
        else:
            outs, rec = model(xx), None
        sum(o.sum() * (i + 1) for i, o in enumerate(outs)).backward()
        return [o.detach() for o in outs], xx.grad, rec

    plain, g_plain, _ = run(False)
    got, g_got, rec = run(True)
    assert len(rec.indices) == calls and not rec.flips
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(g_got, g_plain)


def test_two_d_stem_pool_replays_a_tie():
    """The 2-D ResNet's (1, 3, 3) stem pool under the replay: its input
    nudged by one float32 step at one voxel of a tied window, the
    replayed pass's stem gradient equals the first pass's."""
    model = ResNet3D(depth=18, base_width=4, two_d=True)
    assert model.maxpool.kernel_size == (1, 3, 3)
    stem = {}

    def grab(mod, inp, out):
        stem["in"] = inp[0]

    model.maxpool.register_forward_hook(grab)
    x = torch.randn(1, 3, 1, 32, 32,
                    generator=torch.Generator().manual_seed(2))

    def run(take=None, tie=False):
        with PoolArgmax(model, take) as rec:
            if tie:
                # a forward pre-hook makes pool input voxels (0, 0) and
                # (0, 1) of channel 0 the window's maximum, equal; the
                # second pass raises (0, 1) by one float32 step
                def pre(mod, inp):
                    y = inp[0].clone()
                    top = y.detach().abs().max() + 1.0
                    y[0, 0, 0, 0, 0] = top
                    y[0, 0, 0, 0, 1] = (torch.nextafter(top, top + 1)
                                        if take is not None else top)
                    return (y,)

                h = model.maxpool.register_forward_pre_hook(pre)
            xx = x.clone().requires_grad_(True)
            outs = model(xx)
            sum(o.sum() for o in outs).backward()
            if tie:
                h.remove()
        return xx.grad, rec

    g0, rec0 = run(tie=True)
    g1, rec1 = run(take=rec0.indices, tie=True)
    assert [f["windows"] for f in rec1.flips] == [1]
    check_pool_ties(rec1.flips, "2-D stem tie")
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=0, atol=1e-6)


def test_update_gates_are_restored():
    """The card-vs-CPU update gate names no parameter: the stem conv and
    UNet3D's encoder convs are back at PIPELINE_ATOL."""
    assert UPDATE_TOL == {}


def test_small_train_check_replays_pools_and_relus():
    """chip_smoke's narrow train check records the first pass's max-pool
    argmax and relu branches and replays them in the second; two passes
    on the CPU (the 2-D FasterRCNN's narrow recipe) agree exactly, with
    one (1, 3, 3) stem-pool call, no flip and no tie."""
    from chip_smoke import (
        check_small_train,
        two_d_config,
        two_d_narrow,
        two_d_train_batch,
    )

    cfg = two_d_narrow(two_d_config("FasterRCNN"))
    out = check_small_train("cpu", cfg, two_d_train_batch(3, "FasterRCNN"))
    assert out["pool_ties"] == {"calls": 1, "flips": []}
    assert out["relu_ties"] == []
    assert out["update_tol"] == {}
    assert max(out["worst_update_rel_err"].values()) == 0.0
