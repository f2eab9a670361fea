"""The FLOP counter and the roofline arithmetic against hand counts."""
from __future__ import annotations

import pytest
import torch

from portbench import flops, roofline
from portbench.reference import nn as rnn


def test_counts_conv_deconv_linear_by_hand():
    conv = rnn.Conv3d(3, 4, 3, padding=1)
    deconv = rnn.ConvTranspose3d(4, 5, 2, stride=2)
    fc = rnn.Linear(5 * 8 * 8 * 8, 6)
    model = torch.nn.ModuleList([conv, deconv, fc]).to("meta")
    with flops.FlopCounter().attach(model) as counter:
        x = conv(flops.meta(2, 3, 4, 4, 4))
        y = deconv(x)
        fc(y.flatten(1))
    # conv: 2 * (2*4*64 outputs) * 3 in * 27 taps; deconv: 2 * (2*4*64
    # inputs) * 5 out * 8 taps; fc: 2 * 2 rows * 2560 in * 6 out
    want = 2 * 512 * 3 * 27 + 2 * 512 * 5 * 8 + 2 * 2 * 2560 * 6
    assert counter.flops == want


def test_request_flops_sum_the_stages():
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell("htc-infer-patch")
    shapes = {"imgs": (8, 32, 32)}
    total = flops.request_flops(cell.reference, cell.cfg, shapes)
    # the three bbox stages alone: 8 rows, (64*3*7*7) -> 1024 -> 1024 ->
    # 2 + 6 outputs each
    fc = 2 * 8 * (9408 * 1024 + 1024 * 1024 + 1024 * 8)
    assert total > 3 * fc


def test_k1_work_by_hand():
    nbytes, nops = roofline.k1_work([3, 2])
    assert nbytes == 5 * 25 + 5
    assert nops == (3 + 1) * roofline.IOU_OPS
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)


def test_k2_work_by_hand():
    # one roi over voxels x 0..3, y 0..3, z 0..1 of a stride-1 level
    # (2 x 8 x 8, 4 channels, 2 bytes), a 1x1x1 output, one sample a bin:
    # the sample sits at (2, 2, 1); its taps are x 2..3, y 2..3, and z 1
    # alone (the edge rule), so 4 voxels are touched
    shapes = [(1, 2, 8, 8, 4)]
    rois = torch.tensor([[0.0, 0.0, 0.0, 3.0, 3.0, 0.0, 1.0]])
    nbytes, nops = roofline.k2_work(shapes, 2, rois, torch.zeros(1),
                                    torch.ones(1, dtype=torch.bool), 1, 1,
                                    [1], [1], 1)
    # touched 4 * 4 * 2, the roi 7 * 4, its level and flag 5, output 4 * 2
    assert nbytes == 32 + 28 + 5 + 8
    # 4 channels * (1 plane * 2 rows * 1 * 4 * 1 + 1 * 1 * 1 * 4 * 1)
    assert nops == 4 * (8 + 4)
