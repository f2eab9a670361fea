"""PyTorch port vs JAX: multi-level RoIAlign3D (plain version of the K2
kernel).

References: JAX `multi_level_roi_align_3d` at atol 1e-5 (float32 sums
in another order), and the Pallas kernel `roi_align_3d_pallas` in
interpret mode at atol 2e-4 for rois inside its window (its weights are
2^-16 fixed point, as in tests/test_roi_align3d.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrcnn3d.ops.roi_align3d import map_roi_levels as j_map_roi_levels
from mrcnn3d.ops.roi_align3d import multi_level_roi_align_3d as j_align
from mrcnn3d.ops.roi_align3d_pallas import roi_align_3d_pallas
from mrcnn3d_torch.ops.roi_align3d import map_roi_levels
from mrcnn3d_torch.ops.roi_align3d import multi_level_roi_align_3d

STRIDES = [4, 8, 16, 32]
STRIDES_D = [2, 4, 8, 16]


def _pyramid(rng, b=2, c=8, d=16, h=48, w=48):
    return [
        rng.randn(b, d >> i, h >> i, w >> i, c).astype(np.float32)
        for i in range(4)
    ]


def _rois(rng, n, b=2):
    """Rois over a 192 x 192 x 32 volume: every level, rois crossing
    every edge, degenerate (x2 < x1, zero extent) and oversized ones."""
    x1 = rng.uniform(-30, 190, n)
    y1 = rng.uniform(-30, 190, n)
    z1 = rng.uniform(-6, 31, n)
    w = np.exp(rng.uniform(np.log(2), np.log(400), n))
    h = w * np.exp(rng.uniform(-0.7, 0.7, n))
    dd = np.exp(rng.uniform(np.log(1), np.log(60), n))
    rois = np.stack([rng.randint(0, b, n), x1, y1, x1 + w, y1 + h,
                     z1, z1 + dd], 1).astype(np.float32)
    rois[:4, 3] = rois[:4, 1] - 3.0      # x2 < x1: clamped to zero extent
    rois[4:8, 6] = rois[4:8, 5]          # zero depth extent
    rois[8:12, 1:5] = [-40.0, -40.0, 260.0, 260.0]  # beyond the volume
    return rois


def _to_cf(feats):
    return [torch.from_numpy(np.ascontiguousarray(
        np.transpose(f, (0, 4, 1, 2, 3)))) for f in feats]


@pytest.mark.parametrize("seed,out,out_d", [(0, 7, 3), (1, 14, 10)])
def test_plain_matches_jax_multi_level(seed, out, out_d):
    rng = np.random.RandomState(seed)
    feats = _pyramid(rng)
    rois = _rois(rng, 96)
    valid = rng.rand(96) > 0.2
    levels = np.asarray(j_map_roi_levels(jnp.asarray(rois), 4))
    assert set(levels[valid].tolist()) == {0, 1, 2, 3}, "not every level"
    np.testing.assert_array_equal(
        map_roi_levels(torch.from_numpy(rois), 4).numpy(), levels
    )
    want = np.asarray(j_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), out, out_d,
        STRIDES, STRIDES_D, 2, valid=jnp.asarray(valid),
    ))
    got = multi_level_roi_align_3d(
        _to_cf(feats), torch.from_numpy(rois), out, out_d, STRIDES,
        STRIDES_D, 2, valid=torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 4, 1)), want,
                               atol=1e-5)
    assert not got[~valid].any(), "invalid rois must give zeros"
    assert np.abs(got[valid]).sum() > 0


def test_plain_matches_pallas_interpret():
    """Single level, rois inside the Pallas window (max_hw=40)."""
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 16, 48, 48, 8).astype(np.float32)
    rois = np.array(
        [
            [0, 4, 4, 27, 30, 2, 9],
            [1, 0, 0, 60, 60, 0, 15],
            [0, 10, 12, 80, 90, 5, 20],
            [1, 40, 40, 100, 100, 10, 25],
            [0, 150, 150, 190, 188, 20, 31],
        ],
        np.float32,
    )
    want = np.asarray(roi_align_3d_pallas(
        jnp.asarray(feats), jnp.asarray(rois), 7, 3, 0.25, 0.5, 2,
        max_d=16, max_hw=40, interpret=True,
    ))
    got = multi_level_roi_align_3d(
        _to_cf([feats]), torch.from_numpy(rois), 7, 3, [4], [2], 2,
    ).numpy()
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 4, 1)), want,
                               atol=2e-4)
