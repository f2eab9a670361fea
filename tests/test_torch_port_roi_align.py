"""PyTorch port vs JAX: multi-level RoIAlign3D (plain version of the K2
kernel) and its backward.

References: JAX `multi_level_roi_align_3d` at atol 1e-5 (float32 sums
in another order), and the Pallas kernel `roi_align_3d_pallas` in
interpret mode at atol 2e-4 for rois inside its window (its weights are
2^-16 fixed point, as in tests/test_roi_align3d.py).  The backward
(`roi_align_3d_backward_plain`, the plain version of K2's backward
kernel) against torch.autograd of the plain forward and against
`jax.vjp` of the JAX training align `multi_level_roi_align_3d_dense`,
within 1e-5 of each level's largest gradient: a voxel of a large roi on
a coarse level sums thousands of float32 terms, in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcnn3d.ops.roi_align3d import map_roi_levels as j_map_roi_levels
from mrcnn3d.ops.roi_align3d import multi_level_roi_align_3d as j_align
from mrcnn3d.ops.roi_align3d import multi_level_roi_align_3d_dense as j_dense
from mrcnn3d.ops.roi_align3d_pallas import roi_align_3d_pallas
from mrcnn3d_torch.ops.roi_align3d import map_roi_levels
from mrcnn3d_torch.ops import roi_align3d as ra
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


def _backward_case(seed, out, out_d):
    """Levels, rois (every level, edge, degenerate, invalid), valid and a
    random output gradient (N, C, out_d, out, out)."""
    rng = np.random.RandomState(seed)
    feats = _pyramid(rng)
    rois = _rois(rng, 64)
    valid = rng.rand(64) > 0.2
    grad = rng.randn(64, feats[0].shape[-1], out_d, out, out).astype(
        np.float32)
    levels = map_roi_levels(torch.from_numpy(rois), 4)
    assert set(levels[torch.from_numpy(valid)].tolist()) == {0, 1, 2, 3}
    return feats, rois, valid, grad, levels


@pytest.mark.parametrize("seed,out,out_d", [(3, 7, 3), (4, 14, 10)])
def test_backward_plain_matches_autograd(seed, out, out_d):
    feats, rois, valid, grad, levels = _backward_case(seed, out, out_d)
    args = (torch.from_numpy(rois), levels, torch.from_numpy(valid), out,
            out_d, STRIDES, STRIDES_D, 2)
    leaves = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    ra.roi_align_3d_plain(leaves, *args).backward(torch.from_numpy(grad))
    got = ra.roi_align_3d_backward_plain(
        torch.from_numpy(grad), [f.shape for f in feats], *args)
    for lvl, (g, leaf) in enumerate(zip(got, leaves)):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        want = leaf.grad.numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"level {lvl}")
        assert g.abs().sum() > 0, f"level {lvl} got no gradient"


@pytest.mark.parametrize("seed,out,out_d", [(5, 7, 3), (6, 14, 10)])
def test_backward_plain_matches_jax_dense_vjp(seed, out, out_d):
    """The JAX training path differentiates the dense align with XLA."""
    feats, rois, valid, grad, levels = _backward_case(seed, out, out_d)
    _, vjp = jax.vjp(
        lambda *f: j_dense(list(f), jnp.asarray(rois), out, out_d, STRIDES,
                           STRIDES_D, 2, valid=jnp.asarray(valid)),
        *[jnp.asarray(f) for f in feats])
    want = vjp(jnp.asarray(np.transpose(grad, (0, 2, 3, 4, 1))))
    got = ra.roi_align_3d_backward_plain(
        torch.from_numpy(grad), [f.shape for f in feats],
        torch.from_numpy(rois), levels, torch.from_numpy(valid), out, out_d,
        STRIDES, STRIDES_D, 2)
    for lvl, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"level {lvl}")


def _brute_window(roi, shape, stride, stride_d, out, out_d, sn):
    """One roi's window on its level, tap by tap in numpy float32 (the
    plain version's sample and edge rules): [(first, last)] voxels along
    z, y, x, or None when an axis has no in-range tap."""
    f32 = np.float32
    window = []
    for a, b, dim, scale, pooled in (
            (5, 6, shape[1], f32(1.0 / stride_d), out_d),
            (2, 4, shape[2], f32(1.0 / stride), out),
            (1, 3, shape[3], f32(1.0 / stride), out)):
        start = f32(roi[a]) * scale
        bin_size = max(f32(f32(roi[b]) + f32(1.0)) * scale - start,
                       f32(0.0)) / f32(pooled)
        voxels = []
        for p in range(pooled):
            for i in range(sn):
                coord = start + bin_size * (f32(p) + (f32(i) + f32(0.5))
                                            / f32(sn))
                if not -1.0 <= coord <= dim:
                    continue
                low = int(np.floor(max(coord, f32(0.0))))
                voxels += [dim - 1] if low >= dim - 1 else [low, low + 1]
        if not voxels:
            return None
        window.append((min(voxels), max(voxels)))
    return window


@pytest.mark.parametrize("seed,out,out_d", [(3, 7, 3), (4, 14, 10)])
def test_backward_window_rule(seed, out, out_d):
    """K2's backward sums a roi's gradient over its window (the first to
    the last voxel of its in-range taps on each axis) and adds nothing
    outside it: every voxel with a nonzero plain gradient from a roi lies
    in that roi's window, on its level and image, and a roi with no window
    adds nothing."""
    feats, rois, valid, grad, levels = _backward_case(seed, out, out_d)
    shapes = [f.shape for f in feats]
    reached = 0
    for r, roi in enumerate(rois[:48]):
        grads = ra.roi_align_3d_backward_plain(
            torch.from_numpy(grad[r:r + 1]), shapes,
            torch.from_numpy(rois[r:r + 1]), levels[r:r + 1],
            torch.from_numpy(valid[r:r + 1]), out, out_d, STRIDES,
            STRIDES_D, 2)
        lvl = int(levels[r])
        window = _brute_window(roi, shapes[lvl], STRIDES[lvl],
                               STRIDES_D[lvl], out, out_d, 2)
        for gl, g in enumerate(grads):
            hit = (g.abs().sum(-1) > 0).nonzero().tolist()
            if not (valid[r] and window is not None and gl == lvl):
                assert not hit, (r, gl)
                continue
            for b, *at in hit:
                assert b == int(roi[0]), (r, b)
                assert all(lo <= v <= hi for v, (lo, hi) in
                           zip(at, window)), (r, at, window)
            reached += bool(hit)
    assert reached > 24


def test_function_routes_by_grad_mode():
    """With a level that requires a gradient the align goes through
    RoIAlign3DFunction (gradient = the plain backward, in the levels'
    NCDHW layout); under no_grad it does not build a graph."""
    feats, rois, valid, grad, levels = _backward_case(7, 7, 3)
    cf = [f.requires_grad_(True) for f in _to_cf(feats)]
    out = multi_level_roi_align_3d(cf, torch.from_numpy(rois), 7, 3, STRIDES,
                                   STRIDES_D, 2, valid=torch.from_numpy(valid))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(grad))
    want = ra.roi_align_3d_backward_plain(
        torch.from_numpy(grad), [f.shape for f in feats],
        torch.from_numpy(rois), levels, torch.from_numpy(valid), 7, 3,
        STRIDES, STRIDES_D, 2)
    for leaf, w in zip(cf, want):
        np.testing.assert_array_equal(
            leaf.grad.permute(0, 2, 3, 4, 1).numpy(), w.numpy())
    with torch.no_grad():
        again = multi_level_roi_align_3d(
            cf, torch.from_numpy(rois), 7, 3, STRIDES, STRIDES_D, 2,
            valid=torch.from_numpy(valid))
    assert again.grad_fn is None
    assert torch.equal(again, out.detach())
