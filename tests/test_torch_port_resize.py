"""The port's trilinear resize and host runtime against the JAX package.

`ops.resize3d`: the lerp matrix exactly equal; the resize within 1e-5
of JAX's (float32 sums in another order) and of the host runtime's.
`native`: the port's own build of the host runtime, exactly equal to
`mrcnn3d.native` (built from the same source with the same flags); the
merge NMS also equal to its plain version; a failed build raises.
"""
import numpy as np
import pytest
import torch

from mrcnn3d import native as jnative
from mrcnn3d.ops.nms3d import nms_3d_overlap_numpy as j_overlap_numpy
from mrcnn3d.ops.resize3d import axis_lerp_matrix as j_axis_lerp_matrix
from mrcnn3d.ops.resize3d import resize_trilinear_3d as j_resize
from mrcnn3d_torch import native
from mrcnn3d_torch.ops.nms3d import nms_3d_overlap_numpy
from mrcnn3d_torch.ops.resize3d import axis_lerp_matrix, resize_trilinear_3d
from torch_port_fixtures import torch_threads  # noqa: F401

RESIZE_TOL = 1e-5
CASES = [
    ((8, 12, 10, 1), (12, 18, 15)),     # 1.5x up
    ((7, 9, 11, 3), (11, 14, 17)),      # odd sizes, 3 channels, 1.5x
    ((10, 10, 10, 1), (5, 7, 10)),      # down and identity
    ((9, 13, 6, 3), (4, 20, 3)),        # mixed, 3 channels
    ((1, 5, 4, 3), (2, 8, 6)),          # a single slice
]


@pytest.mark.parametrize("out_n,in_n", [(12, 8), (15, 10), (5, 10),
                                        (10, 10), (17, 11), (3, 1), (1, 4)])
def test_axis_lerp_matrix_equals_jax(out_n, in_n):
    np.testing.assert_array_equal(axis_lerp_matrix(out_n, in_n),
                                  j_axis_lerp_matrix(out_n, in_n))


def _port_resize(vol, out, dtype=torch.float32):
    x = torch.from_numpy(vol).permute(3, 0, 1, 2)[None].to(dtype)
    y = resize_trilinear_3d(x, out)
    assert y.dtype == dtype and tuple(y.shape) == (1, vol.shape[3], *out)
    return y[0].permute(1, 2, 3, 0).float().numpy()


@pytest.mark.parametrize("shape,out", CASES)
def test_resize_matches_jax_and_native(shape, out):
    vol = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = _port_resize(vol, out)
    np.testing.assert_allclose(got, np.asarray(j_resize(vol, out)),
                               rtol=0, atol=RESIZE_TOL)
    np.testing.assert_allclose(got, jnative.resize_trilinear(vol, *out),
                               rtol=0, atol=RESIZE_TOL)


def test_resize_bfloat16_rounds_the_float32_result():
    """In bfloat16 the lerps still run in float32: the result is the
    float32 resize of the bfloat16 volume, rounded once."""
    vol = np.random.RandomState(1).randn(6, 10, 8, 3).astype(np.float32)
    vol = torch.from_numpy(vol).to(torch.bfloat16).float().numpy()
    want = torch.from_numpy(_port_resize(vol, (9, 15, 12))).to(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        _port_resize(vol, (9, 15, 12), torch.bfloat16), want)


def test_crop_normalize_equals_jax_native():
    rng = np.random.RandomState(2)
    vol = rng.uniform(0, 255, (20, 24, 9)).astype(np.float32)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    args = (3, 5, 2, 12, 16, 6, mean, std)
    got = native.crop_normalize_volume(vol, *args)
    assert got.shape == (6, 12, 16, 3)
    np.testing.assert_array_equal(got, jnative.crop_normalize_volume(
        vol, *args))
    with pytest.raises(ValueError):
        native.crop_normalize_volume(vol, 10, 0, 0, 12, 16, 6, mean, std)


@pytest.mark.parametrize("shape,out", CASES)
def test_resize_native_equals_jax_native(shape, out):
    vol = np.random.RandomState(3).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(native.resize_trilinear(vol, *out),
                                  jnative.resize_trilinear(vol, *out))


def _merge_dets(rng, n, ties=False):
    xy = rng.uniform(0, 60, (n, 2))
    z = rng.uniform(0, 20, (n, 1))
    size = rng.uniform(1, 20, (n, 3))
    score = rng.rand(n, 1)
    if ties:
        score = np.floor(score * 4) / 4
    return np.concatenate([xy, xy + size[:, :2], z, z + size[:, 2:], score],
                          1).astype(np.float32)


@pytest.mark.parametrize("n,thr,ties", [(0, 0.1, False), (1, 0.1, False),
                                        (200, 0.1, False), (300, 0.5, False),
                                        (150, 0.1, True)])
def test_nms3d_overlap_equals_jax_and_plain(n, thr, ties):
    dets = _merge_dets(np.random.RandomState(4 + n), n, ties)
    got = native.nms3d_overlap(dets, thr)
    assert got == jnative.nms3d_overlap(dets, thr)
    if not ties:
        # the numpy version breaks score ties in another order
        assert got == nms_3d_overlap_numpy(dets, thr)
        assert got == j_overlap_numpy(dets, thr)
    if n > 1:
        assert 0 < len(got) < n


@pytest.mark.parametrize("size", [100, 5000, 70000])
def test_voxel_iou_equals_jax_native(size):
    rng = np.random.RandomState(5)
    a = (rng.rand(size) > 0.6).astype(np.uint8)
    b = (rng.rand(size) > 0.5).astype(np.uint8)
    assert native.voxel_iou(a, b) == jnative.voxel_iou(a, b)
    assert native.voxel_iou(np.zeros(7, np.uint8), np.zeros(7, np.uint8)) \
        == 0.0


def test_library_named_by_source_flags_and_cpu(monkeypatch, tmp_path):
    """A changed source gets another library name; a source that does not
    compile raises, with no fallback."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith(
        "libhost_ops-")
    bad = tmp_path / "host_ops.cpp"
    bad.write_text(native.SOURCE.read_text() + "\nthis is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.library_path().name != path.name
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
