"""PyTorch port vs JAX: 3-D NMS (plain version of the K1 kernel) and
multi-class NMS.

References: JAX `nms_3d_mask`, the Pallas kernel `nms_3d_mask_pallas` in
interpret mode, and the numpy oracle `nms_3d_numpy`.  Keep masks are
compared exactly; boxes and scores at atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrcnn3d.core.post import multiclass_nms_3d as j_multiclass_nms_3d
from mrcnn3d.ops.nms3d import nms_3d as j_nms_3d
from mrcnn3d.ops.nms3d import nms_3d_mask as j_nms_3d_mask
from mrcnn3d.ops.nms3d import nms_3d_numpy
from mrcnn3d.ops.nms3d_pallas import nms_3d_mask_pallas
from mrcnn3d_torch.core.post import multiclass_nms_3d
from mrcnn3d_torch.ops import nms3d
from torch_port_fixtures import torch_threads  # noqa: F401


def _boxes(rng, k, integer=False):
    """Clustered boxes, so that suppression chains form."""
    centers = rng.uniform(8, 56, (max(1, k // 6), 3))
    c = centers[rng.randint(0, len(centers), k)] + rng.randn(k, 3) * 3.0
    size = rng.uniform(4, 16, (k, 3))
    lo, hi = c - size / 2, c + size / 2
    boxes = np.stack(
        [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], lo[:, 2], hi[:, 2]], 1
    )
    if integer:
        boxes = np.round(boxes)
    return boxes.astype(np.float32)


def _case(seed, k, ties, integer):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, k, integer)
    if ties:
        # few distinct scores: many exact ties
        scores = rng.randint(0, 4, k).astype(np.float32) / 4.0
    else:
        scores = rng.rand(k).astype(np.float32)
    valid = rng.rand(k) > 0.15
    return boxes, scores, valid


# (seed, K, tied scores, integer boxes)
CASES = [
    (0, 37, False, False),
    (1, 100, True, False),
    (2, 130, False, True),
    (3, 200, True, True),
    (4, 64, False, False),
]


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("case", CASES)
def test_nms_mask_matches_references(case, thr):
    """Plain NMS == JAX nms_3d_mask == Pallas (interpret) == numpy
    oracle, with tied scores, invalid rows and K not a multiple of 64
    or 128."""
    boxes, scores, valid = _case(*case)
    got = nms3d.nms_3d_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), thr,
    ).numpy()
    want = np.asarray(j_nms_3d_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr
    ))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(nms_3d_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
        interpret=True,
    ))
    np.testing.assert_array_equal(got, pallas)
    # numpy oracle over the valid rows (it has no validity mask)
    idx = np.flatnonzero(valid)
    dets = np.concatenate([boxes[idx], scores[idx, None]], 1)
    oracle = np.zeros_like(valid)
    oracle[idx[nms_3d_numpy(dets, thr)]] = True
    np.testing.assert_array_equal(got, oracle)
    assert got.any() and (thr > 0.5 or got.sum() < valid.sum()), "vacuous"


def test_nms_3d_top_k_matches_jax():
    boxes, scores, valid = _case(1, 100, True, False)
    got = nms3d.nms_3d(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.5, 40)
    want = j_nms_3d(jnp.asarray(boxes), jnp.asarray(scores),
                    jnp.asarray(valid), 0.5, 40)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)


def test_segmented_equals_per_segment():
    """One segmented call == one call per segment (sizes 1..130)."""
    cases = [_case(10 + i, k, i % 2 == 0, False)
             for i, k in enumerate([1, 17, 64, 130, 65])]
    counts = [c[0].shape[0] for c in cases]
    cat = [torch.from_numpy(np.concatenate([c[j] for c in cases]))
           for j in range(3)]
    got = nms3d.nms_3d_mask_segments(*cat, counts, 0.5).numpy()
    want = np.concatenate([
        nms3d.nms_3d_mask(*[torch.from_numpy(a) for a in c], 0.5).numpy()
        for c in cases
    ])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,num_classes,max_num",
                         [(0, 2, 40), (1, 3, 500), (2, 2, 7)])
def test_multiclass_nms_matches_jax(seed, num_classes, max_num):
    """dets, labels, valid and src_idx, including the padding to
    max_num (500 > rows) and the global top max_num cut (7)."""
    rng = np.random.RandomState(seed)
    n = 120
    boxes = np.concatenate(
        [_boxes(rng, n) for _ in range(num_classes)], 1
    )
    logits = rng.randn(n, num_classes).astype(np.float32) * 2.0
    logits[::7] = logits[0]  # tied rows
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    scores = scores.astype(np.float32)
    valid = rng.rand(n) > 0.1
    want = j_multiclass_nms_3d(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(valid), 0.2, 0.5, max_num)
    got = multiclass_nms_3d(torch.from_numpy(boxes)[None],
                            torch.from_numpy(scores)[None],
                            torch.from_numpy(valid)[None], 0.2, 0.5,
                            max_num)
    wd, wl, wv, ws = (np.asarray(a) for a in want)
    gd, gl, gv, gs = (a[0].numpy() for a in got)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gd, wd, atol=1e-6)
    assert gv.any()


def test_k1_segment_limit():
    """K1 takes a segment of up to 384 tiles of 64 rows (24,576 rows:
    SSD512's 24,564 anchors in one class's segment; SSD300's 8732), with
    64 * W * (W + 1) / 2 mask words for W tiles, and refuses one row
    more, as the kernel does (`csrc/nms3d.cu` kMaxTiles)."""
    table, words = nms3d.segment_table([8732, 24576, 5])
    assert table == [0, 8732, 33308, 8732, 24576, 5, 0, 604992, 5335872]
    assert words == 5335872 + 64
    with pytest.raises(ValueError, match="segment of 24577 boxes: at most "
                                         "24576"):
        nms3d.segment_table([3, 24577])
