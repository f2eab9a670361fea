"""PyTorch port vs JAX: box encoding, assignment, sampling and targets.

The port's samplers take their integers from an injected source; here
that source replays the JAX package's key tree (`JaxDraws`), and the
maximum of each draw comes from the port's own assignment, so equal
samples also prove that the assignments agree.  Integers, masks,
counts, sampled boxes and mask targets must be equal.  Encoded deltas
(`bbox2delta3d` repeats the JAX expression order) are equal in their
centre offsets; their log-size columns within 1e-6 relative and
absolute, since XLA's and PyTorch's float32 log differ in the last bits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcnn3d.core import targets as jt
from mrcnn3d.ops.box3d import bbox2delta3d as j_bbox2delta3d
from mrcnn3d_torch.core import targets as tt
from mrcnn3d_torch.ops.box3d import bbox2delta3d
from torch_port_fixtures import torch_threads  # noqa: F401

STDS = (0.1, 0.1, 0.2, 0.2, 0.1, 0.1)
RCNN_CFG = dict(
    assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5),
    sampler=dict(type="RandomSampler", num=32, pos_fraction=0.25),
)
RPN_CFG = dict(
    assigner=dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3),
    sampler=dict(num=64, pos_fraction=0.5), pos_weight=3,
)


class JaxDraws:
    """The port's draw source, replaying the JAX package: the key of a
    sampler call is `key_of(site[:-1])`, split into (positive, negative)
    keys as `mrcnn3d/core/targets.py:random_sample` splits it, then
    `jax.random.randint(k, (n,), 0, high)`."""

    def __init__(self, key_of):
        self.key_of = key_of
        self.highs = []

    def __call__(self, site, n, high):
        kp, kn = jax.random.split(self.key_of(site[:-1]))
        self.highs.append((site, n, int(high)))
        r = jax.random.randint(kp if site[-1] == "pos" else kn, (n,), 0,
                               int(high))
        return torch.from_numpy(np.asarray(r).astype(np.int64)).to(
            high.device)


def forward_train_draws(rng, batch_size):
    """JaxDraws for `forward_train`: split(rng, 8); the RPN of scale s
    uses key s, its R-CNN sampling 3 + s, the refinement 6; each split
    over the images (`mrcnn3d/detectors/pipeline.py` forward_train)."""
    rngs = jax.random.split(rng, 8)
    root = {"rpn": lambda s: rngs[s], "rcnn": lambda s: rngs[3 + s],
            "refine": lambda s: rngs[6]}

    def key_of(site):
        stage, scale, image = site
        return jax.random.split(root[stage](scale), batch_size)[image]

    return JaxDraws(key_of)


def rgb_draws(rng, batch_size):
    """JaxDraws for the RGB family's forward_train: split(rng, 6); slice
    s's RPN uses key 2 s, its R-CNN sampling 2 s + 1; each split over the
    images (`mrcnn3d/detectors/pipeline.py` rgb_forward_train)."""
    rngs = jax.random.split(rng, 6)
    root = {"rpn": lambda s: rngs[2 * s], "rcnn": lambda s: rngs[2 * s + 1]}

    def key_of(site):
        stage, s, image = site
        return jax.random.split(root[stage](s), batch_size)[image]

    return JaxDraws(key_of)


def _boxes(rng, n, lo=0.0, hi=40.0, size=(2.0, 16.0)):
    xyz = rng.uniform(lo, hi, (n, 3))
    ext = rng.uniform(*size, (n, 3))
    b = np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 0] + ext[:, 0],
                  xyz[:, 1] + ext[:, 1], xyz[:, 2] / 4,
                  xyz[:, 2] / 4 + ext[:, 2] / 3], 1)
    return b.astype(np.float32)


def _gts(rng, g=6, n_valid=4):
    valid = np.zeros(g, bool)
    valid[:n_valid] = True
    return _boxes(rng, g, size=(6.0, 16.0)), valid


def _jitter(rng, gt, n, scale):
    """n boxes around the gts: some strong overlaps, some weak."""
    src = gt[rng.randint(0, gt.shape[0], n)]
    return (src + rng.randn(n, 6).astype(np.float32) * scale).astype(
        np.float32)


def _np(t):
    return t.detach().cpu().numpy()


LOG_COLUMNS = [2, 3, 5]
LINEAR_COLUMNS = [0, 1, 4]


def assert_deltas_match(got, want, err_msg=""):
    """Centre offsets equal; log sizes within 1e-6 (relative and
    absolute)."""
    got, want = got.reshape(-1, 6), want.reshape(-1, 6)
    np.testing.assert_array_equal(got[:, LINEAR_COLUMNS],
                                  want[:, LINEAR_COLUMNS], err_msg=err_msg)
    np.testing.assert_allclose(got[:, LOG_COLUMNS], want[:, LOG_COLUMNS],
                               rtol=1e-6, atol=1e-6, err_msg=err_msg)


@pytest.mark.parametrize("stds", [(1.0,) * 6, STDS])
def test_bbox2delta3d_matches_jax(stds):
    rng = np.random.RandomState(0)
    props = _boxes(rng, 200)
    gt = _jitter(rng, props, 200, 2.0)
    gt[:, 2:4] = np.maximum(gt[:, 2:4], gt[:, 0:2])
    gt[:, 5] = np.maximum(gt[:, 5], gt[:, 4])
    means = (0.0, 0.1, 0.0, -0.1, 0.0, 0.0)
    want = np.asarray(j_bbox2delta3d(jnp.asarray(props), jnp.asarray(gt),
                                     means, stds))
    got = bbox2delta3d(torch.from_numpy(props), torch.from_numpy(gt), means,
                       stds)
    assert_deltas_match(_np(got), want)


@pytest.mark.parametrize("assign_all", [True, False])
def test_max_iou_assign_exact(assign_all):
    rng = np.random.RandomState(1)
    gt, gv = _gts(rng)
    boxes = np.concatenate([_jitter(rng, gt[:4], 120, 1.5),
                            _boxes(rng, 80)])
    boxes[:3] = gt[0]  # exact ties on one gt
    bv = rng.rand(200) > 0.1
    want = jt.max_iou_assign(jnp.asarray(boxes), jnp.asarray(bv),
                             jnp.asarray(gt), jnp.asarray(gv), 0.5, 0.3, 0.3,
                             gt_max_assign_all=assign_all)
    got = tt.max_iou_assign(torch.from_numpy(boxes), torch.from_numpy(bv),
                            torch.from_numpy(gt), torch.from_numpy(gv), 0.5,
                            0.3, 0.3, gt_max_assign_all=assign_all)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assigned = _np(got[0])
    assert (assigned > 0).sum() > 10 and (assigned == 0).sum() > 10
    assert (assigned == -1).sum() > 0


def _assigned(rng, n, n_pos, n_neg):
    a = np.full(n, -1, np.int32)
    idx = rng.permutation(n)
    a[idx[:n_pos]] = rng.randint(1, 4, n_pos)
    a[idx[n_pos:n_pos + n_neg]] = 0
    return a


@pytest.mark.parametrize("n_pos,n_neg", [(10, 300), (5, 300), (3, 12),
                                         (0, 0)],
                         ids=["over_quota", "few_pos", "under_quota",
                              "no_candidates"])
def test_random_sample_replays_jax(n_pos, n_neg):
    """Over quota: draws with replacement, deduplicated (fewer than the
    quota may remain); under quota: every candidate in index order."""
    rng = np.random.RandomState(2)
    assigned = _assigned(rng, 400, n_pos, n_neg)
    key = jax.random.PRNGKey(7)
    want = jt.random_sample(key, jnp.asarray(assigned), 32, 0.25)
    draws = JaxDraws(lambda site: key)
    got = tt.random_sample(draws, (), torch.from_numpy(assigned), 32, 0.25)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    if n_pos == 10:
        assert int(got.pos_count) < 8, "no duplicate drawn: vacuous case"


@pytest.mark.parametrize("n_valid", [4, 0], ids=["gts", "no_valid_gt"])
def test_anchor_target_single_replays_jax(n_valid):
    rng = np.random.RandomState(3)
    gt, gv = _gts(rng, n_valid=n_valid)
    anchors = np.concatenate([_jitter(rng, gt, 150, 1.0), _boxes(rng, 350)])
    inside = rng.rand(500) > 0.05
    key = jax.random.PRNGKey(11)
    means, stds = (0.0,) * 6, (1.0,) * 6
    want = jt.anchor_target_single(key, jnp.asarray(anchors),
                                   jnp.asarray(inside), jnp.asarray(gt),
                                   jnp.asarray(gv), RPN_CFG, means, stds)
    got = tt.anchor_target_single(
        JaxDraws(lambda site: key), (), torch.from_numpy(anchors),
        torch.from_numpy(inside), torch.from_numpy(gt),
        torch.from_numpy(gv), RPN_CFG, means, stds)
    for name in want:
        check = (assert_deltas_match if name == "bbox_targets"
                 else np.testing.assert_array_equal)
        check(_np(got[name]), np.asarray(want[name]), err_msg=name)
    if n_valid:
        assert int(_np(got["labels"]).sum()) > 3
    else:
        assert not _np(got["labels"]).any()


@pytest.mark.parametrize("n_valid", [4, 0], ids=["gts", "no_valid_gt"])
def test_sample_rcnn_single_replays_jax(n_valid):
    """add_gt_as_proposals: the gts lead the candidates, each assigned to
    itself; the slots hold positives, negatives, then padding."""
    rng = np.random.RandomState(4)
    gt, gv = _gts(rng, n_valid=n_valid)
    props = np.concatenate([_jitter(rng, gt, 60, 1.5), _boxes(rng, 60)])
    pv = rng.rand(120) > 0.1
    labels = rng.randint(1, 3, gt.shape[0]).astype(np.int32)
    key = jax.random.PRNGKey(13)
    means = (0.0,) * 6
    want = jt.sample_rcnn_single(key, jnp.asarray(props), jnp.asarray(pv),
                                 jnp.asarray(gt), jnp.asarray(gv),
                                 jnp.asarray(labels), RCNN_CFG, means, STDS)
    got = tt.sample_rcnn_single(
        JaxDraws(lambda site: key), (), torch.from_numpy(props),
        torch.from_numpy(pv), torch.from_numpy(gt), torch.from_numpy(gv),
        torch.from_numpy(labels), RCNN_CFG, means, STDS)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = _np(getattr(got, name))
        if name == "bbox_targets":
            assert_deltas_match(g, w, err_msg=name)
            continue
        if name == "bbox_weights":  # JAX keeps one column: (R, 1)
            g = g[:, :1]
        np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1),
                                      err_msg=name)
    # without a valid gt no candidate is negative either (every IoU -1);
    # deduplicated draws may leave slots empty
    n = int(got.roi_valid.sum())
    assert (0 < n <= 32) if n_valid else n == 0
    assert (int(got.is_pos.sum()) > 0) == bool(n_valid)


def test_mask_target_single_exact():
    rng = np.random.RandomState(5)
    g, d, h, w = 3, 10, 40, 36
    masks = (rng.rand(g, d, h, w) > 0.6).astype(np.uint8)
    masks[1] = 0
    masks[1, 3:7, 10:30, 5:20] = 1
    n = 24
    x1 = rng.uniform(-3, 30, n)
    y1 = rng.uniform(-3, 34, n)
    z1 = rng.uniform(-1, 8, n)
    rois = np.stack([x1, y1, x1 + rng.uniform(0, 14, n),
                     y1 + rng.uniform(0, 14, n), z1,
                     z1 + rng.uniform(0, 4, n)], 1).astype(np.float32)
    pos = rng.rand(n) > 0.2
    gidx = rng.randint(0, g, n).astype(np.int32)
    want = np.asarray(jt.mask_target_single(
        jnp.asarray(rois), jnp.asarray(pos), jnp.asarray(gidx),
        jnp.asarray(masks), 28, 20))
    got = _np(tt.mask_target_single(
        torch.from_numpy(rois), torch.from_numpy(pos),
        torch.from_numpy(gidx), torch.from_numpy(masks), 28, 20))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
