"""The port's remaining 3-D modules against the JAX package, on the CPU:
FPN3D2Scales, the OHEM sampler, RoIPool3D, soft-NMS and the host-side
evaluation (VOC mAP, proposal recall, class names).

  * FPN3D2Scales alone (no detector type builds it, as
    tests/test_extra_components.py tests it): every level within 2e-3;
  * OHEM: `hard_negative_sample` and `sample_rcnn_single` under
    OHEMSampler and HardNegativeSampler, a tie in the scores, JAX's keys
    replayed: every index, mask and count equal; one train step of the
    narrow flagship under OHEMSampler: each loss within 2e-3 of JAX's
    `forward_train`, and each R-CNN sample equal to JAX's sampler on the
    same proposals and scores (negatives other than RandomSampler's);
  * `roi_pool_3d` against `roi_pool_3d_numpy` on every roi and against
    the JAX `roi_pool_3d` on the rois that fit its static window (it
    clamps larger ones: a JAX-package workaround the port leaves out),
    corners rounded half to even: exact;
  * `soft_nms_3d` in its three methods, `eval_map_3d`, `eval_map`
    (default, imagenet, 11-point, scale ranges, ignored gt, its printed
    table), `eval_recalls_3d` and `get_classes`: equal.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import SMALL_SHAPES, small_train_batch, small_train_config
from mrcnn3d.core import targets as jt
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.eval import class_names as jclass_names
from mrcnn3d.eval import mean_ap as jmean_ap
from mrcnn3d.eval import recall as jrecall
from mrcnn3d.models.fpn3d import FPN3D2Scales as JFPN3D2Scales
from mrcnn3d.ops import nms3d as jnms3d
from mrcnn3d.ops import roi_pool3d as jroi_pool3d
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.core import targets as tt
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs, build_detector
from mrcnn3d_torch.eval import class_names, mean_ap, recall
from mrcnn3d_torch.models.fpn3d import FPN3D2Scales
from mrcnn3d_torch.ops.nms3d import soft_nms_3d
from mrcnn3d_torch.ops.roi_pool3d import roi_pool_3d
from test_torch_port_models import _randomise, jax_flagship, to_cf, to_cl
from test_torch_port_targets import (
    RCNN_CFG,
    STDS,
    JaxDraws,
    _assigned,
    _boxes,
    _gts,
    _jitter,
    _np,
    assert_deltas_match,
    forward_train_draws,
)
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3


# ---------------------------------------------------------------------------
# FPN3D2Scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_outs", [8, 10])
def test_fpn3d_2scales_matches_jax(num_outs):
    """Two pathways of four stages (odd sizes included), the interleaved
    chain, extra levels from outs[-2]."""
    rng = np.random.RandomState(0)
    chans = [8, 16, 32, 64]
    sizes1 = [(8, 16, 16), (4, 8, 8), (2, 4, 4), (1, 2, 2)]
    sizes2 = [(12, 24, 24), (6, 12, 12), (3, 6, 6), (2, 3, 3)]
    x1 = [rng.randn(1, c, *s).astype(np.float32)
          for c, s in zip(chans, sizes1)]
    x2 = [rng.randn(1, c, *s).astype(np.float32)
          for c, s in zip(chans, sizes2)]
    jneck = JFPN3D2Scales(out_channels=8, num_outs=num_outs)
    j1 = [jnp.asarray(to_cl(x)) for x in x1]
    j2 = [jnp.asarray(to_cl(x)) for x in x2]
    variables = _randomise(jneck.init(jax.random.PRNGKey(0), j1, j2),
                           np.random.RandomState(1))
    want = jneck.apply(variables, j1, j2)
    neck = FPN3D2Scales(chans, chans, out_channels=8, num_outs=num_outs)
    sd = state_dict_from_jax({"params": {"backbone": {},
                                         "neck": variables["params"]}})
    neck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = neck([torch.from_numpy(x) for x in x1],
                   [torch.from_numpy(x) for x in x2])
    assert len(got) == len(want) == num_outs
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(to_cf(w), g.numpy(), atol=ATOL,
                                   err_msg=f"level {i}")
    if num_outs > 8:
        # the extra levels subsample outs[-2]
        np.testing.assert_array_equal(got[8].numpy(),
                                      got[6][:, :, ::2, ::2, ::2].numpy())


# ---------------------------------------------------------------------------
# OHEM
# ---------------------------------------------------------------------------


def _tied_scores(rng, n):
    """Scores in [0, 1) with ties: every value appears at least twice,
    and 0 (the gt rows' score) among them."""
    s = np.round(rng.rand(n) * 20).astype(np.float32) / 20
    s[:4] = 0.0
    return s


@pytest.mark.parametrize("n_pos,n_neg", [(10, 300), (3, 12), (0, 0)],
                         ids=["over_quota", "under_quota", "no_candidates"])
def test_hard_negative_sample_replays_jax(n_pos, n_neg):
    rng = np.random.RandomState(2)
    assigned = _assigned(rng, 400, n_pos, n_neg)
    key = jax.random.PRNGKey(7)
    scores = _tied_scores(rng, 400)
    want = jt.hard_negative_sample(key, jnp.asarray(assigned), 32, 0.25,
                                   jnp.asarray(scores))
    got = tt.hard_negative_sample(
        JaxDraws(lambda site: key), (), torch.from_numpy(assigned), 32,
        0.25, torch.from_numpy(scores))
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    if n_neg:
        # the negatives are the best-scored, ties to the lower index
        neg = _np(got.neg_inds)[_np(got.neg_mask)]
        is_neg = assigned == 0
        order = np.argsort(-np.where(is_neg, scores, -np.inf),
                           kind="stable")
        np.testing.assert_array_equal(neg, order[:len(neg)])


@pytest.mark.parametrize("sampler", ["OHEMSampler", "HardNegativeSampler"])
def test_sample_rcnn_single_ohem_replays_jax(sampler):
    """The gt rows lead the candidates at score 0; the proposals' scores
    tie."""
    rng = np.random.RandomState(4)
    gt, gv = _gts(rng, n_valid=4)
    props = np.concatenate([_jitter(rng, gt, 60, 1.5), _boxes(rng, 60)])
    pv = rng.rand(120) > 0.1
    scores = _tied_scores(rng, 120)
    labels = rng.randint(1, 3, gt.shape[0]).astype(np.int32)
    cfg = dict(RCNN_CFG, sampler=dict(RCNN_CFG["sampler"], type=sampler))
    key = jax.random.PRNGKey(13)
    means = (0.0,) * 6
    want = jt.sample_rcnn_single(key, jnp.asarray(props), jnp.asarray(pv),
                                 jnp.asarray(gt), jnp.asarray(gv),
                                 jnp.asarray(labels), cfg, means, STDS,
                                 proposal_scores=jnp.asarray(scores))
    args = (torch.from_numpy(props), torch.from_numpy(pv),
            torch.from_numpy(gt), torch.from_numpy(gv),
            torch.from_numpy(labels), cfg, means, STDS)
    got = tt.sample_rcnn_single(JaxDraws(lambda site: key), (), *args,
                                proposal_scores=torch.from_numpy(scores))
    _assert_samples_equal(got, want)
    random = tt.sample_rcnn_single(JaxDraws(lambda site: key), (), *args)
    assert not torch.equal(got.rois, random.rois), "vacuous case"


def _assert_samples_equal(got, want):
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


def _ohem(cfg):
    cfg.train_cfg["rcnn"]["sampler"]["type"] = "OHEMSampler"
    return cfg


def test_ohem_train_step_matches_jax(monkeypatch):
    """The narrow flagship's forward_train under OHEMSampler (training
    budgets of small_train_config), JAX's key tree replayed."""
    jcfg, jmodel, variables = jax_flagship(seed=0)
    small = small_train_config().train_cfg
    for part in ("rpn_proposal", "rpn", "rcnn"):
        jcfg.train_cfg[part] = small[part]
    _ohem(jcfg)
    sets = []
    for (d, h, w), ac in zip(SMALL_SHAPES, j_anchor_cfgs(jcfg)):
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    batch = small_train_batch(3)
    jb = {k: jnp.asarray(np.transpose(v, (0, 2, 3, 4, 1))
                         if k.startswith("imgs") else v)
          for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)
    _, jlosses = jax.jit(lambda v, b: jpl.forward_train(
        jmodel, v, b, rng, jcfg, sets))(variables, jb)

    cfg = _ohem(small_train_config())
    model = build_detector(cfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    calls = []
    sample = tt.sample_rcnn_single

    def recording(draws, site, *args, **kw):
        out = sample(draws, site, *args, **kw)
        if site[0] == "rcnn":
            calls.append((site, args, kw, out))
        return out

    monkeypatch.setattr(tpl, "sample_rcnn_single", recording)
    draws = forward_train_draws(rng, 2)
    with torch.no_grad():
        _, losses = tpl.forward_train(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
            tpl.anchor_sets_for(model, anchor_cfgs(cfg), SMALL_SHAPES),
            draws)
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert abs(float(losses[k]) - float(v)) <= ATOL, (k, losses[k], v)
    # both scales, both images; each against JAX's sampler on its inputs
    assert len(calls) == 4
    differs = 0
    for site, args, kw, got in calls:
        assert kw["proposal_scores"] is not None
        props, pv, gtb, gtv, gtl = (np.asarray(_np(a)) for a in args[:5])
        scores = _np(kw["proposal_scores"])
        key = draws.key_of(site)
        want = jt.sample_rcnn_single(
            key, jnp.asarray(props), jnp.asarray(pv), jnp.asarray(gtb),
            jnp.asarray(gtv), jnp.asarray(gtl), args[5], *args[6:8],
            proposal_scores=jnp.asarray(scores))
        _assert_samples_equal(got, want)
        random = sample(draws, site, *args)
        differs += not torch.equal(got.rois, random.rois)
    assert differs, "OHEM sampled as RandomSampler: vacuous case"


# ---------------------------------------------------------------------------
# RoIPool3D
# ---------------------------------------------------------------------------


def _pool_rois(rng, n, fd, fh, fw, scale, dscale):
    """Rois in the input frame: small and large, some partly outside the
    map, a few on .5 corners (half to even), one per image."""
    x1 = rng.uniform(-8, fw / scale, n)
    y1 = rng.uniform(-8, fh / scale, n)
    z1 = rng.uniform(-2, fd / dscale, n)
    w = rng.uniform(1, 40, n)
    h = rng.uniform(1, 40, n)
    d = rng.uniform(1, 12, n)
    rois = np.stack([rng.randint(0, 2, n), x1, y1, x1 + w, y1 + h, z1,
                     z1 + d], 1).astype(np.float32)
    # corners whose scaled value is k + .5 exactly
    rois[:6, 1] = (np.arange(6) + 0.5) / scale
    rois[:6, 5] = (np.arange(6) + 0.5) / dscale
    return rois


def test_roi_pool_3d_matches_both_jax_functions():
    rng = np.random.RandomState(5)
    fb, c, fd, fh, fw = 2, 3, 12, 40, 36
    feats = rng.randn(fb, c, fd, fh, fw).astype(np.float32)
    scale, dscale = 0.5, 0.5
    rois = _pool_rois(rng, 40, fd, fh, fw, scale, dscale)
    # 10 rois larger than a 16 x 8 window (the JAX clamp below)
    rois[30:, 3] = rois[30:, 1] + 60
    rois[30:, 6] = rois[30:, 5] + 30
    valid = np.ones(40, bool)
    valid[7] = False
    got = roi_pool_3d(torch.from_numpy(feats), torch.from_numpy(rois), 7, 3,
                      scale, dscale, valid=torch.from_numpy(valid)).numpy()
    oracle = jroi_pool3d.roi_pool_3d_numpy(to_cl(feats), rois, 7, 3, scale,
                                           dscale)
    oracle = np.moveaxis(oracle, -1, 1)
    oracle[7] = 0.0
    np.testing.assert_array_equal(got, oracle)
    # the JAX function with a small window: equal where the roi fits it
    max_hw, max_d = 16, 8
    jgot = np.moveaxis(np.asarray(jroi_pool3d.roi_pool_3d(
        jnp.asarray(to_cl(feats)), jnp.asarray(rois), 7, 3, scale, dscale,
        max_hw=max_hw, max_d=max_d, valid=jnp.asarray(valid))), -1, 1)
    c = np.round(rois[:, 1:] * np.float32([scale] * 4 + [dscale] * 2))
    fits = ((c[:, 2] - c[:, 0] + 1 <= max_hw) & (c[:, 3] - c[:, 1] + 1
                                                 <= max_hw)
            & (c[:, 5] - c[:, 4] + 1 <= max_d)
            & (c[:, 0] >= 0) & (c[:, 1] >= 0) & (c[:, 4] >= 0))
    assert 10 < fits.sum() < 30
    np.testing.assert_array_equal(got[fits], jgot[fits])
    # and the clamp changes the larger rois: the port keeps the oracle's
    assert not np.array_equal(got[30:], jgot[30:])


# ---------------------------------------------------------------------------
# soft-NMS and the host-side evaluation
# ---------------------------------------------------------------------------


def _dets(rng, n, hi=40.0):
    xyz = rng.uniform(0, hi, (n, 3))
    ext = rng.uniform(4, 16, (n, 3))
    return np.concatenate([xyz[:, :2], xyz[:, :2] + ext[:, :2],
                           xyz[:, 2:] / 4, xyz[:, 2:] / 4 + ext[:, 2:] / 3,
                           rng.rand(n, 1)], 1).astype(np.float32)


@pytest.mark.parametrize("method", ["linear", "gaussian", "naive"])
def test_soft_nms_3d_matches_jax(method):
    dets = _dets(np.random.RandomState(6), 60)
    want, want_idx = jnms3d.soft_nms_3d_numpy(dets, 0.3, method, 0.5, 1e-3)
    got, idx = soft_nms_3d(torch.from_numpy(dets), 0.3, method, 0.5, 1e-3)
    assert idx == want_idx
    np.testing.assert_array_equal(got, want)
    if method == "naive":
        assert len(idx) < 60, "vacuous case"
    else:
        assert (got[:, 6] < dets[idx, 6]).any(), "no score decayed"


def _voc_case(seed, n_img=4, n_cls=2):
    """Per image: per class dets (n, 7) near the gts, gts (g, 6), 1-based
    labels and an ignore mask."""
    rng = np.random.RandomState(seed)
    dets, gts, labels, ignore = [], [], [], []
    for _ in range(n_img):
        g = rng.randint(1, 6)
        gt = _dets(rng, g)[:, :6]
        lab = rng.randint(1, n_cls + 1, g)
        per_cls = []
        for c in range(1, n_cls + 1):
            near = gt[lab == c] + rng.randn((lab == c).sum(), 6).astype(
                np.float32)
            extra = _dets(rng, 3)[:, :6]
            boxes = np.concatenate([near, extra])
            per_cls.append(np.concatenate(
                [boxes, rng.rand(len(boxes), 1).astype(np.float32)], 1))
        dets.append(per_cls)
        gts.append(gt)
        labels.append(lab)
        ignore.append(rng.rand(g) < 0.2)
    return dets, gts, labels, ignore


@pytest.mark.parametrize("kind", ["default", "imagenet", "11points",
                                  "scale_ranges", "ignore"])
def test_eval_map_matches_jax(kind):
    dets, gts, labels, ignore = _voc_case(7)
    kw = dict(print_summary=False)
    if kind == "imagenet":
        kw["dataset"] = "vid"
    if kind == "11points":
        kw["dataset"] = "voc07"
    if kind == "scale_ranges":
        kw["scale_ranges"] = [(0, 8), (8, 32)]
    if kind == "ignore":
        kw["gt_ignore"] = ignore
    want = jmean_ap.eval_map(dets, gts, labels, **kw)
    got = mean_ap.eval_map(dets, gts, labels, **kw)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)
    assert 0 < np.max(got[0]) < 1, "vacuous case"


def test_eval_map_3d_recalls_and_table_match_jax():
    dets, gts, labels, _ = _voc_case(8)
    one = [d[0] for d in dets]
    for mode in ("area", "11points"):
        want = jmean_ap.eval_map_3d(one, gts, 0.5, mode)
        got = mean_ap.eval_map_3d(one, gts, 0.5, mode)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    props = [np.concatenate([d[0], d[1]]) for d in dets]
    want = jrecall.eval_recalls_3d(gts, props, (1, 5, 100), (0.3, 0.5))
    got = recall.eval_recalls_3d(gts, props, (1, 5, 100), (0.3, 0.5))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= 1
    tables = []
    for mod in (mean_ap, jmean_ap):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.eval_map(dets, gts, labels, dataset="voc")
        tables.append(buf.getvalue())
    assert tables[0] == tables[1] and "aeroplane" in tables[0]


@pytest.mark.parametrize("name", ["voc07", "coco", "cmb", ["a", "b"]])
def test_get_classes_matches_jax(name):
    assert class_names.get_classes(name) == jclass_names.get_classes(name)
    with pytest.raises(ValueError):
        class_names.get_classes("nope")


def test_get_classes_vid():
    """The "vid" aliases name imagenet_vid_classes; the JAX package looks
    up a `vid_classes` that does not exist (a JAX-package fault listed in
    ROADMAP)."""
    with pytest.raises(KeyError, match="vid_classes"):
        jclass_names.get_classes("vid")
    for alias in ("vid", "imagenet_vid", "ilsvrc_vid"):
        assert class_names.get_classes(alias) == \
            jclass_names.imagenet_vid_classes()
