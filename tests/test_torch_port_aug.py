"""Test-time augmentation of the port against the JAX package, on the CPU:
the box mappings, the four merge functions and `aug_test`.

`aug_test` runs on the JAX tests' recipe (tests/test_aug_test.py:80-120:
the flagship config as MaskRCNN3D at ResNet3D-18, budgets 16, 8
detections, masks on) on an 8x32x32 volume in three views -- identity,
W-flip and 1.5x on every axis (the port's `jax_resize`, fed to both
packages) -- from the same weights (biases and frozen-BN statistics
randomised with numpy, through the weight bridge): `valid` and `labels`
equal, `dets` and the valid rows' `mask_probs` within 2e-3, the port's
decisions first surviving a 1e-5 change of the input.  The JAX mask head
returns (N, C, D, H, W), so the JAX package's merge_aug_masks, written
for channel-last masks, un-flips a flipped view along H; the reference
here is its merge flipping W, as the port does (a JAX-package fault
listed in ROADMAP).  The mappings and
merges: equal to float32 rounding (1e-5), keep sets exactly.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import compare_outputs
from mrcnn3d.detectors import aug as jaug
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.detectors import aug
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.entry import Flagship
from mrcnn3d_torch.ops.resize3d import jax_resize
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
EXACT = 1e-5
MARGIN = 1e-5
SHAPE = (8, 32, 32)
# identity, W-flip, 1.5x
METAS = [dict(scale_factor=1.0, flip=False), dict(scale_factor=1.0, flip=True),
         dict(scale_factor=1.5, flip=False)]


def recipe(config_cls):
    """tests/test_aug_test.py:80-89."""
    cfg = config_cls.fromfile("configs/mask_rcnn_3d_2scales.py")
    cfg.model["type"] = "MaskRCNN3D"
    cfg.model["backbone"]["depth"] = 18
    cfg.model.pop("rpn_head_2", None)
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.train_cfg["rpn_proposal"][k] = 16
        cfg.test_cfg["rpn"][k] = 16
    cfg.test_cfg["rcnn"]["max_per_img"] = 8
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


def views(seed=2, scale=1.0):
    """The three views of one seeded volume, NCDHW numpy."""
    vol = np.random.RandomState(seed).rand(1, 3, *SHAPE).astype(np.float32)
    vol = vol * np.float32(scale)
    big = jax_resize(torch.from_numpy(vol),
                     tuple(int(n * 1.5) for n in SHAPE), "trilinear")
    return [vol, np.ascontiguousarray(vol[..., ::-1]), big.numpy()]


@functools.lru_cache(maxsize=None)
def jax_pair():
    """(JAX cfg, model, variables) and the port's Flagship of the recipe,
    same weights."""
    jcfg = recipe(JConfig)
    jmodel = j_build(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1,) + SHAPE + (3,)))
    variables = _randomise(variables, np.random.RandomState(0))
    tcfg = recipe(TConfig)
    model = build_detector(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jcfg, jmodel, variables, Flagship(tcfg, model,
                                             torch.device("cpu"))


def port_run(det, vols):
    out = det.aug_test([dict(imgs=torch.from_numpy(v)) for v in vols],
                       METAS)
    return {k: v.numpy() for k, v in out.items()}


def jax_merge_aug_masks_w(aug_masks, metas, weights=None):
    """`mrcnn3d/detectors/aug.py:merge_aug_masks` flipping W: the JAX
    mask head returns (N, C, D, H, W) (`mrcnn3d/models/heads.py:146`),
    so the package's `[..., :, ::-1, :]` flips H, a fault of the JAX
    package (ROADMAP); the port flips W, the last axis."""
    recovered = [m[..., ::-1] if meta["flip"] else m
                 for m, meta in zip(aug_masks, metas)]
    if weights is None:
        return jnp.mean(jnp.stack(recovered), axis=0)
    w = jnp.asarray(weights, jnp.float32)
    return jnp.tensordot(w / jnp.sum(w), jnp.stack(recovered), axes=1)


def test_aug_test_matches_jax(monkeypatch):
    monkeypatch.setattr(jaug, "merge_aug_masks", jax_merge_aug_masks_w)
    jcfg, jmodel, variables, det = jax_pair()
    vols = views()
    got = port_run(det, vols)
    compare_outputs(got, port_run(det, views(scale=1.0 + MARGIN)), ATOL,
                    "seed too close to a decision boundary")
    sets = []
    for v in vols:
        d, h, w = v.shape[2:]
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x,
                                   method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set([f.shape[1:4] for f in feats],
                                         (h, w, 3, d),
                                         j_anchor_cfgs(jcfg)[0]))
    want = jax.jit(lambda var, xs: jaug.aug_test(
        jmodel, var, [dict(imgs=x) for x in xs], METAS, jcfg, sets))(
            variables, [jnp.asarray(np.moveaxis(v, 1, -1)) for v in vols])
    want = {k: np.asarray(v) for k, v in want.items()}
    want["labels"] = want["labels"].astype(got["labels"].dtype)
    assert got["dets"].shape == (1, 8, 7)
    assert int(got["valid"].sum()) > 2, "vacuous case"
    compare_outputs({**got, "mask_logits": got.pop("mask_probs")},
                    {**want, "mask_logits": want.pop("mask_probs")}, ATOL,
                    "aug_test: port vs JAX")


def test_aug_test_needs_one_pathway():
    cfg = TConfig.fromfile("configs/mask_rcnn_3d_2scales.py")
    cfg.model["backbone"]["base_width"] = 4
    model = build_detector(cfg, device="cpu")
    with pytest.raises(ValueError, match="single-pathway"):
        aug.aug_test(model, [], [], cfg, [])


IMG_SHAPES = [(32, 32, 3, 8), (32, 32, 3, 8), (48, 48, 3, 12)]


def _boxes(rng, n, hi=30.0):
    b = np.sort(rng.uniform(0, hi, (n, 3, 2)), axis=-1)
    return np.stack([b[:, 0, 0], b[:, 1, 0], b[:, 0, 1], b[:, 1, 1],
                     b[:, 2, 0] / 3, b[:, 2, 1] / 3], -1).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_bbox_mappings_match_jax(flip, scale):
    boxes = _boxes(np.random.RandomState(1), 20)
    shape = (48, 40, 3, 12)
    for fn, jfn in ((aug.bbox_mapping_3d, jaug.bbox_mapping_3d),
                    (aug.bbox_mapping_back_3d, jaug.bbox_mapping_back_3d)):
        got = fn(torch.from_numpy(boxes), shape, scale, flip).numpy()
        want = np.asarray(jfn(jnp.asarray(boxes), shape, scale, flip))
        np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    np.testing.assert_array_equal(
        aug.bbox_flip_3d(torch.from_numpy(boxes), shape).numpy(),
        np.asarray(jaug.bbox_flip_3d(jnp.asarray(boxes), shape)))


def test_merge_aug_proposals_matches_jax():
    """Two images, three views of 24 proposals each (overlapping copies
    across views, some invalid): per image the keep set, boxes and scores
    of JAX's merge."""
    rng = np.random.RandomState(3)
    metas = [dict(m, img_shape=s) for m, s in zip(METAS, IMG_SHAPES)]
    base = np.stack([_boxes(rng, 24) for _ in range(2)])
    aug_b, aug_s, aug_v = [], [], []
    for m in metas:
        b = jaug.bbox_mapping_3d(
            jnp.asarray(base + rng.randn(*base.shape).astype(np.float32)),
            m["img_shape"], m["scale_factor"], m["flip"])
        aug_b.append(np.array(b))
        aug_s.append(rng.rand(2, 24).astype(np.float32))
        aug_v.append(rng.rand(2, 24) > 0.2)
    rpn_cfg = dict(nms_thr=0.5, max_num=64)
    got = aug.merge_aug_proposals(
        [torch.from_numpy(x) for x in aug_b],
        [torch.from_numpy(x) for x in aug_s],
        [torch.from_numpy(x) for x in aug_v], metas, rpn_cfg)
    assert got[0].shape == (2, 64, 6)
    for i in range(2):
        want = jaug.merge_aug_proposals(
            [jnp.asarray(x[i]) for x in aug_b],
            [jnp.asarray(x[i]) for x in aug_s],
            [jnp.asarray(x[i]) for x in aug_v], metas, rpn_cfg)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        v = np.asarray(want[2])
        # some rows suppressed or invalid, so the budget is not full
        assert 5 < v.sum() < 64, "vacuous case"
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=EXACT)
        np.testing.assert_array_equal(got[1][i].numpy()[v],
                                      np.asarray(want[1])[v])
    # the budget is min(max_num, views x proposals)
    assert aug.merge_aug_proposals(
        [torch.from_numpy(x) for x in aug_b],
        [torch.from_numpy(x) for x in aug_s],
        [torch.from_numpy(x) for x in aug_v], metas,
        dict(nms_thr=0.5, max_num=2000))[0].shape == (2, 72, 6)


def test_merge_aug_bboxes_scores_masks_match_jax():
    rng = np.random.RandomState(4)
    metas = [dict(m, img_shape=s) for m, s in zip(METAS, IMG_SHAPES)]
    boxes = [np.concatenate([_boxes(rng, 10), _boxes(rng, 10)], -1)
             for _ in metas]
    scores = [rng.rand(10, 2).astype(np.float32) for _ in metas]
    got = aug.merge_aug_bboxes([torch.from_numpy(b) for b in boxes],
                               [torch.from_numpy(s) for s in scores], metas)
    want = jaug.merge_aug_bboxes([jnp.asarray(b) for b in boxes],
                                 [jnp.asarray(s) for s in scores], metas)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=EXACT)
    np.testing.assert_allclose(
        aug.merge_aug_scores([torch.from_numpy(s) for s in scores]).numpy(),
        np.asarray(jaug.merge_aug_scores([jnp.asarray(s) for s in scores])),
        rtol=0, atol=EXACT)
    # masks (N, C, d, h, w) in both packages; JAX's flip along W
    masks = [rng.rand(3, 2, 4, 6, 8).astype(np.float32) for _ in metas]
    for weights in (None, [3.0, 1.0, 2.0]):
        got = aug.merge_aug_masks([torch.from_numpy(m) for m in masks],
                                  metas, weights)
        want = jax_merge_aug_masks_w([jnp.asarray(m) for m in masks],
                                     metas, weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=EXACT)
        # without a flipped view, the JAX package's own merge
        plain = [dict(flip=False)] * len(masks)
        np.testing.assert_allclose(
            aug.merge_aug_masks([torch.from_numpy(m) for m in masks],
                                plain, weights).numpy(),
            np.asarray(jaug.merge_aug_masks(
                [jnp.asarray(m) for m in masks], plain, weights)),
            rtol=0, atol=EXACT)
    # a flipped view un-flips along W, the last axis
    m = torch.from_numpy(masks[0])
    np.testing.assert_allclose(
        aug.merge_aug_masks([m, m.flip(-1)], [dict(flip=False),
                                              dict(flip=True)]).numpy(),
        masks[0], atol=1e-7)
