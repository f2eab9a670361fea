"""RetinaNet3D against the JAX package, on the CPU: the focal loss and its
binary targets, the focal anchor targets, the RetinaHead3D alone, the
training anchors' border rule, and the whole detector (inference, losses,
gradients) from configs/retinanet_3d.py at the narrow recipe of
`test_torch_port_families_cascade.py`, whose harness and tolerances
these tests share.  RetinaNet samples nothing, so its training takes no
draws."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcnn3d.core import targets as jt
from mrcnn3d.models.heads import RetinaHead3D as JRetinaHead
from mrcnn3d.ops import losses as jlosses
from mrcnn3d_torch.core import targets as tt
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.entry import build_trainer
from mrcnn3d_torch.models.heads import RetinaHead3D
from mrcnn3d_torch.ops import losses as tlosses
from mrcnn3d_torch.ops.nms3d import _MAX_ROWS
from mrcnn3d_torch.utils.config import Config as TConfig
from chip_smoke import MAIN_SHAPES, family_config
from test_torch_port_families_cascade import (
    SHAPE,
    check_gradients,
    check_inference,
    check_losses,
    family,
    family_cfg,
)
from test_torch_port_models import _randomise
from test_torch_port_targets import _boxes, _gts, _jitter
from torch_port_fixtures import torch_threads  # noqa: F401

RETINA = "RetinaNet3D"
STDS = (0.1, 0.1, 0.2, 0.2, 0.1, 0.1)


def _focal_inputs(seed, n=300, c=3):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    logits[:10] = 0.0  # the gradient at logit 0 (Queue C 5)
    labels = rng.randint(0, c + 1, n).astype(np.int32)
    weights = rng.choice([0.0, 1.0, 2.5], n).astype(np.float32)
    return logits, labels, weights


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.5)])
def test_focal_loss_and_gradient_match_jax(gamma, alpha):
    logits, labels, weights = _focal_inputs(0)
    c = logits.shape[1]

    def jloss(x):
        bl, _ = jlosses.expand_binary_labels(jnp.asarray(labels),
                                             jnp.asarray(weights), c)
        return jlosses.weighted_sigmoid_focal_loss(
            x, bl, jnp.asarray(weights)[:, None], 7.0, gamma, alpha)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    bl, bw = tlosses.expand_binary_labels(torch.from_numpy(labels),
                                          torch.from_numpy(weights), c)
    jbl, jbw = jlosses.expand_binary_labels(jnp.asarray(labels),
                                            jnp.asarray(weights), c)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jbl))
    np.testing.assert_array_equal(bw.numpy(), np.asarray(jbw))
    got = tlosses.weighted_sigmoid_focal_loss(
        x, bl, torch.from_numpy(weights)[:, None], 7.0, gamma, alpha)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)


def test_anchor_target_focal_single_matches_jax():
    """No sampling: labels carry the gt class, weights and targets as
    JAX's, num_pos at least 1 (also with no gt)."""
    rng = np.random.RandomState(1)
    gt, gtv = _gts(rng)
    anchors = np.concatenate([_jitter(rng, gt, 150, 2.0),
                              _boxes(rng, 150)])
    inside = rng.rand(300) > 0.1
    labels = rng.randint(1, 3, gt.shape[0]).astype(np.int32)
    cfg = dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                             min_pos_iou=0.0), pos_weight=2)
    for valid in (gtv, np.zeros_like(gtv)):
        args = (anchors, inside, gt, valid, labels)
        want = jt.anchor_target_focal_single(
            *map(jnp.asarray, args), cfg, (0.0,) * 6, STDS)
        got = tt.anchor_target_focal_single(
            *map(torch.from_numpy, args), cfg, (0.0,) * 6, STDS)
        assert set(got) == set(want)
        for k, w in want.items():
            # JAX keeps the box weights as one column, broadcast by the
            # loss; the port's are (A, 6) as anchor_target_single's
            w = np.broadcast_to(np.asarray(w), got[k].shape)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert int(got["num_pos"]) == 1


def test_retina_head_matches_jax():
    """The towers, the 3x3x3 class and delta convs, through the bridge's
    names (`bbox_head.cls_convs.{i}.conv`, `.retina_cls`, ...)."""
    from mrcnn3d_torch.compat.jax_weights import _conv

    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 6, 6, 8).astype(np.float32)
    jhead = JRetinaHead(feat_channels=8, num_anchors=2, cls_out_channels=1)
    v = _randomise(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jhead.apply(v, jnp.asarray(x))
    head = RetinaHead3D(8, 4, num_anchors=2, cls_out_channels=1)
    p = v["params"]
    mods = {**{f"cls_conv_{i}": head.cls_convs[i].conv for i in range(4)},
            **{f"reg_conv_{i}": head.reg_convs[i].conv for i in range(4)},
            "retina_cls": head.retina_cls, "retina_reg": head.retina_reg}
    for name, mod in mods.items():
        mod.weight.data = torch.from_numpy(
            np.ascontiguousarray(_conv(p[name]["kernel"])))
        mod.bias.data = torch.from_numpy(np.asarray(p[name]["bias"]))
    got = head(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.detach().numpy(), np.transpose(np.asarray(w), (0, 4, 1, 2, 3)),
            rtol=0, atol=1e-5)


def test_retina_builds_as_jax():
    """The anchor head is a RetinaHead3D named `bbox_head` (mmdet's
    RetinaNet), 2 anchors (scales [2, 3]) and 4 stacked convs (the
    JAX package's default: its build_detector passes none); no R-CNN
    stage."""
    model = build_detector(family_cfg(TConfig, RETINA), device="cpu")
    jmodel = family(RETINA)[1]
    assert model.single_stage and jmodel.single_stage
    assert jmodel.num_anchors == 2 and len(model.bbox_head.cls_convs) == 4
    assert model.bbox_head.retina_cls.out_channels == 2
    assert not any(n.startswith(("rpn_head", "mask_head"))
                   for n in model.state_dict())


def test_training_anchors_take_the_allowed_border():
    """configs/retinanet_3d.py trains with allowed_border -1: every
    anchor counts as inside, as `mrcnn3d/apis/train_api.py` builds them;
    the inference sets keep the default 0."""
    trainer = build_trainer(family_cfg(TConfig, RETINA), device="cpu")
    sets = trainer.state.anchor_sets([SHAPE])
    inside = torch.cat(list(sets[0].inside))
    want = np.concatenate(family(RETINA)[4][0].inside)
    np.testing.assert_array_equal(inside.numpy(), want)
    assert want.all()
    assert not np.concatenate(family(RETINA)[3][0].inside).all()


def test_decode_rows_at_the_headline_geometry():
    """At 64x512x512 the decode keeps nms_pre (1000) anchors on levels
    0-3 and all 256 of level 4: one class-wise K1 problem of 4256 rows an
    image, within K1's segment limit."""
    cfg = family_config(RETINA)
    model = build_detector(family_cfg(TConfig, RETINA), device="cpu")
    nms_pre = cfg.test_cfg["rpn"]["nms_pre"]
    anchors = 2
    rows = [min(int(np.prod(s)) * anchors, nms_pre)
            for s in model.featmap_sizes(MAIN_SHAPES[0])]
    assert rows == [1000, 1000, 1000, 1000, 256]
    assert sum(rows) == 4256 <= _MAX_ROWS


def test_retina_simple_test_matches_jax():
    got = check_inference(RETINA)
    s = got["dets"][..., 6][got["valid"]]
    assert ((s > 0.05) & (s <= 1)).all()


def test_retina_forward_train_losses_match_jax():
    assert set(check_losses(RETINA)) == {"loss_cls", "loss_reg"}


def test_retina_gradients_match_jax():
    grads = check_gradients(RETINA)
    assert grads["bbox_head.retina_cls.weight"].abs().max() > 0


def test_tiled_retina_matches_jax():
    """A 2-tile sweep of RetinaNet3D through the single-scale tiled path
    (no twin derived; boxes only, as its config asks): per-class counts
    and rows as the JAX package's."""
    from chip_smoke import compare_tiled
    from mrcnn3d.apis import tiled as jtiled
    from mrcnn3d_torch.entry import Flagship
    from test_torch_port_families_cascade import MARGIN, port_model

    jcfg, jmodel, variables = family(RETINA)[:3]
    tcfg, tmodel = port_model(RETINA)
    det = Flagship(tcfg, tmodel, torch.device("cpu"))
    vol = np.random.RandomState(4).randn(8, 32, 48, 3).astype(np.float32)
    kw = dict(patch_hw=32, patch_d=8, overlap=0.5)
    timers = {}
    # boxes only: per-class rows, no mask carriers
    got = (det.tiled(dict(imgs=vol), timers=timers, **kw), [[]])
    nudged = (det.tiled(dict(imgs=vol * np.float32(1 + MARGIN)), **kw),
              [[]])
    compare_tiled(nudged, got, {}, 2e-3,
                  "seed too close to a decision boundary")
    want = (jtiled.tiled_inference(jcfg, jmodel, variables, dict(imgs=vol),
                                   **kw), [[]])
    compare_tiled(got, want, {}, 2e-3, "port vs JAX")
    assert timers["n_tiles"] == 2 and sum(len(r) for r in got[0]) > 4
