"""The single-stage and cascade families against the JAX package, on the
CPU: the shared harness and CascadeRCNN3D.

Each family's config is the repo's own (`chip_smoke.family_config`:
configs/retinanet_3d.py, configs/htc_3d.py, and that file with model.type
CascadeRCNN3D), cut by `chip_smoke.family_narrow` to the variants'
recipe: depth 50 (the port's one backbone depth), widths 4/8/32, budgets
16 (8 detections, 8 rois a stage and image); volumes 8x32x32, as the
JAX tests'.  The JAX variables (biases and frozen-BN statistics
randomised with numpy) go through the port's weight bridge.

  * inference: `valid` and `labels` equal, `dets` and `mask_logits` of
    valid rows within 2e-3; the port's decisions first survive a 1e-5
    change of the input (a seed within float noise of a boundary fails
    there instead of at random);
  * training (two images): each loss within 2e-3, each parameter's
    gradient within 2e-3 of the JAX gradient's largest magnitude (2e-2
    for the stem conv, `chip_smoke.JAX_UPDATE_TOL`), the samplers replaying
    JAX's key tree for the family (`family_draws`), every draw's count
    kept under a 1e-4 change of the input.  Training anchors take
    train_cfg.rpn.allowed_border, as `mrcnn3d/apis/train_api.py` builds
    them.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (
    CONFIG,
    JAX_UPDATE_TOL,
    VARIANT_SHAPES,
    compare_outputs,
    family_config,
    family_narrow,
    family_train_batch,
    small_run,
    variant_inputs,
)
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import _fc, _fc0, state_dict_from_jax
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs, build_detector
from mrcnn3d_torch.entry import Flagship
from mrcnn3d_torch.models.heads import SharedFCBBoxHead3D
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise
from test_torch_port_targets import JaxDraws
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
BUDGET = 16
MARGIN = 1e-5
SHAPE = VARIANT_SHAPES[0]


def family_jax_test_config(type_name, config_cls):
    """The JAX tests' cascade / HTC recipe (tests/test_variants.py
    :161-233) without its depth 18: the flagship config with the type
    set, one rcnn stage per IoU threshold 0.4, 0.5 and 0.6, and for HTC
    masks on, a 3-class semantic head and its 14x14x10 stride-8
    extractor."""
    cfg = config_cls.fromfile(CONFIG)
    htc = type_name == "HybridTaskCascade3D"
    cfg.model["type"] = type_name
    cfg.model.pop("rpn_head_2", None)
    if not htc:
        cfg.model.pop("mask_head", None)
    base = dict(cfg.train_cfg["rcnn"])
    stages = []
    for thr in (0.4, 0.5, 0.6):
        st = dict(base)
        st["assigner"] = dict(base["assigner"], pos_iou_thr=thr,
                              neg_iou_thr=thr, min_pos_iou=thr)
        stages.append(st)
    cfg.train_cfg["rcnn"] = stages
    if htc:
        cfg.model["semantic_head"] = dict(
            type="FusedSemanticHead", num_ins=5, fusion_level=1,
            num_convs=2, num_classes=3, ignore_label=255, loss_weight=0.2)
        cfg.model["semantic_roi_extractor"] = dict(
            roi_layer=dict(out_size=14, out_size_depth=10, sample_num=2),
            featmap_strides=[8], featmap_strides_depth=[4])
        cfg.test_cfg["return_bbox_only"] = False
    return cfg


RECIPES = {"config": family_config, "jax_test": family_jax_test_config}


def family_cfg(config_cls, type_name, recipe="config"):
    """A family's narrow config in either package."""
    return family_narrow(RECIPES[recipe](type_name, config_cls), BUDGET)


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 4, 1))


def _allowed(cfg):
    return cfg.train_cfg["rpn"].get("allowed_border", 0)


@functools.lru_cache(maxsize=None)
def family(type_name, recipe="config", seed=0):
    """(JAX config, model, variables, inference anchor sets, training
    anchor sets) of a family, biases and frozen-BN statistics
    randomised."""
    cfg = family_cfg(JConfig, type_name, recipe)
    model = j_build(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1,) + SHAPE + (3,)))
    variables = _randomise(variables, np.random.RandomState(seed))
    d, h, w = SHAPE
    feats = jax.eval_shape(
        lambda x: model.apply(variables, x, method=model.extract_feat),
        jnp.zeros((1, d, h, w, 3)))
    sizes = [f.shape[1:4] for f in feats]
    ac = j_anchor_cfgs(cfg)[0]
    sets = [jpl.build_anchor_set(sizes, (h, w, 3, d), ac)]
    train_sets = [jpl.build_anchor_set(sizes, (h, w, 3, d), ac,
                                       _allowed(cfg))]
    return cfg, model, variables, sets, train_sets


def port_model(type_name, recipe="config", train=False):
    """The port's build of a family on the CPU with the JAX weights."""
    cfg = family_cfg(TConfig, type_name, recipe)
    model = build_detector(cfg, device="cpu", train=train)
    model.load_state_dict(state_dict_from_jax(family(type_name, recipe)[2]),
                          strict=True)
    return cfg, model


def check_inference(type_name, recipe="config", seed=7):
    """The port's simple_test against JAX's; returns the port's outputs."""
    jcfg, jmodel, variables, sets, _ = family(type_name, recipe)
    tcfg, tmodel = port_model(type_name, recipe)
    det = Flagship(tcfg, tmodel, torch.device("cpu"))
    batch = variant_inputs(seed, 1)
    got = small_run(det, batch)
    compare_outputs(got, small_run(det, batch, scale=1.0 + MARGIN), ATOL,
                    "seed too close to a decision boundary")
    want = jax.jit(lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets))(
        variables, {k: jnp.asarray(_nhwc(v)) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    want["labels"] = want["labels"].astype(got["labels"].dtype)
    assert int(got["valid"].sum()) > 2, "vacuous case"
    compare_outputs(got, want, ATOL, "port vs JAX")
    return got


def family_draws(rng, batch_size, stages):
    """JaxDraws for a family's forward_train: split(rng, 2 + 2 * stages)
    (`mrcnn3d/detectors/pipeline.py` cascade_forward_train); the RPN
    samples with key 0, stage t with 2 + t, HTC's interleaved re-sample
    with 2 + stages + t; each split over the images."""
    rngs = jax.random.split(rng, 2 + 2 * stages)
    root = {"rpn": lambda t: rngs[0], "cascade": lambda t: rngs[2 + t],
            "htc_mask": lambda t: rngs[2 + stages + t]}

    def key_of(site):
        stage, t, image = site
        return jax.random.split(root[stage](t), batch_size)[image]

    return JaxDraws(key_of)


def jax_batch(batch):
    return {k: jnp.asarray(_nhwc(v) if k.startswith("imgs") else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def train_pair(type_name, recipe="config", seed=3):
    """One forward_train and backward of each package on the same batch
    and draws: {"jax": (losses, grads by port name), "port": (losses,
    grads, draws' counts), "batch", "rng"}."""
    jcfg, jmodel, variables, _, train_sets = family(type_name, recipe)
    batch = family_train_batch(seed, type_name)
    jb = jax_batch(batch)
    rng = jax.random.PRNGKey(5)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        return jpl.forward_train(jmodel, v, jb, rng, jcfg, train_sets)

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                         jgrads)})
    return {"jax": ({k: float(v) for k, v in jlosses.items()}, jgrads),
            "port": port_train(type_name, batch, rng, recipe),
            "batch": batch, "rng": rng}


def port_train(type_name, batch, rng, recipe="config", scale=1.0):
    """The port's forward_train and backward: (losses, {parameter:
    gradient, zeros where the loss does not reach}, the draws' counts)."""
    cfg, model = port_model(type_name, recipe, train=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["imgs"] = tb["imgs"] * scale
    sets = tpl.anchor_sets_for(model, anchor_cfgs(cfg), [SHAPE],
                               allowed_border=_allowed(cfg))
    draws = family_draws(rng, batch["imgs"].shape[0],
                         max(model.cascade_stages, 1))
    total, losses = tpl.forward_train(model, tb, cfg, sets, draws)
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            draws.highs)


def check_losses(type_name, recipe="config"):
    pair = train_pair(type_name, recipe)
    jlosses, losses = pair["jax"][0], pair["port"][0]
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert abs(losses[k] - v) <= ATOL, (k, losses[k], v)
    return losses


def check_gradients(type_name, recipe="config"):
    pair = train_pair(type_name, recipe)
    jgrads, grads = pair["jax"][1], pair["port"][1]
    assert set(grads) == set(jgrads)
    moved = 0.0
    for name, want in jgrads.items():
        want = want.numpy()
        got = grads[name].contiguous().numpy()
        scale = float(np.abs(want).max())
        tol = JAX_UPDATE_TOL.get(name, ATOL)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(scale, 1e-12),
                                   err_msg=name)
        moved = max(moved, scale)
    assert moved > 0, "no gradient: vacuous case"
    return grads


def check_draw_margin(type_name, recipe="config"):
    """The assignments behind the draws must not sit within float noise
    of a threshold: a 1e-4 change of the input keeps every count."""
    pair = train_pair(type_name, recipe)
    highs = port_train(type_name, pair["batch"], pair["rng"], recipe,
                       scale=1.0 + 1e-4)[2]
    assert pair["port"][2] and highs == pair["port"][2]


# ---------------------------------------------------------------------------
# CascadeRCNN3D
# ---------------------------------------------------------------------------

CASCADE = "CascadeRCNN3D"


def test_cascade_builds_as_jax():
    """Three stages from len(train_cfg.rcnn), one class-agnostic bbox head
    each under mmdet's `bbox_head.{t}` names, no masks, no semantics; the
    flagship's per-scale names stay."""
    cfg = family_cfg(TConfig, CASCADE)
    model = build_detector(cfg, device="cpu")
    jmodel = family(CASCADE)[1]
    assert model.cascade_stages == jmodel.cascade_stages == 3
    assert not model.with_mask and not model.with_semantic
    names = set(model.state_dict())
    assert {f"bbox_head.{t}.fc_reg.weight" for t in range(3)} <= names
    assert model.bbox_head[0].fc_reg.out_features == 6
    assert not any(n.startswith(("mask_head", "semantic_head"))
                   for n in names)
    cfg.train_cfg["rcnn"] = cfg.train_cfg["rcnn"][0]
    assert build_detector(cfg, device="cpu").cascade_stages == 3


def test_class_agnostic_head_matches_jax():
    """The stage head alone: cls and 6 class-agnostic deltas."""
    from mrcnn3d.models.heads import SharedFCBBoxHead3D as JHead

    rng = np.random.RandomState(2)
    x = rng.randn(5, 3, 7, 7, 8).astype(np.float32)
    jhead = JHead(fc_out_channels=32, num_classes=2, reg_class_agnostic=True)
    v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = _randomise(v, rng)
    want = jhead.apply(v, jnp.asarray(x))
    head = SharedFCBBoxHead3D(8 * 3 * 7 * 7, 32, 2, reg_class_agnostic=True)
    p = v["params"]
    for name, mod in (("shared_fc_0", head.shared_fcs[0]),
                      ("shared_fc_1", head.shared_fcs[1]),
                      ("fc_cls", head.fc_cls), ("fc_reg", head.fc_reg)):
        kernel = p[name]["kernel"]
        w = _fc0(kernel, (3, 7, 7)) if name == "shared_fc_0" else _fc(kernel)
        mod.weight.data = torch.from_numpy(np.ascontiguousarray(w))
        mod.bias.data = torch.from_numpy(np.asarray(p[name]["bias"]))
    got = head(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)
    assert got[1].shape == (5, 6)


def test_cascade_simple_test_matches_jax():
    got = check_inference(CASCADE)
    assert "mask_logits" not in got


def test_cascade_forward_train_losses_match_jax():
    keys = {k for k in check_losses(CASCADE) if "loss" in k}
    assert keys == {"loss_rpn_cls", "loss_rpn_reg",
                    *(f"s{t}.loss_{x}" for t in range(3)
                      for x in ("cls", "reg"))}


def test_cascade_gradients_match_jax():
    grads = check_gradients(CASCADE)
    # every stage's head learns
    for t in range(3):
        assert grads[f"bbox_head.{t}.fc_reg.weight"].abs().max() > 0


def test_cascade_draws_have_margin():
    check_draw_margin(CASCADE)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_cascade_samples_each_stage_on_jax_keys(stage):
    """Stage t samples with key 2 + t of split(rng, 8): each stage's
    draws reach the replay, and the counts behind them are the port's
    own assignment of the previous stage's decoded boxes."""
    highs = train_pair(CASCADE)["port"][2]
    sites = {site[:2] for site, _, _ in highs}
    assert ("cascade", stage) in sites
    pos = [h for site, _, h in highs
           if site[:2] == ("cascade", stage) and site[-1] == "pos"]
    assert len(pos) == 2 and min(pos) >= 1
