"""The 3-D two-stage variants against the JAX package, on the CPU: the
single-scale group (RPN3D, FasterRCNN3D, MaskRCNN3D) and the
single-scale entry points.

Each variant's config comes from the flagship's by the JAX tests' recipe
(`chip_smoke.variant_recipe`, tests/test_variants.py:17-37) at a tiny
geometry: depth 50 (the port's one backbone depth), widths 4/8/32,
proposal budgets 16, the R-CNN sampler 8, 8 detections an image;
volumes 8x32x32, their 12x48x48 twins and 18x72x72 third volumes.  The
JAX variables (biases and frozen-BN statistics randomised with numpy) go
through the port's weight bridge.

  * inference: `valid`, `labels` and the parcellation arg-max equal;
    `dets`, `mask_logits` and parcellation scores of valid rows within
    2e-3; the port's decisions first survive a 1e-5 change of the input
    (a seed whose decisions sit within float noise of a boundary fails
    there instead of at random; 1e-5, a hundred times the packages'
    float32 differences, since the 2.25x boxes move by 2e-3 under 1e-4
    without any decision changing);
  * training (two images): each loss within 2e-3, each parameter's
    gradient within 2e-3 of the JAX gradient's largest magnitude (the
    stem conv 2e-2, `chip_smoke.JAX_UPDATE_TOL`: its max-pool's argmax
    follows each package's rounding), the port's samplers replaying the
    JAX key tree, and every draw's count kept under a 1e-4 change of
    the input.  The first SGD step moves a parameter by the learning
    rate times (its gradient + weight decay times itself), so equal
    gradients are equal updates; parameters the loss does not reach
    take a zero gradient in both packages.
"""
import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (
    JAX_UPDATE_TOL,
    VARIANT_SHAPES,
    MaskProbs,
    compare_outputs,
    compare_tiled,
    small_run,
    variant_inputs,
    variant_recipe,
    variant_train_batch,
)
from mrcnn3d.apis import inference as jinference
from mrcnn3d.apis import serve as jserve
from mrcnn3d.apis import test_api as jtest_api
from mrcnn3d.apis import tiled as jtiled
from mrcnn3d.data import coco3d as jcoco3d
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.apis import serve, test_api
from mrcnn3d_torch.apis.inference import inference_detector_3d
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.data import coco3d as tcoco3d
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs, build_detector
from mrcnn3d_torch.entry import Flagship
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise, narrow_cfg
from test_torch_port_targets import forward_train_draws
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
BUDGET = 16
MARGIN = 1e-5
SUFFIXES = ("", "_2", "_3")
TYPES = ("RPN3D", "FasterRCNN3D", "MaskRCNN3D")


def tiny_cfg(config_cls, type_name):
    """A variant at the tiny geometry, masks on."""
    cfg = variant_recipe(narrow_cfg(config_cls), type_name)
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.train_cfg["rpn_proposal"][k] = BUDGET
        cfg.test_cfg["rpn"][k] = BUDGET
    cfg.train_cfg["rcnn"]["sampler"]["num"] = 8
    cfg.test_cfg["rcnn"]["max_per_img"] = 8
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 4, 1))


@functools.lru_cache(maxsize=None)
def variant(type_name, seed=0):
    """(JAX config, model, variables, anchor sets) of a variant, with
    randomised biases and frozen-BN statistics."""
    cfg = tiny_cfg(JConfig, type_name)
    model = j_build(cfg)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1,) + VARIANT_SHAPES[0] + (3,)))
    variables = _randomise(variables, np.random.RandomState(seed))
    sets = []
    for (d, h, w), ac in zip(VARIANT_SHAPES[:model.num_scales],
                             j_anchor_cfgs(cfg)):
        feats = jax.eval_shape(
            lambda x: model.apply(variables, x, method=model.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    return cfg, model, variables, sets


def port_model(type_name, train=False):
    """The port's build of a variant on the CPU with the JAX weights."""
    cfg = tiny_cfg(TConfig, type_name)
    model = build_detector(cfg, device="cpu", train=train)
    model.load_state_dict(state_dict_from_jax(variant(type_name)[2]),
                          strict=True)
    return cfg, model


def check_inference(type_name, seed=7):
    """The port's simple_test against JAX's; returns the port's outputs."""
    jcfg, jmodel, variables, sets = variant(type_name)
    tcfg, tmodel = port_model(type_name)
    det = Flagship(tcfg, tmodel, torch.device("cpu"))
    batch = variant_inputs(seed, tmodel.num_scales)
    got = small_run(det, batch)
    compare_outputs(got, small_run(det, batch, scale=1.0 + MARGIN), ATOL,
                    "seed too close to a decision boundary")
    want = jax.jit(lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets))(
        variables, {k: jnp.asarray(_nhwc(v)) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    for k in ("labels",):
        want[k] = want[k].astype(got[k].dtype)
    assert int(got["valid"].sum()) > 2, "vacuous case"
    compare_outputs(got, want, ATOL, "port vs JAX")
    return got


@functools.lru_cache(maxsize=None)
def train_pair(type_name, seed=3):
    """One forward_train and backward of each package on the same batch
    and draws: {"jax": (losses, grads by port name), "port": (losses,
    grads, draws' counts), "batch", "rng"}."""
    jcfg, jmodel, variables, sets = variant(type_name)
    scales = jmodel.num_scales
    batch = variant_train_batch(seed, scales, jmodel.num_parcellations > 0)
    jb = {k: jnp.asarray(_nhwc(v) if k.startswith("imgs") else v)
          for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        return jpl.forward_train(jmodel, v, jb, rng, jcfg, sets)

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                         jgrads)})
    return {"jax": ({k: float(v) for k, v in jlosses.items()}, jgrads),
            "port": port_train(type_name, batch, rng),
            "batch": batch, "rng": rng}


def port_train(type_name, batch, rng, scale=1.0):
    """The port's forward_train and backward: (losses, {parameter:
    gradient, zeros where the loss does not reach}, the draws' counts)."""
    cfg, model = port_model(type_name, train=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in tb:
        if k.startswith("imgs"):
            tb[k] = tb[k] * scale
    sets = tpl.anchor_sets_for(model, anchor_cfgs(cfg),
                               VARIANT_SHAPES[:model.num_scales])
    draws = forward_train_draws(rng, 2)
    total, losses = tpl.forward_train(model, tb, cfg, sets, draws)
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            draws.highs)


def check_losses(type_name):
    pair = train_pair(type_name)
    jlosses, (losses, _, highs) = pair["jax"][0], pair["port"]
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert abs(losses[k] - v) <= ATOL, (k, losses[k], v)
    assert highs, "no draw"
    return losses


def check_gradients(type_name):
    pair = train_pair(type_name)
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


def check_draw_margin(type_name):
    """The assignments behind the draws must not sit within float noise
    of a threshold: a 1e-4 change of the input keeps every count."""
    pair = train_pair(type_name)
    highs = port_train(type_name, pair["batch"], pair["rng"],
                       scale=1.0 + 1e-4)[2]
    assert highs == pair["port"][2]


@pytest.mark.parametrize("type_name", TYPES)
def test_simple_test_matches_jax(type_name):
    got = check_inference(type_name)
    if type_name == "RPN3D":
        # the proposals are the detections: sigmoid scores, label 0
        s = got["dets"][..., 6][got["valid"]]
        assert ((s >= 0) & (s <= 1)).all() and not got["labels"].any()
        assert "mask_logits" not in got
    else:
        assert ("mask_logits" in got) == (type_name == "MaskRCNN3D")


@pytest.mark.parametrize("type_name", TYPES)
def test_forward_train_losses_match_jax(type_name):
    losses = check_losses(type_name)
    keys = {k for k in losses if "loss" in k}
    if type_name == "RPN3D":
        assert keys == {"loss_rpn_cls", "loss_rpn_reg"}
    else:
        assert {"loss_cls", "loss_reg"} <= keys
        assert ("loss_mask" in keys) == (type_name == "MaskRCNN3D")


@pytest.mark.parametrize("type_name", TYPES)
def test_gradients_match_jax(type_name):
    check_gradients(type_name)


@pytest.mark.parametrize("type_name", TYPES)
def test_draws_have_margin(type_name):
    check_draw_margin(type_name)


# ---------------------------------------------------------------------------
# the single-scale entry points, on MaskRCNN3D
# ---------------------------------------------------------------------------

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
NO_MASKS = [[]]


def _single(bbox_only=False):
    """(JAX cfg, model, variables, port Flagship) of MaskRCNN3D."""
    jcfg, jmodel, variables, _ = variant("MaskRCNN3D")
    tcfg, tmodel = port_model("MaskRCNN3D")
    jcfg = copy.deepcopy(jcfg)
    jcfg.test_cfg["return_bbox_only"] = bbox_only
    tcfg.test_cfg["return_bbox_only"] = bbox_only
    return jcfg, jmodel, variables, Flagship(tcfg, tmodel,
                                             torch.device("cpu"))


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two raw (H, W, D) volumes of a synthetic set, its test datasets in
    both packages, and the volumes' paths."""
    root = tmp_path_factory.mktemp("single")
    ann, img_dir = make_synthetic_coco3d(str(root), num_volumes=2, hw=64,
                                         depth=12, seed=21)
    kw = dict(img_norm_cfg=NORM, with_mask=False, test_mode=True)
    jds = jcoco3d.Coco3DDataset(ann, img_dir, **kw)
    tds = tcoco3d.Coco3DDataset(ann, img_dir, **kw)
    paths = [os.path.join(img_dir, i["file_name"]) for i in tds.img_infos]
    return jds, tds, paths


def _nudged(det, paths, margin=MARGIN):
    """The raw volumes scaled about the normalisation's mean intensity,
    so that the normalised values change by `margin`."""
    mid = np.float32(np.mean(det.cfg.data["test"]["img_norm_cfg"]["mean"]))
    return [mid + (np.load(p) - mid) * np.float32(1 + margin)
            for p in paths]


def test_inference_detector_3d_matches_jax(volumes):
    """inference_detector_3d on raw .npy volumes: per-class detections as
    the JAX API's (rows paired one to one).  The JAX API unpacks three
    outputs, so both run with boxes only."""
    jcfg, jmodel, variables, det = _single(bbox_only=True)
    paths = volumes[2]
    got = list(inference_detector_3d(det, paths))
    for g, n in zip(got, inference_detector_3d(det, _nudged(det, paths))):
        compare_tiled((n, NO_MASKS), (g, NO_MASKS), {}, ATOL,
                      "seed too close to a decision boundary")
    want = list(jinference.inference_detector_3d(jmodel, variables, jcfg,
                                                 paths))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        compare_tiled((g, NO_MASKS), (w, NO_MASKS), {}, ATOL, "port vs JAX")
    assert sum(len(c) for g in got for c in g) > 4


def test_run_inference_single_scale_matches_jax(volumes):
    """run_inference over a single-scale test set (no twin fed): rows and
    counts as the JAX package's, one mask carrier per row."""
    jcfg, jmodel, variables, det = _single()
    jds, tds, _ = volumes
    results, infos, segms = test_api.run_inference(det.cfg, det.model, tds,
                                                   progress=False)
    jresults, jinfos = jtest_api.run_inference(jcfg, jmodel, variables, jds,
                                               progress=False)[:2]
    assert infos == jinfos
    for res, seg, jres in zip(results, segms, jresults):
        compare_tiled((res, NO_MASKS), (jres, NO_MASKS), {}, ATOL,
                      "run_inference port vs JAX")
        assert [len(s) for s in seg] == [len(r) for r in res]
    assert sum(len(c) for r in results for c in r) > 4


def test_serve_single_scale_matches_jax(volumes, tmp_path):
    """serve_paths and watch of a single-scale detector (no twin made)
    against the JAX package's serve_paths on the same files."""
    jcfg, jmodel, variables, det = _single(bbox_only=True)
    paths = volumes[2]
    runner = test_api.InferenceRunner(det.cfg, det.model)
    got = list(serve.serve_paths(runner, paths, NORM))
    want = list(jserve.serve_paths(
        jtest_api.InferenceRunner(jcfg, jmodel, variables), paths, NORM))
    assert [p for p, _ in got] == [p for p, _ in want] == paths
    serve.watch(runner, os.path.dirname(paths[0]), str(tmp_path), NORM,
                poll_s=0.01, stop_after=len(paths))
    for (path, rows), (_, jrows) in zip(got, want):
        compare_tiled((rows, NO_MASKS), (jrows, NO_MASKS), {}, ATOL,
                      "serve port vs JAX")
        name = os.path.splitext(os.path.basename(path))[0] + ".json"
        with open(tmp_path / name) as f:
            rec = json.load(f)
        written = [np.asarray(rec["class_1"], np.float32).reshape(-1, 7)]
        compare_tiled((written, NO_MASKS), (rows, NO_MASKS), {}, 0.0,
                      "watch's json")
    assert [list(k) for k in runner.det._anchor_sets] == [[(12, 64, 64)]]
    assert sum(len(r[0]) for _, r in got) > 4


def test_tiled_single_scale_matches_jax():
    """A 2-tile single-scale sweep with masks (no twin derived): per-class
    counts, rows and masks off the band as the JAX package's."""
    jcfg, jmodel, variables, det = _single()
    vol = np.random.RandomState(4).randn(12, 32, 48, 3).astype(np.float32)
    kw = dict(patch_hw=32, patch_d=12, overlap=0.5)
    timers = {}
    with MaskProbs() as rec:
        got = det.tiled(dict(imgs=vol), timers=timers, **kw)
    with MaskProbs():
        nudged = det.tiled(dict(imgs=vol * np.float32(1 + MARGIN)), **kw)
    compare_tiled(nudged, got, rec.probs, ATOL,
                  "seed too close to a decision boundary")
    with MaskProbs(jtiled) as jrec:
        want = jtiled.tiled_inference(jcfg, jmodel, variables,
                                      dict(imgs=vol), **kw)
    compare_tiled(got, want, jrec.probs, ATOL, "port vs JAX")
    assert timers["n_tiles"] == 2
    assert sum(len(r) for r in got[0]) > 4
    assert [list(k) for k in det._anchor_sets] == [[(12, 32, 32)]]
