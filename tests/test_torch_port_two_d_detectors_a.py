"""The 2-D legacy family's detectors against the JAX package, on the
CPU: the shared harness, FasterRCNN (training included), RPN and
FastRCNN.

Each type's config is `chip_smoke.two_d_config` (configs/faster_rcnn_2d.py
with the type set; MaskRCNN and HTC with the JAX tests' mask recipe,
RetinaNet with configs/retinanet_3d.py's focal head, the cascades with
mmdet's three stages), cut by `chip_smoke.two_d_narrow` to the JAX tests'
cfg2d (tests/test_2d_family.py:37-51): ResNet-18 at base width 8, FPN
32, fcs 64, 3 classes, budgets 32; 1x64x64 images.  The JAX variables
(biases and frozen-BN statistics randomised with numpy) go through the
port's weight bridge, the first fc ordered by the config's (1, 7, 7)
align.

  * inference: `valid` and `labels` equal, `dets` and `mask_logits` of
    valid rows within 2e-3, every box in the z = 0 plane; the port's
    decisions first survive a 1e-5 change of the input;
  * training (FasterRCNN here, MaskRCNN in the _b file; two images):
    the samplers replay JAX's key tree (`forward_train_draws`), each
    loss within 2e-3, each parameter's gradient within 2e-3 of the JAX
    gradient's largest (2e-2 for the stem conv under its (1, 3, 3)
    max-pool, `chip_smoke.JAX_UPDATE_TOL`), every draw's count kept
    under a 1e-4 change of the input;
  * the other types' training: one port train step, finite losses,
    every parameter the losses reach moved.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (
    JAX_UPDATE_TOL,
    TWO_D_SMALL_SHAPE,
    compare_outputs,
    small_run,
    two_d_config,
    two_d_inputs,
    two_d_narrow,
    two_d_train_batch,
)
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import roi_shape, state_dict_from_jax
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs, build_detector
from mrcnn3d_torch.entry import Flagship, build_trainer
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_families_cascade import family_draws
from test_torch_port_models import _randomise
from test_torch_port_targets import forward_train_draws, rgb_draws
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
MARGIN = 1e-5
SHAPE = TWO_D_SMALL_SHAPE


def cfg_of(type_name, config_cls):
    return two_d_narrow(two_d_config(type_name, config_cls))


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 4, 1))


def _allowed(cfg):
    return cfg.train_cfg["rpn"].get("allowed_border", 0)


@functools.lru_cache(maxsize=None)
def jax_side(type_name, seed=0):
    """(JAX config, model, variables, inference anchor sets, training
    anchor sets) of a 2-D type, biases and BN statistics randomised."""
    cfg = cfg_of(type_name, JConfig)
    model = j_build(cfg)
    assert model.two_d
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1,) + SHAPE + (3,)))
    variables = _randomise(variables, np.random.RandomState(seed))
    d, h, w = SHAPE
    feats = jax.eval_shape(
        lambda x: model.apply(variables, x, method=model.extract_feat),
        jnp.zeros((1, d, h, w, 3)))
    sizes = [f.shape[1:4] for f in feats]
    assert all(s[0] == 1 for s in sizes)
    ac = j_anchor_cfgs(cfg)[0]
    sets = [jpl.build_anchor_set(sizes, (h, w, 3, d), ac)]
    train_sets = [jpl.build_anchor_set(sizes, (h, w, 3, d), ac,
                                       _allowed(cfg))]
    return cfg, model, variables, sets, train_sets


def port_model(type_name, train=False):
    """The port's build of a 2-D type on the CPU with the JAX weights."""
    cfg = cfg_of(type_name, TConfig)
    model = build_detector(cfg, device="cpu", train=train)
    model.load_state_dict(
        state_dict_from_jax(jax_side(type_name)[2], roi_shape(cfg)),
        strict=True)
    return cfg, model


def check_inference(type_name, seed=7):
    """The port's simple_test against JAX's; returns the port's outputs."""
    jcfg, jmodel, variables, sets, _ = jax_side(type_name)
    tcfg, tmodel = port_model(type_name)
    det = Flagship(tcfg, tmodel, torch.device("cpu"))
    batch = two_d_inputs(seed, proposals=type_name == "FastRCNN")
    got = small_run(det, batch)
    compare_outputs(got, small_run(det, batch, scale=1.0 + MARGIN), ATOL,
                    "seed too close to a decision boundary")
    jb = {k: jnp.asarray(_nhwc(v) if k == "imgs" else v)
          for k, v in batch.items()}
    want = jax.jit(lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets))(
        variables, jb)
    want = {k: np.asarray(v) for k, v in want.items()}
    want["labels"] = want["labels"].astype(got["labels"].dtype)
    assert int(got["valid"].sum()) > 2, "vacuous case"
    compare_outputs(got, want, ATOL, "port vs JAX")
    v = got["valid"][0]
    assert np.abs(got["dets"][0][v][:, 4:6]).max() == 0.0  # z = [0, 0]
    return got


def draws_for(model, rng, batch_size):
    """JAX's key tree for the type's forward_train: the two-stage one
    (split(rng, 8)), the cascade's (split(rng, 2 + 2 * stages)) or the
    RGB family's (split(rng, 6))."""
    if model.cascade_stages:
        return family_draws(rng, batch_size, model.cascade_stages)
    if model.rgb:
        return rgb_draws(rng, batch_size)
    return forward_train_draws(rng, batch_size)


def port_train(type_name, batch, rng, scale=1.0):
    """The port's forward_train and backward: (losses, {parameter:
    gradient, zeros where the loss does not reach}, the draws' counts)."""
    cfg, model = port_model(type_name, train=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["imgs"] = tb["imgs"] * scale
    sets = tpl.anchor_sets_for(model, anchor_cfgs(cfg), [SHAPE],
                               allowed_border=_allowed(cfg))
    draws = draws_for(model, rng, batch["imgs"].shape[0])
    total, losses = tpl.forward_train(model, tb, cfg, sets, draws)
    total.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            draws.highs)


@functools.lru_cache(maxsize=None)
def train_pair(type_name, seed=3):
    """One forward_train and backward of each package on the same batch
    and draws."""
    jcfg, jmodel, variables, _, train_sets = jax_side(type_name)
    batch = two_d_train_batch(seed, type_name)
    jb = {k: jnp.asarray(_nhwc(v) if k == "imgs" else v)
          for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        return jpl.forward_train(jmodel, v, jb, rng, jcfg, train_sets)

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads)},
        roi_shape(cfg_of(type_name, TConfig)))
    return {"jax": ({k: float(v) for k, v in jlosses.items()}, jgrads),
            "port": port_train(type_name, batch, rng), "batch": batch,
            "rng": rng}


def check_training(type_name):
    """Losses, gradients and the draws' margin against JAX."""
    pair = train_pair(type_name)
    (jlosses, jgrads), (losses, grads, highs) = pair["jax"], pair["port"]
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert abs(losses[k] - v) <= ATOL, (k, losses[k], v)
    assert set(grads) == set(jgrads)
    moved = 0.0
    for name, want in jgrads.items():
        want = want.numpy()
        scale = float(np.abs(want).max())
        tol = JAX_UPDATE_TOL.get(name, ATOL) * max(scale, 1e-12)
        np.testing.assert_allclose(grads[name].contiguous().numpy(), want,
                                   rtol=0, atol=tol, err_msg=name)
        moved = max(moved, scale)
    assert moved > 0, "no gradient: vacuous case"
    again = port_train(type_name, pair["batch"], pair["rng"],
                       scale=1.0 + 1e-4)[2]
    assert highs and again == highs
    pos = [h for site, _, h in highs if site[-1] == "pos"]
    assert pos and min(pos) >= 1, "no positives: vacuous case"
    return losses, grads


def check_one_step(type_name):
    """One port train step of the narrow config: finite losses, every
    parameter with a nonzero gradient moved."""
    cfg = cfg_of(type_name, TConfig)
    trainer = build_trainer(cfg, device="cpu", seed=0)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    batch = {k: torch.from_numpy(v)
             for k, v in two_d_train_batch(3, type_name).items()}
    losses = trainer.step(batch)
    assert all(bool(torch.isfinite(v)) for v in losses.values()), losses
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert "backbone.conv1.weight" in moved
    return losses, moved


# ---------------------------------------------------------------------------
# FasterRCNN, RPN, FastRCNN
# ---------------------------------------------------------------------------


def test_two_d_types_build_as_jax():
    """Each 2-D type's flags and parameter tree: the depth-1 backbone at
    the config's width, the heads' 2-D kernels where JAX gives them
    (mask, HTC, semantic, RetinaNet) and 3x3x3 elsewhere (RPN, FPN)."""
    from chip_smoke import TWO_D

    for type_name in TWO_D:
        cfg = cfg_of(type_name, TConfig)
        model = build_detector(cfg, device="cpu")
        assert model.two_d and model.backbone.two_d
        assert model.backbone.conv1.kernel_size == (1, 7, 7)
        assert model.neck.fpn_convs[0].conv.kernel_size == (3, 3, 3)
        if type_name in ("MaskRCNN", "HybridTaskCascade"):
            head = (model.mask_head[0] if model.cascade_stages
                    else model.mask_head)
            assert head.upsample.kernel_size == (1, 2, 2)
    cfg = two_d_config("FasterRCNN", TConfig)
    assert build_detector(cfg, device="cpu").backbone.base_width == 64
    cfg.model["backbone"].pop("base_width")
    assert build_detector(cfg, device="cpu").backbone.base_width == 64


def test_faster_rcnn_simple_test_matches_jax():
    got = check_inference("FasterRCNN")
    assert "mask_logits" not in got


def test_faster_rcnn_forward_train_matches_jax():
    losses, grads = check_training("FasterRCNN")
    assert {"loss_rpn_cls", "loss_rpn_reg", "loss_cls", "loss_reg"} <= \
        set(losses)
    assert grads["bbox_head.fc_reg.weight"].abs().max() > 0


def test_rpn_simple_test_matches_jax():
    """RPN: the proposals are the detections, label 0."""
    got = check_inference("RPN")
    assert not got["labels"][got["valid"]].any()


def test_fast_rcnn_simple_test_matches_jax():
    """FastRCNN on precomputed proposals (the last two invalid): no RPN
    at inference."""
    check_inference("FastRCNN")


def test_rpn_and_fast_rcnn_train_steps():
    losses, _ = check_one_step("RPN")
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_reg", "loss"}
    losses, moved = check_one_step("FastRCNN")
    assert "loss_cls" in losses and "bbox_head.fc_cls.weight" in moved
