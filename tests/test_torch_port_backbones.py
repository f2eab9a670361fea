"""The other backbones against the JAX package, on the CPU: ResNet3D at
depth 18 and 34 (BasicBlock3D), ResNeXt3D and UNet3D, alone and under
the flagship detector; ResNet3D-101 and -152 by their parameters.

  * alone, at narrow widths (ResNeXt3D at groups 4, width 8, as
    tests/test_extra_components.py builds it; UNet3D at base 4) on an
    8x32x32 volume: every output within 2e-3;
  * the flagship config with the backbone swapped (`chip_smoke.
    backbone_recipe`) at the variants' tiny geometry (widths 4/8/32,
    budgets 16, 8 detections): simple_test's `valid` and `labels`
    equal, `dets` and `mask_logits` of valid rows within 2e-3, the
    port's decisions first surviving a 1e-5 change of the input;
  * ResNet3D-101 and -152: the port's parameter names and shapes equal
    the bridged ones of JAX's `jax.eval_shape` of `init` (no compile);
  * one CPU train step of the port under each backbone: finite losses.

The JAX variables (biases and frozen-BN statistics randomised with
numpy) go through the port's weight bridge.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (
    BACKBONES,
    VARIANT_SHAPES,
    backbone_recipe,
    compare_outputs,
    small_run,
    small_train_batch,
    small_train_config,
    UNET_SMALL_SHAPES,
)
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.models.backbones_extra import ResNeXt3D as JResNeXt3D
from mrcnn3d.models.backbones_extra import UNet3D as JUNet3D
from mrcnn3d.models.resnet3d import ResNet3D as JResNet3D
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.entry import Flagship, build_trainer
from mrcnn3d_torch.models.backbones_extra import ResNeXt3D, UNet3D
from mrcnn3d_torch.models.detector import build_backbone
from mrcnn3d_torch.models.resnet3d import ResNet3D
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise, narrow_cfg, to_cf, to_cl
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
BUDGET = 16
MARGIN = 1e-5


# name -> (JAX module, port module), narrow
MODULES = {
    "ResNet3D-18": (lambda: JResNet3D(depth=18, base_width=4),
                    lambda: ResNet3D(depth=18, base_width=4)),
    "ResNet3D-34": (lambda: JResNet3D(depth=34, base_width=4),
                    lambda: ResNet3D(depth=34, base_width=4)),
    "ResNeXt3D": (lambda: JResNeXt3D(depth=50, groups=4, base_width=4,
                                     width=8),
                  lambda: ResNeXt3D(depth=50, groups=4, base_width=4,
                                    width=8)),
    "UNet3D": (lambda: JUNet3D(base_channels=4),
               lambda: UNet3D(base_channels=4)),
}


def _backbone_state(variables):
    """The bridged state dict of a backbone's variables alone."""
    sd = state_dict_from_jax({
        "params": {"backbone": variables["params"], "neck": {}},
        "batch_stats": {"backbone": variables.get("batch_stats", {})}})
    return {k[len("backbone."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_backbone_matches_jax(name):
    jmod, tmod = (f() for f in MODULES[name])
    x = np.random.RandomState(1).randn(1, 3, 8, 32, 32).astype(np.float32)
    jx = jnp.asarray(to_cl(x))
    variables = _randomise(jax.jit(jmod.init)(jax.random.PRNGKey(0), jx),
                           np.random.RandomState(2))
    want = jax.jit(jmod.apply)(variables, jx)
    tmod.load_state_dict(_backbone_state(variables), strict=True)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    assert [tuple(g.shape[1:2]) for g in got] == \
        [(c,) for c in tmod.out_channels]
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(to_cf(w), g.numpy(), atol=ATOL,
                                   err_msg=f"{name} output {i}")
    if name == "UNet3D":
        # fine to coarse, the finest at stride 1
        assert tuple(got[0].shape[2:]) == (8, 32, 32)
        assert [tuple(g.shape[2:]) for g in got] == \
            tmod.featmap_sizes((8, 32, 32))
    if name == "ResNeXt3D":
        assert tmod.layer1[0].conv2.groups == 4


def tiny_cfg(config_cls, backbone):
    """The flagship at the tiny geometry with `backbone`, masks on."""
    cfg = backbone_recipe(narrow_cfg(config_cls), backbone)
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.train_cfg["rpn_proposal"][k] = BUDGET
        cfg.test_cfg["rpn"][k] = BUDGET
    cfg.train_cfg["rcnn"]["sampler"]["num"] = 8
    cfg.test_cfg["rcnn"]["max_per_img"] = 8
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 4, 1))


def shapes_of(backbone):
    """The volumes of the two scales: UNet3D's three poolings and three
    crops need sides divisible by 8, so its 1.0x volume is 16x32x32."""
    return UNET_SMALL_SHAPES if backbone == "UNet3D" else VARIANT_SHAPES[:2]


def inputs_of(backbone, seed=7):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(1, 3, *s).astype(np.float32)
            for k, s in zip(("imgs", "imgs_2"), shapes_of(backbone))}


@functools.lru_cache(maxsize=None)
def jax_detector(backbone, seed=0):
    """(JAX config, model, variables, anchor sets) of the tiny flagship
    with `backbone`."""
    cfg = tiny_cfg(JConfig, backbone)
    model = j_build(cfg)
    shapes = shapes_of(backbone)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1,) + shapes[0] + (3,)))
    variables = _randomise(variables, np.random.RandomState(seed))
    sets = []
    for (d, h, w), ac in zip(shapes, j_anchor_cfgs(cfg)):
        feats = jax.eval_shape(
            lambda x: model.apply(variables, x, method=model.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    return cfg, model, variables, sets


DETECTOR_BACKBONES = ("ResNet3D-18", "ResNet3D-34", "ResNeXt3D-50", "UNet3D")


@pytest.mark.parametrize("backbone", DETECTOR_BACKBONES)
def test_simple_test_matches_jax(backbone):
    jcfg, jmodel, variables, sets = jax_detector(backbone)
    tcfg = tiny_cfg(TConfig, backbone)
    model = build_detector(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    det = Flagship(tcfg, model, torch.device("cpu"))
    batch = inputs_of(backbone)
    got = small_run(det, batch)
    compare_outputs(got, small_run(det, batch, scale=1.0 + MARGIN), ATOL,
                    "seed too close to a decision boundary")
    want = jax.jit(lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets))(
        variables, {k: jnp.asarray(_nhwc(v)) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    want["labels"] = want["labels"].astype(got["labels"].dtype)
    assert int(got["valid"].sum()) > 2, "vacuous case"
    compare_outputs(got, want, ATOL, f"{backbone}: port vs JAX")
    assert [tuple(f.shape[2:]) for f in model.extract_feat(
        torch.from_numpy(batch["imgs"]))] == \
        model.featmap_sizes(shapes_of(backbone)[0])


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnet_parameters_match_jax(depth):
    """The bridged names and shapes of JAX's parameters (from
    jax.eval_shape of init, nothing compiled) are the port's."""
    backbone = f"ResNet3D-{depth}"
    jcfg = tiny_cfg(JConfig, backbone)
    jmodel = j_build(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + VARIANT_SHAPES[0] + (3,)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape)
            for k, v in state_dict_from_jax(zeros).items()}
    model = build_detector(tiny_cfg(TConfig, backbone), device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    blocks = [len(getattr(model.backbone, f"layer{i}")) for i in (1, 2, 3, 4)]
    assert blocks == {101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_train_step_runs(backbone):
    """A CPU train step of the narrow flagship under each backbone."""
    cfg = backbone_recipe(small_train_config(), backbone)
    trainer = build_trainer(cfg, device="cpu")
    batch = small_train_batch(3, shapes=shapes_of(backbone))
    losses = trainer.step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert trainer.state.step == 1 and "loss_mask" in losses
    assert all(bool(torch.isfinite(v)) for v in losses.values())


def test_backbone_types():
    """The dispatch on backbone.type: unknown types raise naming
    themselves; depths outside ARCH_SETTINGS raise."""
    with pytest.raises(KeyError, match="'VGG3D'"):
        build_backbone("VGG3D")
    with pytest.raises(KeyError, match="depth 26"):
        build_backbone("ResNet3D", depth=26)
    assert isinstance(build_backbone("UNet3D"), UNet3D)
    assert build_backbone("ResNet3D", depth=18).out_channels == \
        [16, 32, 64, 128]
    assert build_backbone("ResNeXt3D").layer1[0].conv2.groups == 32
