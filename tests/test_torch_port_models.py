"""PyTorch port vs JAX: per-module forwards on the same weights.

The JAX model is initialised at narrow widths (depth 50 kept, so every
Bottleneck3D path runs), its biases and frozen-BN statistics are
randomised with numpy, and the variables go through the port's weight
bridge (`state_dict_from_jax`).  Inputs come from numpy and are fed to
both packages.  Tolerance atol 2e-3, that of the existing torch replay
tests (float32 convolutions summed in different orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.ops.box3d import delta2bbox3d as j_delta2bbox3d
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs as t_anchor_cfgs
from mrcnn3d_torch.detectors.build import build_detector as t_build
from mrcnn3d_torch.ops.box3d import delta2bbox3d as t_delta2bbox3d
from mrcnn3d_torch.utils.config import Config as TConfig
from torch_port_fixtures import torch_threads  # noqa: F401

CFG = "configs/mask_rcnn_3d_2scales.py"
ATOL = 2e-3


def narrow_cfg(config_cls):
    """The flagship config at narrow widths (depth 50 kept)."""
    cfg = config_cls.fromfile(CFG)
    cfg.model["backbone"]["base_width"] = 4
    cfg.model["neck"]["out_channels"] = 8
    for head in ("bbox_head", "refinement_head"):
        cfg.model[head]["fc_out_channels"] = 32
    return cfg


def _randomise(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "bias":
            v = rng.randn(*v.shape).astype(np.float32) * 0.1
        elif k == "scale":
            v = 1.0 + rng.randn(*v.shape).astype(np.float32) * 0.1
        elif k == "mean":
            v = rng.randn(*v.shape).astype(np.float32) * 0.1
        elif k == "var":
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        out[k] = v
    return out


def jax_flagship(seed=0):
    """(cfg, model, variables as nested numpy dicts) of the narrow JAX
    flagship with randomised biases and BN statistics."""
    cfg = narrow_cfg(JConfig)
    model = j_build(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 32, 32, 3))
    )
    variables = _randomise(variables, np.random.RandomState(seed))
    return cfg, model, variables


def port_flagship(variables):
    """The narrow port flagship on the CPU, loaded with `variables`."""
    cfg = narrow_cfg(TConfig)
    model = t_build(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg, model


def to_cl(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 4, 1))


def to_cf(x):
    return np.transpose(np.asarray(x), (0, 4, 1, 2, 3))


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, variables = jax_flagship()
    tcfg, tmodel = port_flagship(variables)
    return jmodel, variables, tmodel


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("shape", [(8, 32, 32), (7, 30, 30)])
def test_backbone_fpn_rpn(pair, shape):
    """Backbone stages, FPN levels (odd sizes in the second shape) and
    both RPN heads on every level."""
    jmodel, variables, tmodel = pair
    x = np.random.RandomState(1).randn(1, 3, *shape).astype(np.float32)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        tstages = tmodel.backbone(tx)
        tfeats = tmodel.neck(tstages)
        trpn = [tmodel.rpn(tfeats, s) for s in range(2)]
    jx = jnp.asarray(to_cl(x))
    jstages = jmodel.apply(variables, jx,
                           method=lambda m, v: m.backbone(v))
    jfeats = jmodel.apply(variables, jx, method=jmodel.extract_feat)
    for i, (j, t) in enumerate(zip(jstages, tstages)):
        np.testing.assert_allclose(to_cf(j), _np(t), atol=ATOL,
                                   err_msg=f"stage {i}")
    assert [tuple(f.shape[2:]) for f in tfeats] == \
        tmodel.featmap_sizes(shape)
    for i, (j, t) in enumerate(zip(jfeats, tfeats)):
        np.testing.assert_allclose(to_cf(j), _np(t), atol=ATOL,
                                   err_msg=f"FPN level {i}")
    for s in range(2):
        jrpn = jmodel.apply(variables, jfeats, s, method=jmodel.rpn)
        for lvl, ((jc, jr), (tc, tr)) in enumerate(zip(jrpn, trpn[s])):
            np.testing.assert_allclose(to_cf(jc), _np(tc), atol=ATOL,
                                       err_msg=f"rpn {s} cls {lvl}")
            np.testing.assert_allclose(to_cf(jr), _np(tr), atol=ATOL,
                                       err_msg=f"rpn {s} reg {lvl}")


def test_roi_heads(pair):
    """bbox, refinement, mask and refinement-mask heads on the same RoI
    features (NCDHW for the port, channel-last for JAX)."""
    jmodel, variables, tmodel = pair
    rng = np.random.RandomState(2)
    box_feats = rng.randn(5, 8, 3, 7, 7).astype(np.float32)
    mask_feats = rng.randn(3, 8, 10, 14, 14).astype(np.float32)
    with torch.no_grad():
        tcls, treg = tmodel.bbox_forward(torch.from_numpy(box_feats))
        tref = tmodel.refinement_forward(torch.from_numpy(box_feats))
        tmask = tmodel.mask_forward(torch.from_numpy(mask_feats))
        tmask_r = tmodel.refinement_mask_forward(torch.from_numpy(mask_feats))
    jb = jnp.asarray(to_cl(box_feats))
    jm = jnp.asarray(to_cl(mask_feats))
    jcls, jreg = jmodel.apply(variables, jb, method=jmodel.bbox_forward)
    jref = jmodel.apply(variables, jb, method=jmodel.refinement_forward)
    jmask = jmodel.apply(variables, jm, method=jmodel.mask_forward)
    jmask_r = jmodel.apply(variables, jm,
                           method=jmodel.refinement_mask_forward)
    for name, j, t in (("cls", jcls, tcls), ("reg", jreg, treg),
                       ("refinement", jref, tref), ("mask", jmask, tmask),
                       ("refinement mask", jmask_r, tmask_r)):
        assert np.asarray(j).shape == tuple(t.shape), name
        np.testing.assert_allclose(np.asarray(j), _np(t), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("max_shape", [None, (48, 40, 3, 12)])
def test_delta2bbox3d(max_shape):
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 40, (64, 2)).astype(np.float32)
    z = rng.uniform(0, 10, (64, 1)).astype(np.float32)
    size = rng.uniform(1, 20, (64, 3)).astype(np.float32)
    rois = np.concatenate([xy, xy + size[:, :2], z, z + size[:, 2:]], 1)
    deltas = (rng.randn(64, 12) * 2.0).astype(np.float32)  # some clamp
    means = (0.0,) * 6
    stds = (0.1, 0.1, 0.2, 0.2, 0.1, 0.1)
    want = j_delta2bbox3d(jnp.asarray(rois), jnp.asarray(deltas), means,
                          stds, max_shape)
    got = t_delta2bbox3d(torch.from_numpy(rois), torch.from_numpy(deltas),
                         means, stds, max_shape)
    np.testing.assert_allclose(np.asarray(want), _np(got), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 32, 32), (12, 48, 48), (7, 30, 30)])
def test_build_anchor_set(shape):
    """Anchors and inside flags equal the JAX lattice, every level and
    both scales' anchor configs."""
    jcfg, tcfg = narrow_cfg(JConfig), narrow_cfg(TConfig)
    tmodel = t_build(tcfg, device="cpu")
    d, h, w = shape
    sizes = tmodel.featmap_sizes(shape)
    for jac, tac in zip(j_anchor_cfgs(jcfg), t_anchor_cfgs(tcfg)):
        want = jpl.build_anchor_set(sizes, (h, w, 3, d), jac)
        got = tpl.build_anchor_set(sizes, (h, w, 3, d), tac)
        for lvl in range(len(sizes)):
            np.testing.assert_array_equal(want.anchors[lvl],
                                          _np(got.anchors[lvl]))
            np.testing.assert_array_equal(want.inside[lvl],
                                          _np(got.inside[lvl]))
