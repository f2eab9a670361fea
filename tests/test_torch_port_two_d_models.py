"""The 2-D legacy family's modules against the JAX package, on the CPU:
the `two_d` mode of ResNet3D, ResNeXt3D and the mask, HTC mask, semantic
and RetinaNet heads (`mrcnn3d/models/resnet3d.py:155-240, :346-400`,
`backbones_extra.py:73-82, :131-170`, `heads.py:114-133, :161-189,
:216-222, :307-313`), and the weight bridge on a 2-D tree.

  * each module at narrow widths on depth-1 inputs, the JAX variables
    (biases and frozen-BN statistics randomised with numpy) through the
    port's weight bridge: every output within 2e-3;
  * every (1, k, k) conv of the 2-D backbone equals torch.nn.Conv2d on
    the squeezed input (as the JAX package's
    `test_two_d_backbone_is_exact_2d_conv`), and the 2-D stem and pool
    keep depth 1;
  * `state_dict_from_jax` of a 2-D MaskRCNN tree loads strictly, with
    the first fc's order from the config's (1, 7, 7) align, and the
    JAX package's own torch converter takes it back to the same tree.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from chip_smoke import two_d_config, two_d_narrow
from mrcnn3d.compat.torch_convert import convert_state_dict
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.models import heads as jheads
from mrcnn3d.models.backbones_extra import ResNeXt3D as JResNeXt3D
from mrcnn3d.models.resnet3d import ResNet3D as JResNet3D
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import roi_shape, state_dict_from_jax
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.models import heads
from mrcnn3d_torch.models.backbones_extra import ResNeXt3D
from mrcnn3d_torch.models.resnet3d import ResNet3D
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
HW = (32, 32)


def _cl(x):
    """NCDHW numpy -> NDHWC jax."""
    return jnp.asarray(np.transpose(x, (0, 2, 3, 4, 1)))


def _ncdhw(y):
    return np.transpose(np.asarray(y), (0, 4, 1, 2, 3))


def _load(module, tree, prefix):
    """The bridged state_dict entries under `prefix` into `module`
    (strict): tree is a detector-shaped {"params", "batch_stats"}."""
    sd = state_dict_from_jax(tree)
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sub, strict=True)
    return module


def _tree(params=None, stats=None, **heads_):
    """A detector-shaped tree around a backbone's or heads' variables."""
    p = {"backbone": params or {}, "neck": {}, **heads_}
    return {"params": p, "batch_stats": {"backbone": stats or {}}}


@functools.lru_cache(maxsize=None)
def _backbone_pair(kind, depth):
    rng = np.random.RandomState(depth)
    x = rng.randn(2, 3, 1, *HW).astype(np.float32)
    if kind == "resnet":
        jm = JResNet3D(depth=depth, base_width=8, two_d=True)
        tm = ResNet3D(depth=depth, base_width=8, two_d=True)
    else:
        jm = JResNeXt3D(depth=depth, groups=4, width=8, two_d=True)
        tm = ResNeXt3D(depth=depth, groups=4, width=8, two_d=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), _cl(x))
    v = _randomise(v, rng)
    want = [_ncdhw(y) for y in jax.jit(jm.apply)(v, _cl(x))]
    _load(tm, _tree(v["params"], v["batch_stats"]), "backbone.")
    return x, want, tm.eval()


@pytest.mark.parametrize("kind,depth", [("resnet", 18), ("resnet", 50),
                                        ("resnext", 50)])
def test_two_d_backbone_matches_jax(kind, depth):
    x, want, tm = _backbone_pair(kind, depth)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert all(g.shape[2] == 1 for g in got)  # depth 1 at every stage
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    sizes = tm.featmap_sizes((1, *HW))
    assert sizes == [tuple(g.shape[2:]) for g in got]


@pytest.mark.parametrize("kind,depth", [("resnet", 18), ("resnext", 50)])
def test_two_d_convs_are_exact_2d_convs(kind, depth):
    """Every conv of the 2-D backbone is a (1, k, k) Conv3d whose output
    equals torch.nn.Conv2d (stride, padding, groups, weights carried
    over) on the squeezed depth-1 input; the stem max-pool equals
    max_pool2d."""
    x, _, tm = _backbone_pair(kind, depth)
    seen = []

    def hook(mod, inp, out):
        conv = torch.nn.Conv2d(
            mod.in_channels, mod.out_channels, mod.kernel_size[1:],
            stride=mod.stride[1:], padding=mod.padding[1:],
            groups=mod.groups, bias=mod.bias is not None)
        with torch.no_grad():
            conv.weight.copy_(mod.weight[:, :, 0])
            want = conv(inp[0][:, :, 0])
        assert mod.kernel_size[0] == 1 and mod.stride[0] == 1 \
            and mod.padding[0] == 0
        np.testing.assert_allclose(out[:, :, 0].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5)
        seen.append(mod.kernel_size)

    def pool_hook(mod, inp, out):
        want = F.max_pool2d(inp[0][:, :, 0], 3, 2, 1)
        assert torch.equal(out[:, :, 0], want)
        seen.append("pool")

    hooks = [m.register_forward_hook(hook) for m in tm.modules()
             if isinstance(m, torch.nn.Conv3d)]
    hooks.append(tm.maxpool.register_forward_hook(pool_hook))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert (1, 7, 7) in seen and (1, 3, 3) in seen and "pool" in seen


def _head_case(name, rng):
    """(JAX module, its inputs as numpy NCDHW, port module, prefix,
    tree key) of a two_d head at narrow widths."""
    c = 8
    x = rng.randn(3, c, 1, 7, 7).astype(np.float32)
    if name == "mask":
        return (jheads.FCNMaskHead3D(num_convs=2, conv_out_channels=c,
                                     num_classes=3, two_d=True),
                (x,), heads.FCNMaskHead3D(c, 3, 2, two_d=True),
                "mask_head.", "mask_head_0")
    if name == "htc_mask":
        res = rng.randn(*x.shape).astype(np.float32)
        return (jheads.HTCMaskHead3D(num_convs=2, conv_out_channels=c,
                                     num_classes=3, two_d=True),
                (x, res), heads.HTCMaskHead3D(c, 3, 2, two_d=True),
                "mask_head.", "mask_head_0")
    if name == "retina":
        f = rng.randn(2, c, 1, 9, 11).astype(np.float32)
        return (jheads.RetinaHead3D(feat_channels=c, stacked_convs=2,
                                    num_anchors=3, cls_out_channels=2,
                                    two_d=True),
                (f,), heads.RetinaHead3D(c, 2, 3, 2, two_d=True),
                "bbox_head.", "rpn_head_0")
    feats = tuple(rng.randn(1, c, 1, 16 // 2**i, 16 // 2**i)
                  .astype(np.float32) for i in range(3))
    return (jheads.FusedSemanticHead3D(num_ins=3, fusion_level=1,
                                       num_convs=2, conv_out_channels=c,
                                       num_classes=3, two_d=True),
            (feats,), heads.FusedSemanticHead3D(c, 3, 1, 2, 3, two_d=True),
            "semantic_head.", "semantic_head")


@pytest.mark.parametrize("name", ["mask", "htc_mask", "semantic", "retina"])
def test_two_d_head_matches_jax(name):
    """Each head with a 2-D mode: (1, 3, 3) convs (and a (1, 2, 2)
    deconv for the mask heads) on depth-1 inputs, against JAX."""
    rng = np.random.RandomState(4)
    jm, inputs, tm, prefix, key = _head_case(name, rng)
    if name == "semantic":
        jin = (tuple(_cl(f) for f in inputs[0]),)
        tin = ([torch.from_numpy(f) for f in inputs[0]],)
    else:
        jin = tuple(_cl(a) for a in inputs)
        tin = tuple(torch.from_numpy(a) for a in inputs)
    v = _randomise(jm.init(jax.random.PRNGKey(1), *jin), rng)
    want = jm.apply(v, *jin)
    _load(tm, _tree(**{key: v["params"]}), prefix)
    with torch.no_grad():
        got = tm(*tin)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.ndim == 5 and w.shape[-1] == g.shape[1] and name != "mask":
            w = _ncdhw(w)  # channel-last outputs (all but the logits)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    if name in ("mask", "htc_mask"):
        assert tm.upsample.kernel_size == (1, 2, 2)
        assert got[0].shape[2:] == (1, 14, 14)
    for m in tm.modules():
        if isinstance(m, torch.nn.Conv3d) and m.kernel_size != (1, 1, 1):
            assert m.kernel_size == (1, 3, 3)


@functools.lru_cache(maxsize=None)
def _mask_rcnn_tree():
    cfg = two_d_narrow(two_d_config("MaskRCNN", JConfig))
    model = j_build(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, *HW, 3)))
    return _randomise(v, np.random.RandomState(9))


def test_weight_bridge_round_trip_on_a_two_d_tree():
    """The 2-D MaskRCNN's tree loads strictly into the port's build with
    the first fc ordered by the config's (1, 7, 7) align (the 3-D default
    (3, 7, 7) cannot order it); the JAX package's torch converter takes
    the bridged state_dict back to the same leaves."""
    v = _mask_rcnn_tree()
    tcfg = two_d_narrow(two_d_config("MaskRCNN", TConfig))
    assert roi_shape(tcfg) == (1, 7, 7)
    sd = state_dict_from_jax(v, roi_shape(tcfg))
    model = build_detector(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert model.mask_head.upsample.weight.shape[2:] == (1, 2, 2)
    assert model.rpn_head.rpn_conv.weight.shape[2:] == (3, 3, 3)
    with pytest.raises(ValueError):
        state_dict_from_jax(v)
    params, stats = convert_state_dict(
        {k: t.numpy() for k, t in sd.items()}, num_scales=1,
        roi_shape=(1, 7, 7), channels=32)
    leaves = 0
    for tree, got in ((v["params"], params), (v["batch_stats"], stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        for path, leaf in flat_got:
            want = tree
            for p in path:
                want = want[p.key]
            np.testing.assert_array_equal(leaf, np.asarray(want))
            leaves += 1
    n = len(jax.tree_util.tree_leaves(v["params"]))
    assert leaves >= n  # every parameter (and the BN statistics)
