"""HybridTaskCascade3D against the JAX package, on the CPU: the resize with
`jax.image.resize` semantics, the HTC mask head, the fused semantic head,
the semantic RoI features (one K2 launch on the semantic map and the
overlapping adaptive bins), and the whole detector from configs/htc_3d.py
(inference with the mask ensemble, losses with the semantic CE and the
interleaved mask stages, gradients, draws) at the narrow recipe of
`test_torch_port_families_cascade.py`, whose harness and tolerances these
tests share; the JAX tests' HTC recipe (tests/test_variants.py:190-233,
a 3-class semantic head) once, inference and losses."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.models.heads import FusedSemanticHead3D as JSemantic
from mrcnn3d.models.heads import HTCMaskHead3D as JMaskHead
from mrcnn3d_torch.compat.jax_weights import _conv, _deconv
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.models.heads import FusedSemanticHead3D, HTCMaskHead3D
from mrcnn3d_torch.ops.resize3d import jax_resize
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_families_cascade import (
    check_draw_margin,
    check_gradients,
    check_inference,
    check_losses,
    family,
    family_cfg,
    train_pair,
)
from test_torch_port_models import _randomise
from torch_port_fixtures import torch_threads  # noqa: F401

HTC = "HybridTaskCascade3D"
HEAD_TOL = 1e-5


def _ncdhw(x):
    return np.transpose(np.asarray(x), (0, 4, 1, 2, 3))


def _set_conv(mod, p):
    mod.weight.data = torch.from_numpy(np.ascontiguousarray(
        _conv(p["kernel"])))
    mod.bias.data = torch.from_numpy(np.asarray(p["bias"]))


# ---------------------------------------------------------------------------
# the resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["trilinear", "nearest"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("sizes", [(16, 4), (4, 16), (6, 4), (3, 7)],
                         ids=["down4", "up4", "down1.5", "up2.33"])
def test_resize_matches_jax_image_resize(method, axis, sizes):
    """Down- and upsampling along each axis alone; trilinear antialiases
    when it downsamples, nearest picks floor((i + 0.5) * in / out)."""
    rng = np.random.RandomState(axis)
    shape = [5, 6, 7]
    shape[axis] = sizes[0]
    out = list(shape)
    out[axis] = sizes[1]
    x = rng.randn(2, 3, *shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, *out), method)
    got = jax_resize(torch.from_numpy(x), out, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_resize_cases_from_the_port_notes():
    """[0,0,0,8,0,0,0,0] to 4 is [0,3,1,0] (torch's linear gives
    [0,4,0,0]); nearest 16 to 4 takes [2,6,10,14] (torch's 'nearest'
    [0,4,8,12]); integer labels resize nearest unchanged in type."""
    x = torch.tensor([0, 0, 0, 8, 0, 0, 0, 0.0]).reshape(1, 1, 1, 1, 8)
    assert jax_resize(x, (1, 1, 4), "trilinear").flatten().tolist() == \
        [0, 3, 1, 0]
    idx = torch.arange(16).reshape(1, 1, 16)
    got = jax_resize(idx, (1, 1, 4), "nearest")
    assert got.flatten().tolist() == [2, 6, 10, 14]
    assert got.dtype == torch.int64
    seg = np.random.RandomState(0).randint(0, 3, (2, 8, 32, 32))
    want = jax.image.resize(jnp.asarray(seg, jnp.int32), (2, 2, 4, 4),
                            "nearest")
    np.testing.assert_array_equal(
        jax_resize(torch.from_numpy(seg), (2, 4, 4), "nearest").numpy(),
        np.asarray(want))


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------


def _port_mask_head(p, channels, with_res):
    head = HTCMaskHead3D(channels, 2, 4, with_conv_res=with_res)
    for i in range(4):
        _set_conv(head.convs[i].conv, p[f"conv_{i}"])
    head.upsample.weight.data = torch.from_numpy(np.ascontiguousarray(
        _deconv(p["upsample"]["kernel"])))
    head.upsample.bias.data = torch.from_numpy(
        np.asarray(p["upsample"]["bias"]))
    _set_conv(head.conv_logits, p["conv_logits"])
    if with_res:
        _set_conv(head.conv_res.conv, p["conv_res"])
    return head


def test_htc_mask_head_matches_jax():
    """Stage 0 without information flow (no conv_res), stage 1 adding
    conv_res of stage 0's features; the features-only pass."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 6, 6, 8).astype(np.float32)
    jhead = JMaskHead(conv_out_channels=8, num_classes=2)
    v0 = _randomise(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    v1 = _randomise(jhead.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(x)), rng)
    assert "conv_res" not in v0["params"] and "conv_res" in v1["params"]
    jl0, jf0 = jhead.apply(v0, jnp.asarray(x))
    jl1, jf1 = jhead.apply(v1, jnp.asarray(x), jf0)
    none, jf1_only = jhead.apply(v1, jnp.asarray(x), jf0,
                                 return_logits=False)
    assert none is None
    h0 = _port_mask_head(v0["params"], 8, False)
    h1 = _port_mask_head(v1["params"], 8, True)
    assert h0.conv_res is None
    tx = torch.from_numpy(_ncdhw(x))
    l0, f0 = h0(tx)
    l1, f1 = h1(tx, f0)
    n1, f1_only = h1(tx, f0, return_logits=False)
    assert n1 is None
    for got, want in ((l0, jl0), (l1, jl1)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=HEAD_TOL)
    for got, want in ((f0, jf0), (f1, jf1), (f1_only, jf1_only)):
        np.testing.assert_allclose(got.detach().numpy(), _ncdhw(want),
                                   rtol=0, atol=HEAD_TOL)


def test_fused_semantic_head_matches_jax():
    """Five levels of a 16x64x64 input summed at level 1 (level 0
    antialiased down, levels 2-4 up), 4 convs, logits and embedding."""
    model = build_detector(family_cfg(TConfig, HTC), device="cpu")
    sizes = model.featmap_sizes((16, 64, 64))
    rng = np.random.RandomState(4)
    feats = [rng.randn(1, *s, 8).astype(np.float32) for s in sizes]
    jhead = JSemantic(conv_out_channels=8, num_classes=3)
    jf = [jnp.asarray(f) for f in feats]
    v = _randomise(jhead.init(jax.random.PRNGKey(0), jf), rng)
    jlogits, jemb = jhead.apply(v, jf)
    head = FusedSemanticHead3D(8, num_classes=3)
    p = v["params"]
    for i in range(5):
        _set_conv(head.lateral_convs[i].conv, p[f"lateral_{i}"])
    for i in range(4):
        _set_conv(head.convs[i].conv, p[f"conv_{i}"])
    _set_conv(head.conv_logits, p["conv_logits"])
    _set_conv(head.conv_embedding.conv, p["conv_embedding"])
    logits, emb = head([torch.from_numpy(_ncdhw(f)) for f in feats])
    assert tuple(emb.shape[2:]) == tuple(sizes[1])
    for got, want in ((logits, jlogits), (emb, jemb)):
        np.testing.assert_allclose(got.detach().numpy(), _ncdhw(want),
                                   rtol=0, atol=HEAD_TOL)


def test_htc_builds_as_jax():
    """One HTC mask head per stage (`mask_head.{t}`, conv_res from stage
    1), the semantic head with 4 convs whatever semantic_head.num_convs
    says (the JAX build_detector does not read it), its classes from the
    config."""
    cfg = family_cfg(TConfig, HTC)
    cfg.model["semantic_head"]["num_convs"] = 2
    model = build_detector(cfg, device="cpu")
    jmodel = family(HTC)[1]
    assert model.htc and model.with_semantic and model.cascade_stages == 3
    assert jmodel.htc and jmodel.with_semantic
    names = set(model.state_dict())
    assert "mask_head.0.conv_res.conv.weight" not in names
    assert {"mask_head.1.conv_res.conv.weight",
            "mask_head.2.conv_res.conv.weight",
            "semantic_head.conv_embedding.conv.weight",
            "semantic_head.conv_logits.weight"} <= names
    assert len(model.semantic_head.convs) == 4
    assert len(model.semantic_head.lateral_convs) == 5


# ---------------------------------------------------------------------------
# the semantic RoI features
# ---------------------------------------------------------------------------


def _sem_rois(rng, n, shape):
    d, h, w = shape
    xy = rng.uniform(0, w * 0.7, (n, 2))
    size = rng.uniform(4, w * 0.5, (n, 2))
    z = rng.uniform(0, d * 0.6, (n, 1))
    dz = rng.uniform(2, d * 0.4, (n, 1))
    boxes = np.concatenate([xy, xy + size, z, z + dz], 1)
    batch = rng.randint(0, 2, (n, 1))
    return np.concatenate([batch, boxes], 1).astype(np.float32)


@pytest.mark.parametrize("out,out_d", [(7, 3), (14, 10)],
                         ids=["pooled_10to3", "extractor_grid"])
def test_semantic_roi_feats_match_jax(out, out_d):
    """One align on the stride-8 semantic map alone (every roi on its one
    level), then JAX's adaptive mean: 14x14x10 to 7x7x3 takes the
    overlapping depth bins [0,4), [3,7), [6,10)."""
    cfg = family_cfg(TConfig, HTC)
    rng = np.random.RandomState(5)
    sem = rng.randn(2, 4, 8, 8, 8).astype(np.float32)  # 16x64x64 input
    rois = _sem_rois(rng, 40, (16, 64, 64))
    valid = rng.rand(40) > 0.2
    want = jpl._semantic_roi_feats(jnp.asarray(sem), jnp.asarray(rois),
                                   jnp.asarray(valid), cfg, out, out_d)
    got = tpl._semantic_roi_feats(torch.from_numpy(_ncdhw(sem)),
                                  torch.from_numpy(rois),
                                  torch.from_numpy(valid), cfg, out, out_d)
    assert tuple(got.shape) == (40, 8, out_d, out, out)
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=0, atol=1e-5)


def test_adaptive_bins_are_jaxs():
    """F.adaptive_avg_pool3d's bins are JAX's pool matrix rows
    [floor(o*I/O), ceil((o+1)*I/O)): 10 to 3 and 14 to 7."""
    x = torch.randn(2, 3, 10, 14, 14, dtype=torch.float64)
    got = torch.nn.functional.adaptive_avg_pool3d(x, (3, 7, 7))

    def pool(o_sz, i_sz):
        m = np.zeros((o_sz, i_sz))
        for o in range(o_sz):
            s0, s1 = (o * i_sz) // o_sz, -((-(o + 1) * i_sz) // o_sz)
            m[o, s0:s1] = 1.0 / (s1 - s0)
        return torch.from_numpy(m)

    want = torch.einsum("ncdhw,zd,yh,xw->nczyx", x, pool(3, 10),
                        pool(7, 14), pool(7, 14))
    torch.testing.assert_close(got, want)
    assert pool(3, 10)[1].nonzero().flatten().tolist() == [3, 4, 5, 6]


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def test_htc_simple_test_matches_jax():
    got = check_inference(HTC)
    assert got["mask_logits"].shape[1:] == (2, 20, 28, 28)


def test_htc_forward_train_losses_match_jax():
    keys = {k for k in check_losses(HTC) if "loss" in k}
    assert keys == {"loss_rpn_cls", "loss_rpn_reg", "loss_semantic_seg",
                    *(f"s{t}.loss_{x}" for t in range(3)
                      for x in ("cls", "reg", "mask"))}


def test_htc_gradients_match_jax():
    grads = check_gradients(HTC)
    # the semantic branch learns through the CE and the fused aligns, and
    # stage 2's loss reaches heads 0 and 1 through the information flow
    for name in ("semantic_head.conv_logits.weight",
                 "semantic_head.conv_embedding.conv.weight",
                 "mask_head.1.conv_res.conv.weight",
                 "mask_head.2.conv_res.conv.weight"):
        assert grads[name].abs().max() > 0, name


def test_htc_draws_have_margin():
    check_draw_margin(HTC)


def test_htc_resamples_on_jax_keys():
    """The interleaved mask stages re-sample with keys 2 + stages + t."""
    sites = {site[:2] for site, _, _ in train_pair(HTC)["port"][2]}
    assert sites == {("rpn", 0), *(("cascade", t) for t in range(3)),
                     *(("htc_mask", t) for t in range(3))}


def test_jax_test_recipe_matches_jax():
    """The JAX tests' HTC recipe (flagship config, stage IoUs 0.4/0.5/0.6,
    a 3-class semantic head): inference and every loss."""
    got = check_inference(HTC, "jax_test")
    assert "mask_logits" in got
    losses = check_losses(HTC, "jax_test")
    assert {"loss_semantic_seg", "s2.loss_mask"} <= set(losses)


def test_htc_honours_return_bbox_only():
    """With test_cfg.return_bbox_only the HTC skips its mask ensemble
    and returns the same boxes."""
    from chip_smoke import variant_inputs
    from mrcnn3d_torch.entry import build

    cfg = family_cfg(TConfig, HTC)
    imgs = torch.from_numpy(variant_inputs(7, 1)["imgs"])
    full = build(cfg, device="cpu").run(imgs)
    cfg.test_cfg["return_bbox_only"] = True
    boxes = build(cfg, device="cpu").run(imgs)
    assert full[3] is not None and boxes[3] is None
    for a, b in zip(full[:3], boxes[:3]):
        assert torch.equal(a, b)
