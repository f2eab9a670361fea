"""SSD300 against the JAX package, on the CPU.

configs/ssd300_2d.py as shipped (`chip_smoke.two_d_config("SSD")`): the
VGG16 backbone and extra pyramid, no neck, SSDHead with 4/6/6/6/4/4
anchors a level, softmax classes with ranked hard-negative mining.
SSD300 has no narrower form (SSDVGG has no width knob and its extra
pyramid bottoms out below 300, tests/test_variants.py:252-254), so every
case runs at 1x300x300.  The JAX variables (biases and the L2Norm scale
randomised with numpy) go through the port's weight bridge.

  * the six feature maps (38/19/10/5/3/1) within 2e-3;
  * the anchors bit-equal (8732 rows), SSD512's table too;
  * `ssd_loss` on identical head outputs within 2e-3, its gradients
    too, with a case whose negatives tie at the cut far past the quota;
  * one forward_train's losses within 2e-3 and its gradients within
    2e-3 of the JAX gradient's largest.  The port's pass takes the JAX
    pass's branch at each of VGG's five max-pools and 23 relus
    (`chip_smoke.PoolArgmax`, `ReluBranches`, fed from the JAX convs'
    captured outputs), each window or unit where the two differ proven a
    tie (`check_pool_ties`, `check_relu_ties`): a near-tie that float32
    rounding flips routes a gradient to a neighbour, which moved the
    layers under the pools by up to 2e-3 of their largest before;
  * inference: valid and labels equal, dets within 2e-3, through the
    plain K1 on one 8732-row segment; the port's decisions first survive
    a 1e-5 change of the input;
  * the weight bridge: every JAX leaf lands on one port tensor by its
    transform, and back.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (
    SSD_SHAPE,
    PoolArgmax,
    ReluBranches,
    check_pool_ties,
    check_relu_ties,
    compare_outputs,
    small_run,
    two_d_config,
    two_d_train_batch,
)
from mrcnn3d.core.anchors import ssd_anchor_generators as j_ssd_generators
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.core.anchors import ssd_anchor_generators
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs, build_detector
from mrcnn3d_torch.entry import Flagship
from mrcnn3d_torch.models.backbones_extra import SSDVGG
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
MARGIN = 1e-5


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 4, 1))


@functools.lru_cache(maxsize=None)
def jax_side(seed=0):
    """(JAX config, model, variables, anchor sets) of SSD300: biases and
    the L2Norm scale randomised; the anchors with train_cfg's
    allowed_border (-1: every anchor inside), for training and test."""
    cfg = two_d_config("SSD", JConfig)
    model = j_build(cfg)
    assert model.ssd and model.single_stage
    d, h, w = SSD_SHAPE
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, d, h, w, 3)))
    rng = np.random.RandomState(seed)
    variables = _randomise(variables, rng)
    l2 = variables["params"]["backbone"]["l2_norm"]
    l2["weight"] = (20.0 + rng.randn(*l2["weight"].shape) * 2.0).astype(
        np.float32)
    feats = jax.eval_shape(
        lambda x: model.apply(variables, x, method=model.extract_feat),
        jnp.zeros((1, d, h, w, 3)))
    sets = [jpl.build_anchor_set([f.shape[1:4] for f in feats], (h, w, 3, d),
                                 j_anchor_cfgs(cfg)[0], allowed_border=-1)]
    return cfg, model, variables, sets


def port_model(train=False):
    cfg = two_d_config("SSD", TConfig)
    model = build_detector(cfg, device="cpu", train=train)
    model.load_state_dict(state_dict_from_jax(jax_side()[2]), strict=True)
    return cfg, model


def port_sets(cfg, model):
    return tpl.anchor_sets_for(model, anchor_cfgs(cfg), [SSD_SHAPE],
                               allowed_border=-1)


def test_ssd_builds_as_jax():
    """SSD's flags and modules: no neck, the VGG's (1, 3, 3) convs and
    ceil-mode pools as nn.MaxPool3d modules, fc6 dilated 6, the head's
    anchors 4/6/6/6/4/4 a level, L2Norm at 20 in a fresh build."""
    cfg = two_d_config("SSD", TConfig)
    model = build_detector(cfg, device="cpu")
    assert model.ssd and model.single_stage and not hasattr(model, "neck")
    vgg = model.backbone
    assert vgg.features[31].dilation == (1, 6, 6)
    pools = [m for m in vgg.modules() if isinstance(m, torch.nn.MaxPool3d)]
    assert len(pools) == 5 and all(p.ceil_mode for p in pools[:4])
    assert [c.out_channels // 2 for c in model.bbox_head.cls_convs] == \
        [4, 6, 6, 6, 4, 4]
    assert bool((vgg.l2_norm.weight == 20).all())
    assert model.featmap_sizes(SSD_SHAPE) == [
        (1, n, n) for n in (38, 19, 10, 5, 3, 1)]


def test_ssd_features_match_jax():
    jcfg, jmodel, variables, _ = jax_side()
    _, model = port_model()
    x = np.random.RandomState(3).randn(1, 3, *SSD_SHAPE).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jmodel.extract_feat))(variables, jnp.asarray(_nhwc(x)))
    with torch.no_grad():
        got = model.extract_feat(torch.from_numpy(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.transpose(np.asarray(w), (0, 4, 1, 2, 3))
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def _grids(gens, sizes, strides):
    return [g.grid_anchors(s, st, 1) for g, s, st in zip(gens, sizes, strides)]


def test_ssd_anchors_bit_equal():
    """SSD300's anchor set through build_anchor_set (8732 rows, 4/6/6/6/4/4
    a level), and SSD512's generators at SSDVGG(512)'s level sizes."""
    jcfg, _, _, jsets = jax_side()
    cfg = two_d_config("SSD", TConfig)
    model = build_detector(cfg, device="cpu")
    got = port_sets(cfg, model)[0]
    sizes = model.featmap_sizes(SSD_SHAPE)
    per_level = [a.shape[0] // int(np.prod(s))
                 for a, s in zip(got.anchors, sizes)]
    assert per_level == [4, 6, 6, 6, 4, 4]
    assert sum(a.shape[0] for a in got.anchors) == 8732
    for g, w, gi, wi in zip(got.anchors, jsets[0].anchors, got.inside,
                            jsets[0].inside):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(gi.numpy(), wi)
    ac512 = dict(input_size=512, basesize_ratio_range=(0.15, 0.9),
                 anchor_strides=[8, 16, 32, 64, 128, 256, 512],
                 anchor_ratios=([2], [2, 3], [2, 3], [2, 3], [2, 3], [2],
                                [2]))
    sizes = SSDVGG(512).featmap_sizes((1, 512, 512))
    ours = _grids(ssd_anchor_generators(ac512), sizes,
                  ac512["anchor_strides"])
    theirs = _grids(j_ssd_generators(ac512), sizes, ac512["anchor_strides"])
    assert sum(a.shape[0] for a in ours) == 24564
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def _head_outputs(rng, sizes, anchors, zeros=False):
    """numpy per-level (cls (1, A*2, d, h, w), reg (1, A*6, d, h, w))."""
    outs = []
    for (d, h, w), a in zip(sizes, anchors):
        cls = rng.randn(1, a * 2, d, h, w).astype(np.float32)
        reg = rng.randn(1, a * 6, d, h, w).astype(np.float32) * 0.5
        outs.append((cls * 0 if zeros else cls, reg))
    return outs


def _gt(rng, n=4, g=6):
    xy = rng.uniform(10, 180, (1, g, 2))
    size = rng.uniform(30, 110, (1, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + size, 299),
                            np.zeros((1, g, 2))], -1).astype(np.float32)
    valid = np.zeros((1, g), bool)
    valid[:, :n] = True
    return boxes, valid, np.ones((1, g), np.int32)


@pytest.mark.parametrize("tied", [False, True])
def test_ssd_loss_matches_jax(tied):
    """ssd_loss on the same head outputs and gt, and its gradient by the
    outputs.  tied: all class logits 0, so every negative's loss is
    log 2 and thousands tie at the cut of 3 x positives; the stable sort
    picks the same anchors in both packages."""
    jcfg, _, _, jsets = jax_side()
    cfg = two_d_config("SSD", TConfig)
    model = build_detector(cfg, device="cpu")
    sets = port_sets(cfg, model)
    sizes = model.featmap_sizes(SSD_SHAPE)
    rng = np.random.RandomState(11)
    outs = _head_outputs(rng, sizes, (4, 6, 6, 6, 4, 4), zeros=tied)
    gtb, gtv, gtl = _gt(rng)
    means, stds = tpl.rpn_codec(cfg)
    ss = cfg.train_cfg["rpn"]

    def jloss(o):
        return jpl.ssd_loss(
            [jnp.transpose(c, (0, 2, 3, 4, 1)) for c, _ in o],
            [jnp.transpose(r, (0, 2, 3, 4, 1)) for _, r in o], jsets[0],
            jnp.asarray(gtb), jnp.asarray(gtv), jnp.asarray(gtl), ss, 2,
            means=means, stds=stds)

    jouts = [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs]
    jl = jloss(jouts)
    want_grad = jax.grad(lambda o: sum(jloss(o).values()))(jouts)
    touts = [(torch.from_numpy(c).requires_grad_(True),
              torch.from_numpy(r).requires_grad_(True)) for c, r in outs]
    got = tpl.ssd_loss([c for c, _ in touts], [r for _, r in touts], sets[0],
                       torch.from_numpy(gtb), torch.from_numpy(gtv),
                       torch.from_numpy(gtl), ss, 2, means, stds)
    assert set(got) == set(jl) == {"loss_cls", "loss_reg"}
    for k in got:
        assert abs(float(got[k].detach()) - float(jl[k])) <= ATOL, k
    sum(got.values()).backward()
    scale = max(float(np.abs(np.asarray(g)).max())
                for pair in want_grad for g in pair)
    for (c, r), (wc, wr) in zip(touts, want_grad):
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(wc), rtol=0,
                                   atol=ATOL * scale)
        np.testing.assert_allclose(r.grad.numpy(), np.asarray(wr), rtol=0,
                                   atol=ATOL * scale)
    assert any(np.abs(np.asarray(wr)).max() > 0 for _, wr in want_grad), \
        "no positives: vacuous case"
    if tied:
        # the anchors the class loss reaches (positives and the kept
        # negatives): a cut inside thousands of equal losses
        reached = sum(int((np.abs(np.asarray(wc)).reshape(
            wc.shape[0], -1, 2, *wc.shape[2:]).sum(2) > 0).sum())
            for wc, _ in want_grad)
        assert 0 < reached < 8732 // 2, reached


def jax_branches(jmodel, variables, imgs):
    """The JAX pass's max-pool argmax per window (torch's rule on the JAX
    pool inputs, NCDHW) and relu branch per unit, in the port's call
    order, from the outputs of the VGG's convs."""
    import torch.nn.functional as F

    _, state = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jmodel.extract_feat, capture_intermediates=True,
        mutable=["intermediates"]))(variables, imgs)
    caught = state["intermediates"]["backbone"]
    names = ([f"features_{li}" for li in
              (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)]
             + ["fc6", "fc7"] + [f"extra_{ei}" for ei in range(8)])
    outs = {n: torch.from_numpy(np.transpose(
        np.array(caught[n]["__call__"][0]), (0, 4, 1, 2, 3)))
        for n in names}
    relus = [outs[n] > 0 for n in names]
    vgg = SSDVGG(300)
    pools = [m for m in vgg.modules() if isinstance(m, torch.nn.MaxPool3d)]
    argmax = [F.max_pool3d(torch.relu(outs[f"features_{li}"]), p.kernel_size,
                           p.stride, p.padding, ceil_mode=p.ceil_mode,
                           return_indices=True)[1]
              for li, p in zip((2, 7, 14, 21, 28), pools)]
    return argmax, relus


@functools.lru_cache(maxsize=None)
def train_pair(seed=3):
    """One forward_train and backward of each package on one image, the
    port's max-pools and relus taking the JAX pass's branches."""
    jcfg, jmodel, variables, sets = jax_side()
    batch = two_d_train_batch(seed, "SSD", batch_size=1)
    jb = {k: jnp.asarray(_nhwc(v) if k == "imgs" else v)
          for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)
    argmax, relus = jax_branches(jmodel, variables, jb["imgs"])

    def loss_fn(params):
        return jpl.forward_train(jmodel, {"params": params}, jb, rng, jcfg,
                                 sets)

    (_, jlosses), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                         jgrads)})
    cfg, model = port_model(train=True)
    with PoolArgmax(model, argmax) as pools, ReluBranches(relus) as branches:
        total, losses = tpl.forward_train(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
            port_sets(cfg, model), None)
        total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return ({k: float(v) for k, v in jlosses.items()}, jgrads,
            {k: float(v.detach()) for k, v in losses.items()}, grads, pools,
            branches)


def test_ssd_forward_train_matches_jax():
    jlosses, jgrads, losses, grads, pools, branches = train_pair()
    assert len(pools.indices) == 5 and len(branches.branches) == 23
    check_pool_ties(pools.flips, "SSD train, port vs JAX")
    check_relu_ties(branches.ties, "SSD train, port vs JAX")
    assert set(losses) == set(jlosses) == {"loss_cls", "loss_reg"}
    for k, v in jlosses.items():
        assert abs(losses[k] - v) <= ATOL, (k, losses[k], v)
    assert set(grads) == set(jgrads)
    reached = 0
    for name, want in jgrads.items():
        want = want.numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(grads[name].contiguous().numpy(), want,
                                   rtol=0, atol=ATOL * scale, err_msg=name)
        reached += scale > 0
    # the random VGG's deepest levels are dead (relu of biases alone), so
    # their convs and head convs take no gradient in either package
    assert reached >= len(jgrads) // 2, reached


def test_ssd_simple_test_matches_jax():
    """One 8732-row segment an image through the plain K1 (score
    threshold 0.02, 16 detections)."""
    jcfg, jmodel, variables, sets = jax_side()
    tcfg, tmodel = port_model()
    det = Flagship(tcfg, tmodel, torch.device("cpu"))
    batch = {"imgs": np.random.RandomState(7).randn(1, 3, *SSD_SHAPE)
             .astype(np.float32)}
    got = small_run(det, batch)
    compare_outputs(got, small_run(det, batch, scale=1.0 + MARGIN), ATOL,
                    "seed too close to a decision boundary")
    want = jax.jit(lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets))(
        variables, {"imgs": jnp.asarray(_nhwc(batch["imgs"]))})
    want = {k: np.asarray(v) for k, v in want.items()}
    want["labels"] = want["labels"].astype(got["labels"].dtype)
    assert got["dets"].shape == (1, 16, 7)
    assert int(got["valid"].sum()) == 16, "vacuous case"
    compare_outputs(got, want, ATOL, "port vs JAX")
    assert np.abs(got["dets"][0][:, 4:6]).max() == 0.0  # z = [0, 0]


def test_ssd_weight_bridge_round_trip():
    """Every JAX leaf (distinct values) reaches exactly one port tensor,
    and the inverse transform of that tensor gives the leaf back."""
    _, _, variables, _ = jax_side()
    rng = np.random.RandomState(1)
    distinct = jax.tree.map(
        lambda x: rng.randn(*np.shape(x)).astype(np.float32), variables)
    sd = state_dict_from_jax(distinct)
    model = build_detector(two_d_config("SSD", TConfig), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = {}
    for name, t in sd.items():
        t = t.numpy()
        back[name] = np.transpose(t, (2, 3, 4, 1, 0)) if t.ndim == 5 else t
    want = {}
    p = distinct["params"]
    fc = {"fc6": "features.31", "fc7": "features.33"}
    for k, v in p["backbone"].items():
        if k == "l2_norm":
            want["backbone.l2_norm.weight"] = v["weight"]
            continue
        dst = fc.get(k, k.replace("_", "."))
        want[f"backbone.{dst}.weight"] = v["kernel"]
        want[f"backbone.{dst}.bias"] = v["bias"]
    for k, v in p["ssd_head"].items():
        kind, i = k.rsplit("_", 1)
        dst = f"bbox_head.{kind.replace('_conv', '_convs')}.{i}"
        want[f"{dst}.weight"] = v["kernel"]
        want[f"{dst}.bias"] = v["bias"]
    assert set(want) == set(back)
    for name, leaf in want.items():
        np.testing.assert_array_equal(back[name], np.asarray(leaf),
                                      err_msg=name)
