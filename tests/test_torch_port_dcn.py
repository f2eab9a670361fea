"""Deformable convolution and deformable RoI pooling (`ops/dcn.py`)
against the JAX package's functions and their numpy oracles
(`mrcnn3d/ops/dcn.py:85, :311`), on the CPU, as
tests/test_extra_components.py holds the JAX ones (:205-244, :444-510).

The port takes PyTorch's NCHW layouts (offsets (B, 2K, Ho, Wo), (dy, dx)
per tap; weights (Cout, C, kh, kw)), the JAX package channel-last ones;
each test carries the same numbers across.  Outputs and gradients
within 1e-5 of JAX's (relative to their largest above 1), 1e-4 of the
oracles'.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mrcnn3d.ops import dcn as jdcn
from mrcnn3d_torch.ops.dcn import (
    DeformConv2dPack,
    DeformRoIPoolingPack,
    deform_conv2d,
    deform_roi_pool,
)

TOL = 1e-5
ORACLE_TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = (a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
                 for a in (got, want))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _chw(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _conv_case(seed, modulated=False, stride=1, dilation=1, h=9, w=10):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, 4).astype(np.float32)
    wt = (rng.randn(3, 3, 4, 6) * 0.1).astype(np.float32)
    ho = (h + 2 - dilation * 2 - 1) // stride + 1
    wo = (w + 2 - dilation * 2 - 1) // stride + 1
    off = (rng.randn(2, ho, wo, 18) * 1.5).astype(np.float32)
    m = (rng.uniform(0, 1, (2, ho, wo, 9)).astype(np.float32)
         if modulated else None)
    return x, off, wt, m


def _port_conv(x, off, wt, m, **kw):
    return deform_conv2d(
        _chw(x), _chw(off),
        torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))),
        mask=None if m is None else _chw(m), **kw)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv_matches_jax_and_oracle(modulated):
    x, off, wt, m = _conv_case(5 + modulated, modulated)
    got = _nhwc(_port_conv(x, off, wt, m))
    jm = None if m is None else jnp.asarray(m)
    want = jdcn.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                              jnp.asarray(wt), mask=jm)
    _close(got, want)
    _close(got, jdcn.deform_conv2d_numpy(x, off, wt, mask=m), ORACLE_TOL)


@pytest.mark.parametrize("stride,dilation", [(2, 1), (1, 2)])
def test_deform_conv_stride_dilation_match_jax(stride, dilation):
    x, off, wt, _ = _conv_case(3, stride=stride, dilation=dilation,
                               h=11, w=12)
    kw = dict(stride=stride, padding=1, dilation=dilation)
    got = _nhwc(_port_conv(x, off, wt, None, **kw))
    want = jdcn.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                              jnp.asarray(wt), **kw)
    _close(got, want)
    _close(got, jdcn.deform_conv2d_numpy(x, off, wt, **kw), ORACLE_TOL)


def test_zero_offset_is_plain_conv():
    x, off, wt, _ = _conv_case(6)
    w_t = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    got = deform_conv2d(_chw(x), torch.zeros(2, 18, 9, 10), w_t)
    _close(got, F.conv2d(_chw(x), w_t, padding=1))


def test_deform_conv_gradients_match_jax():
    """The gradients of sum(y**2) at the input, the offsets, the weight
    and the mask: the bilinear sampler differentiates through both."""
    x, off, wt, m = _conv_case(8, modulated=True)

    def jloss(x_, off_, wt_, m_):
        return jnp.sum(jdcn.deform_conv2d(x_, off_, wt_, mask=m_) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, off, wt, m)))
    tx, toff, tm = (_chw(a).requires_grad_(True) for a in (x, off, m))
    tw = torch.from_numpy(np.ascontiguousarray(
        wt.transpose(3, 2, 0, 1))).requires_grad_(True)
    (deform_conv2d(tx, toff, tw, mask=tm) ** 2).sum().backward()
    _close(_nhwc(tx.grad), jg[0])
    _close(_nhwc(toff.grad), jg[1])
    _close(tw.grad.numpy().transpose(2, 3, 1, 0), jg[2])
    _close(_nhwc(tm.grad), jg[3])


def _pack_params(jv):
    """A JAX DeformConv2dPack's variables as the port pack's state."""
    p = jv["params"]
    return {"conv_offset.weight": torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["conv_offset"]["kernel"]).transpose(3, 2, 0, 1))),
            "conv_offset.bias": torch.from_numpy(
                np.array(p["conv_offset"]["bias"])),
            "weight": torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))}


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv_pack_and_gradients_match_jax(modulated):
    """DeformConv2dPack on a depth-1 volume: zero-initialised offsets
    (a plain conv, v2's mask at 0.5) and, with the offset branch drawn,
    the output and every parameter's gradient against JAX's."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 1, 8, 8, 3).astype(np.float32)
    jm = jdcn.DeformConv2dPack(features=4, modulated=modulated)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = DeformConv2dPack(3, 4, modulated=modulated)
    tm.load_state_dict(_pack_params(jv))
    tx = torch.from_numpy(np.ascontiguousarray(
        np.transpose(x, (0, 4, 1, 2, 3))))
    plain = F.conv2d(tx[:, :, 0], tm.weight, padding=1)[:, :, None]
    _close(tm(tx), plain * (0.5 if modulated else 1.0))
    p = jv["params"]
    p = dict(p, conv_offset=dict(
        kernel=rng.randn(*p["conv_offset"]["kernel"].shape).astype(
            np.float32) * 0.2,
        bias=rng.randn(*p["conv_offset"]["bias"].shape).astype(np.float32)))
    jv = {"params": p}
    tm.load_state_dict(_pack_params(jv))

    def jloss(v):
        return jnp.sum(jm.apply(v, jnp.asarray(x)) ** 2)

    want = jm.apply(jv, jnp.asarray(x))
    jg = jax.grad(jloss)(jv)["params"]
    y = tm(tx)
    _close(y.detach().numpy().transpose(0, 2, 3, 4, 1), want)
    (y ** 2).sum().backward()
    g = {k: v.numpy() for k, v in _pack_params({"params": jg}).items()}
    for name, param in tm.named_parameters():
        _close(param.grad, g[name])
    assert float(tm.conv_offset.weight.grad.abs().sum()) > 0


def _pool_data(seed=0, c=8):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 16, 16, c).astype(np.float32)
    rois = np.array([[0, 2.2, 3.1, 11.7, 12.4],
                     [1, 0.0, 0.0, 15.0, 15.0],
                     [0, 5.0, 5.0, 6.0, 6.0],  # tiny roi
                     [1, -2.0, -2.0, 4.0, 4.0]],  # partly outside
                    np.float32)
    return feats, rois


@pytest.mark.parametrize("case", ["no_trans", "offsets", "groups"])
def test_deform_roi_pool_matches_jax_and_oracle(case):
    feats, rois = _pool_data(seed={"no_trans": 0, "offsets": 1,
                                   "groups": 3}[case])
    kw = dict(spatial_scale=0.5, out_size=5)
    offs = None
    if case == "offsets":
        offs = np.random.RandomState(2).randn(4, 2, 5, 5).astype(np.float32)
        kw["trans_std"] = 0.2
    if case == "groups":  # group size 2: 8 = 2 * 2 * 2 channels
        kw = dict(spatial_scale=1.0, out_size=4, group_size=2)
    got = deform_roi_pool(_chw(feats), torch.from_numpy(rois),
                          None if offs is None else torch.from_numpy(offs),
                          **kw)
    got = got.numpy().transpose(0, 2, 3, 1)
    want = jdcn.deform_roi_pool(jnp.asarray(feats), jnp.asarray(rois),
                                None if offs is None else jnp.asarray(offs),
                                **kw)
    assert got.shape == np.asarray(want).shape
    _close(got, want)
    _close(got, jdcn.deform_roi_pool_numpy(feats, rois, offs, **kw),
           ORACLE_TOL)


def test_deform_roi_pool_gradients_match_jax():
    feats, rois = _pool_data(seed=5)
    offs = np.random.RandomState(6).randn(4, 2, 5, 5).astype(np.float32)
    kw = dict(spatial_scale=0.5, out_size=5, trans_std=0.2)

    def jloss(f, o):
        return jnp.sum(jdcn.deform_roi_pool(f, jnp.asarray(rois), o,
                                            **kw) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feats),
                                          jnp.asarray(offs))
    tf = _chw(feats).requires_grad_(True)
    to = torch.from_numpy(offs).requires_grad_(True)
    (deform_roi_pool(tf, torch.from_numpy(rois), to, **kw) ** 2).sum() \
        .backward()
    _close(_nhwc(tf.grad), jg[0])
    _close(to.grad, jg[1])


def _fc_to_port(kernel, out_size, channels, first):
    """A JAX Dense kernel (in, out) as the port's Linear weight; the
    first fc reads the pooled (N, out, out, C) flattened, the port's
    (N, C, out, out)."""
    k = np.asarray(kernel)
    if first:
        k = k.reshape(out_size, out_size, channels, -1).transpose(
            2, 0, 1, 3).reshape(-1, k.shape[-1])
    return torch.from_numpy(np.ascontiguousarray(k.T))


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_roi_pooling_pack_matches_jax(modulated):
    """DeformRoIPoolingPack: zero-initialised last fcs (plain pooling,
    times sigmoid(0) = 0.5 when modulated), then with every fc drawn,
    the output and the gradients at the features and the first offset
    fc against JAX's."""
    feats, rois = _pool_data(seed=4)
    kw = dict(out_size=5, out_channels=8, spatial_scale=0.5, trans_std=0.1,
              modulated=modulated, deform_fc_channels=16)
    jm = jdcn.DeformRoIPoolingPack(**kw)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                 jnp.asarray(rois))
    tm = DeformRoIPoolingPack(**kw)
    tf, tr = _chw(feats).requires_grad_(True), torch.from_numpy(rois)
    base = deform_roi_pool(tf, tr, None, spatial_scale=0.5, out_size=5)
    _close(tm(tf, tr), base * (0.5 if modulated else 1.0))
    rng = np.random.RandomState(8)
    params = {}
    for name, p in jv["params"].items():
        params[name] = {k: rng.randn(*v.shape).astype(np.float32) * 0.05
                        for k, v in p.items()}
    sd = {}
    for prefix, port in (("offset_fc", "offset_fcs"),
                         ("mask_fc", "mask_fcs")):
        i = 0
        while f"{prefix}_{i}" in params:
            p = params[f"{prefix}_{i}"]
            sd[f"{port}.{i}.weight"] = _fc_to_port(p["kernel"], 5, 8, i == 0)
            sd[f"{port}.{i}.bias"] = torch.from_numpy(p["bias"])
            i += 1
    tm.load_state_dict(sd, strict=True)
    jv = {"params": params}

    def jloss(v, f):
        return jnp.sum(jm.apply(v, f, jnp.asarray(rois)) ** 2)

    want = jm.apply(jv, jnp.asarray(feats), jnp.asarray(rois))
    jg_v, jg_f = jax.grad(jloss, argnums=(0, 1))(jv, jnp.asarray(feats))
    tf.grad = None
    y = tm(tf, tr)
    _close(y.detach().numpy().transpose(0, 2, 3, 1), want)
    (y ** 2).sum().backward()
    _close(_nhwc(tf.grad), jg_f)
    _close(tm.offset_fcs[0].weight.grad,
           _fc_to_port(jg_v["params"]["offset_fc_0"]["kernel"], 5, 8, True))
