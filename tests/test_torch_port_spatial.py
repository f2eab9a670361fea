"""Depth sharding of the port's backbone on the CPU (`parallel/spatial.py`),
gloo processes spawned per test.

  * world 2 against the JAX package's `spatial_extract_feat` on a
    2-device mesh of the conftest's virtual CPU devices: ResNet3D-50 at
    width 8, the same weights, atol 2e-4 (the JAX test's,
    tests/test_spatial_sharding.py); its last stage falls back to
    replicated, as in JAX;
  * world 4 against the port unsharded, at a depth whose 2-plane slabs
    are thinner than the stem's 3-plane halo and whose stage 2 falls
    back: the stage outputs and, in float64, every parameter's gradient
    within 1e-5 of its largest;
  * `sharded_simple_test` at world 2 against the replicated simple_test;
  * the hybrid step on a 2 x 2 layout against one process's step over
    the same global batch, in float64: every gradient and update within
    1e-5 of its parameter's largest -- the check that a backbone
    gradient is not counted once per depth rank.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.compilation_cache import compilation_cache

import chip_smoke as cs
from mrcnn3d.models.resnet3d import ResNet3D as JResNet3D
from mrcnn3d.parallel.mesh import make_mesh as j_make_mesh
from mrcnn3d.parallel.spatial import spatial_extract_feat as j_spatial
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.models.resnet3d import ResNet3D
from mrcnn3d_torch.parallel.launch import spawn
from mrcnn3d_torch.parallel.spatial import depth_sharded
from test_torch_port_models import _randomise
from torch_port_fixtures import torch_threads  # noqa: F401
from torch_port_ranks import backbone_rank

ATOL = 2e-4
TOL = 1e-5


class _Wrapper:
    """The JAX ResNet3D as the model `spatial_extract_feat` expects
    (tests/test_spatial_sharding.py's)."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, x, method=None):
        return self.module.apply(variables, x)

    def clone(self, **updates):
        return _Wrapper(self.module.clone(**updates))

    extract_feat = None


def _backbone_weights(variables):
    """The JAX backbone's variables under the port's ResNet3D names."""
    sd = state_dict_from_jax({
        "params": {"backbone": variables["params"], "neck": {}},
        "batch_stats": {"backbone": variables["batch_stats"]}})
    return {k[len("backbone."):]: v for k, v in sd.items()}


def test_depth_sharded_backbone_matches_jax(tmp_path):
    # the mesh program compiles fresh: XLA:CPU aborts reloading some
    # multi-device executables, and JAX keeps a process's first decision
    # to use the cache unless it is reset
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        m = JResNet3D(depth=50, base_width=8)
        x = np.random.RandomState(0).randn(1, 16, 32, 32, 3).astype(
            np.float32)
        variables = _randomise(
            jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
            np.random.RandomState(1))
        want = j_spatial(_Wrapper(m), variables, j_make_mesh(2))(
            jnp.asarray(x))
        want = [np.moveaxis(np.asarray(w), -1, 1) for w in want]
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        compilation_cache.reset_cache()
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    out = spawn(backbone_rank, 2,
                (_backbone_weights(variables), xt, 8, False),
                workdir=str(tmp_path))
    for got in out:
        assert len(got) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_depth_sharded_backbone_world4_falls_back(tmp_path):
    torch.manual_seed(0)
    model = ResNet3D(50, 4).double()
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                p.normal_(0, 0.1)
    x = torch.randn(1, 3, 8, 16, 16, dtype=torch.float64)
    outs = model(x)
    loss = sum((o * torch.cos(o.detach())).sum() for o in outs)
    loss.backward()
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ranks = spawn(backbone_rank, 4, (weights, x, 4, True),
                  workdir=str(tmp_path))
    for got, grads in ranks:
        for g, w in zip(got, outs):
            torch.testing.assert_close(g, w.detach(), rtol=0, atol=1e-10)
        for n, p in model.named_parameters():
            scale = float(p.grad.abs().max())
            err = float((grads[n] - p.grad).abs().max())
            assert err <= TOL * scale, (n, err, scale)


def test_sharded_simple_test_matches_replicated(tmp_path):
    cfg = cs.small_config()
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.test_cfg["rpn"][k] = cs.SMALL_BUDGET
    cfg.test_cfg["rcnn"]["max_per_img"] = cs.SMALL_BUDGET
    out = cs.check_dist_infer(cfg, {"sharded": cs.sharded_batch()}, "cpu",
                              workdir=str(tmp_path))
    assert out["sharded"][0] <= cs.PIPELINE_ATOL


def test_hybrid_step_matches_unsharded(tmp_path):
    worst, _ = cs.check_dist_train(
        cs.small_train_config(), cs.small_train_batch(3, 2), (2, 2), "cpu",
        workdir=str(tmp_path), dtype=torch.float64)
    assert worst <= cs.MULTICARD_TOL


def test_depth_sharding_needs_resnet3d():
    with pytest.raises(ValueError, match="ResNet3D"):
        with depth_sharded(torch.nn.Conv3d(3, 4, 3)):
            pass
