"""The training build starts where the JAX package's `model.init` starts:
flax's lecun_normal kernels (a normal truncated at two standard
deviations, rescaled to std 1 / sqrt(fan_in)), zero biases, frozen BN at
identity.  The inference build keeps its drawn statistics."""
import math

import numpy as np
import pytest
import torch

from mrcnn3d_torch.detectors.build import (
    TRUNC_NORMAL_STD,
    build_detector,
    fan_in,
)
from mrcnn3d_torch.models.layers import FrozenBatchNorm
from mrcnn3d_torch.utils.config import Config

CFG = "configs/mask_rcnn_3d_2scales.py"
# kernels with fewer values estimate their std too loosely for 5%
MIN_VALUES = 4096


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the tier-1 run shares the
    CPU among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_training_build_starts_at_flax_init():
    model = build_detector(Config.fromfile(CFG), device="cpu", train=True)
    checked = n_bn = 0
    for name, mod in model.named_modules():
        n = fan_in(mod)
        if n is not None:
            w = mod.weight.detach().double()
            target = 1.0 / math.sqrt(n)
            # truncated at 2 sigma of the underlying normal, scaled
            assert w.abs().max() <= 2 * target / TRUNC_NORMAL_STD * (1 + 1e-6)
            if w.numel() >= MIN_VALUES:
                assert abs(w.std().item() / target - 1) < 0.05, name
                checked += 1
            if mod.bias is not None:
                assert not mod.bias.any(), name
        elif isinstance(mod, FrozenBatchNorm):
            assert torch.equal(mod.running_mean, torch.zeros_like(
                mod.running_mean)), name
            assert torch.equal(mod.running_var, torch.ones_like(
                mod.running_var)), name
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
            assert torch.equal(mod.bias, torch.zeros_like(mod.bias))
            n_bn += 1
    assert checked > 50 and n_bn > 50


def test_training_build_matches_flax_statistics():
    """Per-kernel std ratios and largest values of the JAX package's
    `model.init` at narrow widths, against the port's training build of
    the same config: the same truncation bound, the same std to a few %."""
    import jax
    import jax.numpy as jnp

    from mrcnn3d.detectors.build import build_detector as jbuild
    from mrcnn3d.utils.config import Config as JConfig
    from test_torch_port_models import narrow_cfg

    jmodel = jbuild(narrow_cfg(JConfig))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8, 32, 32, 3)))
    jratios = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["params"]):
        if getattr(path[-1], "key", None) == "kernel" and leaf.size >= 2048:
            w = np.asarray(leaf, np.float64)
            jratios.append((w.std() * math.sqrt(w[..., 0].size),
                            np.abs(w).max() * math.sqrt(w[..., 0].size)))
    model = build_detector(narrow_cfg(Config), device="cpu", train=True)
    tratios = []
    for mod in model.modules():
        n = fan_in(mod)
        if n is not None and mod.weight.numel() >= 2048:
            w = mod.weight.detach().double()
            tratios.append((w.std().item() * math.sqrt(n),
                            w.abs().max().item() * math.sqrt(n)))
    j, t = np.array(jratios), np.array(tratios)
    bound = 2 / TRUNC_NORMAL_STD
    assert (j[:, 1] <= bound * (1 + 1e-6)).all()
    assert (t[:, 1] <= bound * (1 + 1e-6)).all()
    assert abs(np.median(j[:, 0]) - 1) < 0.03
    assert abs(np.median(t[:, 0]) - 1) < 0.03


def test_inference_build_keeps_drawn_statistics():
    model = build_detector(Config.fromfile(CFG), device="cpu")
    bn = next(m for m in model.modules() if isinstance(m, FrozenBatchNorm))
    assert bn.running_mean.abs().max() > 0
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
