"""The port's weight bridge: JAX variables -> port state_dict.

`convert_state_dict` (JAX package, torch -> JAX) must undo
`state_dict_from_jax` (port, JAX -> torch) on every leaf, and the
result must fill every parameter and buffer of the port model.  This
covers the inverse transforms: conv and deconv kernels (with the
spatial flip), dense kernels and the first-fc input permutation.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mrcnn3d.compat.torch_convert import convert_state_dict
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.detectors.build import build_detector as t_build
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import narrow_cfg
from torch_port_fixtures import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def variables():
    model = j_build(narrow_cfg(JConfig))
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 32, 32, 3)))
    rng = np.random.RandomState(0)
    # distinct values everywhere, so a swapped or mis-permuted leaf shows
    return jax.tree.map(
        lambda x: rng.randn(*np.shape(x)).astype(np.float32), v
    )


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def test_round_trip_every_leaf(variables):
    sd = state_dict_from_jax(variables)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, channels=8
    )
    for coll, got in (("params", params), ("batch_stats", stats)):
        want = dict(_leaves(variables[coll]))
        have = dict(_leaves(got))
        assert set(have) == set(want), coll
        for name, leaf in want.items():
            np.testing.assert_array_equal(have[name], leaf, err_msg=name)


def test_covers_every_port_tensor(variables):
    sd = state_dict_from_jax(variables)
    model = t_build(narrow_cfg(TConfig), device="cpu")
    want = model.state_dict()
    assert set(sd) == set(want)
    for name, t in want.items():
        assert tuple(sd[name].shape) == tuple(t.shape), name
    model.load_state_dict(sd, strict=True)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[name].numpy(),
                                      err_msg=name)
