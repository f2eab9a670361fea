"""The whole slice: port `simple_test` on the CPU vs JAX `simple_test`.

Narrow widths (depth 50 kept), an 8x32x32 volume plus its 12x48x48
twin, every budget at 64, boxes and masks.  Run once through the RPNs
and once with precomputed proposals.  `valid` and `labels` must be
equal; `dets` and `mask_logits` on valid rows within 2e-3, the
tolerance of the existing torch replay tests.

Both runs are deterministic on the CPU.  A seed whose decisions (top-k
cuts, IoU against a threshold, scores against score_thr) sit within
float noise of a boundary would make the comparison depend on summation
order, so each case first checks that the port's decisions survive a
1e-4 perturbation of the input; such a seed fails there, and is
replaced, instead of failing the comparison at random.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from chip_smoke import SMALL_BUDGET as BUDGET
from chip_smoke import SMALL_SHAPES as SHAPES
from chip_smoke import compare_outputs, small_config, small_inputs, small_run
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.entry import Flagship, build
from test_torch_port_models import jax_flagship, port_flagship
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3


def _budgets(cfg):
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.test_cfg["rpn"][k] = BUDGET
    cfg.test_cfg["rcnn"]["max_per_img"] = BUDGET
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


@pytest.fixture(scope="module")
def models():
    jcfg, jmodel, variables = jax_flagship(seed=0)
    tcfg, tmodel = port_flagship(variables)
    _budgets(jcfg)
    _budgets(tcfg)
    sets = []
    for (d, h, w), ac in zip(SHAPES, j_anchor_cfgs(jcfg)):
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)),
        )
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    jrun = jax.jit(
        lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets)
    )
    return jrun, variables, Flagship(tcfg, tmodel, torch.device("cpu"))


@pytest.mark.parametrize("with_proposals", [False, True],
                         ids=["rpn", "proposals"])
def test_simple_test_matches_jax(models, with_proposals):
    jrun, variables, det = models
    batch = small_inputs(7, with_proposals)
    got = small_run(det, batch)
    # margin: decisions must not sit within float noise of a boundary
    compare_outputs(got, small_run(det, batch, scale=1.0 + 1e-4), ATOL,
                    "seed too close to a decision boundary")
    jbatch = dict(batch)
    for k in ("imgs", "imgs_2"):
        jbatch[k] = np.transpose(batch[k], (0, 2, 3, 4, 1))
    want = jax.tree.map(np.asarray, jrun(
        variables, {k: jnp.asarray(v) for k, v in jbatch.items()}))
    n = int(got["valid"].sum())
    assert n > 4, f"{n} detections: vacuous case"
    compare_outputs(got, want, ATOL, "port vs JAX")
    assert not got["mask_logits"][~got["valid"][0]].any()
    tres = tpl.bbox2result3d(*(torch.from_numpy(got[k][0])
                               for k in ("dets", "labels", "valid")), 2)
    jres = jpl.bbox2result3d(want["dets"][0], want["labels"][0],
                             want["valid"][0], 2)
    assert [r.shape for r in tres] == [r.shape for r in jres]
    np.testing.assert_allclose(tres[0], jres[0], atol=ATOL)


@pytest.mark.parametrize("with_proposals", [False, True],
                         ids=["rpn", "proposals"])
def test_card_check_has_margin(with_proposals):
    """chip_smoke.py compares this pipeline (seeded port weights) on the
    card against the CPU; its decisions must not sit within float noise
    of a boundary either."""
    det = build(small_config(), device="cpu", budgets=BUDGET)
    batch = small_inputs(7, with_proposals)
    got = small_run(det, batch)
    assert int(got["valid"].sum()) > 4
    compare_outputs(got, small_run(det, batch, scale=1.0 + 1e-4), ATOL,
                    "seed too close to a decision boundary")


def test_boxes_only_config_skips_masks():
    """`build` keeps the config's return_bbox_only (the flagship config's
    own setting is True): `run` then gives the same boxes as with masks,
    and no mask logits."""
    batch = {k: torch.from_numpy(v)
             for k, v in small_inputs(7, False).items()}
    cfg = small_config()
    masks = build(cfg, device="cpu", budgets=BUDGET).run(
        batch["imgs"], batch["imgs_2"])
    cfg.test_cfg["return_bbox_only"] = True
    det = build(cfg, device="cpu", budgets=BUDGET)
    assert det.cfg.test_cfg["return_bbox_only"] is True
    boxes = det.run(batch["imgs"], batch["imgs_2"])
    assert boxes[3] is None and masks[3] is not None
    assert int(masks[2].sum()) > 4
    for a, b in zip(boxes[:3], masks[:3]):
        assert torch.equal(a, b)
