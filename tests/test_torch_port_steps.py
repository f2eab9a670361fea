"""SGD steps of the narrow flagship at the flagship's full training
budgets (RPN sampler 256, proposals 2000, R-CNN sampler 512), the JAX
package's jitted train step against the port's, from the same flax
initial weights (zero biases), on the same generated crops, the JAX key
tree replayed into the port's samplers.  The warmup is cut to 2
iterations, so the steps cross its end: momentum, weight decay and the
clip act on the warmup's and the full learning rate.

After each of the first two steps every parameter must agree to 1e-5
of its largest magnitude; after every step each head's update (the
step's change of a parameter) must agree to UPDATE_TOL of the JAX
update's largest.  Before ROADMAP Queue C 5's
repair the first step's bias gradients at logits exactly 0 (the 1.0x
RPN classifier's, the mask logits') were apart, and this test failed on
the first step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import small_config
from mrcnn3d.data.coco3d import Coco3D2ScalesDataset as JDataset
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.train.optim import make_optimizer, step_lr_schedule
from mrcnn3d.train.step import create_train_state as j_create
from mrcnn3d.train.step import make_train_step
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.train.step import create_train_state, train_step
from test_torch_port_models import narrow_cfg
from test_torch_port_targets import forward_train_draws

STEPS = 4
WARMUP = 2
TOL = 1e-5
# a step's update, port against JAX, relative to the JAX update's
# largest, for the modules downstream of the aligns (the backbone and
# neck see the backbone's ReLU and max-pool ties, which route a few
# gradients differently on either side)
UPDATE_TOL = 2e-3
HEADS = ("rpn_head", "rpn_head_2", "bbox_head", "refinement_head",
         "mask_head", "refinement_mask_head")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the tier-1 run shares the
    CPU among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(tree):
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, tree)})


def test_full_budget_steps_match_jax(tmp_path):
    tcfg = small_config()
    jcfg = narrow_cfg(JConfig)
    for cfg in (tcfg, jcfg):
        cfg.lr_config["warmup_iters"] = WARMUP
    ann, img = make_synthetic_coco3d(str(tmp_path), num_volumes=2, hw=96,
                                     depth=12, seed=5)
    tr = tcfg.data["train"]
    ds = JDataset(ann, img, img_norm_cfg=tr["img_norm_cfg"], max_gt=16,
                  extra_aug=tr["extra_aug"], seed=3)
    samples = [ds[i % 2] for i in range(STEPS)]
    shapes = [samples[0]["imgs"].shape[:3], samples[0]["imgs_2"].shape[:3]]

    jmodel = j_build(jcfg)
    sched = step_lr_schedule(jcfg.optimizer["lr"], [], 1,
                             jcfg.lr_config["warmup_iters"],
                             jcfg.lr_config["warmup_ratio"])
    tx = make_optimizer(jcfg.optimizer, jcfg.optimizer_config.get(
        "grad_clip"), sched)
    jstate = j_create(jmodel, jax.random.PRNGKey(0),
                      jnp.zeros((1, 8, 32, 32, 3)), tx)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    sets = []
    for (d, h, w), ac in zip(shapes, j_anchor_cfgs(jcfg)):
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    step_fn = make_train_step(jmodel, tx, jcfg, sets)

    model = build_detector(tcfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables)), strict=True)
    state = create_train_state(model, tcfg)
    before = _params(jstate.params)
    before_port = {n: p.detach().clone() for n, p in model.named_parameters()}
    for k, s in enumerate(samples):
        rng = jax.random.fold_in(jax.random.PRNGKey(1), k)
        jstate, jm = step_fn(jstate, {n: jnp.asarray(v[None])
                                      for n, v in s.items()}, rng)
        tb = {n: torch.from_numpy(np.ascontiguousarray(v[None]))
              for n, v in s.items()}
        for n in ("imgs", "imgs_2"):
            tb[n] = tb[n].permute(0, 4, 1, 2, 3)
        tm = train_step(state, tb, forward_train_draws(rng, 1))
        assert abs(float(tm["loss_mask"]) - float(jm["loss_mask"])) <= TOL
        want = _params(jstate.params)
        for name, p in model.named_parameters():
            scale = float(want[name].abs().max())
            err = float((p.detach() - want[name]).abs().max())
            if k < 2:
                assert err <= TOL * max(scale, 1e-12), (k, name, err, scale)
            if name.split(".")[0] in HEADS:
                upd = want[name] - before[name]
                scale = float(upd.abs().max())
                err = float((p.detach() - before_port[name] - upd).abs()
                            .max())
                assert err <= UPDATE_TOL * scale, (k, name, err, scale)
        before = want
        before_port = {n: p.detach().clone()
                       for n, p in model.named_parameters()}
    # the step-0 bias gradients the repair is about moved these biases
    assert float(want["rpn_head.rpn_cls.bias"].abs().max()) > 0
    assert float(want["mask_head.conv_logits.bias"].abs().max()) > 0
