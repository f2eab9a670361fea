"""The training slice: the port's `forward_train`, gradients, optimizer
and checkpoints against the JAX package, on the CPU.

The narrow flagship (depth 50 kept, widths 4/8/32) on 8x32x32 volumes
plus their 12x48x48 twins, two images, the training budgets cut to that
size (`chip_smoke.small_train_config`).  One jitted JAX value_and_grad
of `forward_train`; the port runs the same weights and batch with its
samplers replaying the JAX key tree.  Tolerances: each loss within 2e-3,
each parameter's gradient within 2e-3 of the JAX gradient's largest
magnitude (the existing torch replay tolerance; float32 convolutions
summed in other orders), the parameters after two SGD steps within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from chip_smoke import SMALL_SHAPES, small_train_batch, small_train_config
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.train.optim import make_optimizer, step_lr_schedule
from mrcnn3d_torch.compat.jax_weights import (
    load_train_state,
    state_dict_from_jax,
)
from mrcnn3d_torch.detectors import pipeline as tpl
from mrcnn3d_torch.detectors.build import anchor_cfgs, build_detector
from mrcnn3d_torch.entry import build_trainer
from mrcnn3d_torch.models.layers import FrozenBatchNorm
from mrcnn3d_torch.train import checkpoint
from mrcnn3d_torch.train.step import apply_gradients, create_train_state
from test_torch_port_models import jax_flagship
from test_torch_port_targets import forward_train_draws
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = 2e-3
MODULES = ["backbone", "neck", "rpn_head", "rpn_head_2", "bbox_head",
           "refinement_head", "mask_head", "refinement_mask_head"]


def _shrink(cfg):
    """The JAX config with small_train_config's training budgets."""
    small = small_train_config().train_cfg
    for part in ("rpn_proposal", "rpn", "rcnn"):
        cfg.train_cfg[part] = small[part]
    return cfg


def port_train_model(variables):
    """The narrow port flagship's training build, loaded with the JAX
    variables."""
    model = build_detector(small_train_config(), device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _port_run(model, batch, rng, scale=1.0):
    cfg = small_train_config()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("imgs", "imgs_2"):
        tb[k] = tb[k] * scale
    sets = tpl.anchor_sets_for(model, anchor_cfgs(cfg), SMALL_SHAPES)
    draws = forward_train_draws(rng, 2)
    model.zero_grad(set_to_none=True)
    total, losses = tpl.forward_train(model, tb, cfg, sets, draws)
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    losses = {k: float(v.detach()) for k, v in losses.items()}
    return float(total.detach()), losses, grads, draws.highs


@pytest.fixture(scope="module")
def parity():
    jcfg, jmodel, variables = jax_flagship(seed=0)
    _shrink(jcfg)
    sets = []
    for (d, h, w), ac in zip(SMALL_SHAPES, j_anchor_cfgs(jcfg)):
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    batch = small_train_batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for k in ("imgs", "imgs_2"):
        jb[k] = jnp.asarray(np.transpose(batch[k], (0, 2, 3, 4, 1)))
    rng = jax.random.PRNGKey(5)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        return jpl.forward_train(jmodel, v, jb, rng, jcfg, sets)

    (jtotal, jlosses), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jgrads = jax.tree.map(np.asarray, jgrads)
    model = port_train_model(variables)
    port = _port_run(model, batch, rng)
    return dict(jcfg=jcfg, variables=variables, batch=batch, rng=rng,
                jtotal=float(jtotal),
                jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=state_dict_from_jax({"params": jgrads}),
                jgrads_tree=jgrads, model=model, port=port)


def test_forward_train_losses_match_jax(parity):
    total, losses, _, highs = parity["port"]
    assert set(losses) == set(parity["jlosses"])
    for k, v in parity["jlosses"].items():
        assert abs(losses[k] - v) <= ATOL, (k, losses[k], v)
    assert abs(total - parity["jtotal"]) <= ATOL
    # every sampler drew: 2 scales' RPN and R-CNN, the refinement
    stages = {site[0] for site, _, _ in highs}
    assert stages == {"rpn", "rcnn", "refine"} and len(highs) == 20
    assert parity["jlosses"]["loss_mask"] > 0


def test_samples_have_margin(parity):
    """The assignments behind the draws (each draw's count) must not sit
    within float noise of a threshold: a 1e-4 change of the input keeps
    every count, so the comparison does not hang on summation order."""
    model = port_train_model(parity["variables"])
    _, _, _, highs = _port_run(model, parity["batch"], parity["rng"],
                               scale=1.0 + 1e-4)
    assert highs == parity["port"][3]


@pytest.mark.parametrize("module", MODULES)
def test_gradients_match_jax(parity, module):
    """Every parameter's gradient, mapped from the JAX tree onto the
    port's names (`state_dict_from_jax`: permutations only)."""
    _, _, grads, _ = parity["port"]
    names = [n for n in grads if n.split(".")[0] == module]
    assert names
    for name in names:
        want = parity["jgrads"][name].numpy()
        got = grads[name].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ATOL * max(scale, 1e-12),
                                   err_msg=name)
    assert any(float(np.abs(grads[n].numpy()).max()) > 0 for n in names)


def test_frozen_bn_scale_and_bias_train(parity):
    """FrozenBatchNorm's weight and bias are parameters whose gradients
    equal JAX's `scale` and `bias` gradients; the statistics are buffers,
    outside the parameters the optimizer updates."""
    model = parity["model"]
    _, _, grads, _ = parity["port"]
    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, FrozenBatchNorm)]
    assert len(bns) == 53
    assert not [n for n, _ in model.named_parameters() if "running_" in n]
    for name, mod in bns:
        assert isinstance(mod.weight, torch.nn.Parameter)
        assert "running_mean" in dict(mod.named_buffers())
        for part in ("weight", "bias"):
            want = parity["jgrads"][f"{name}.{part}"].numpy()
            got = grads[f"{name}.{part}"].numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=ATOL * float(np.abs(want).max()),
                err_msg=f"{name}.{part}")
    assert sum(float(grads[f"{n}.weight"].abs().sum()) for n, _ in bns) > 0


def _jax_chain(jcfg):
    sched = step_lr_schedule(jcfg.optimizer["lr"], [], 100)
    return make_optimizer(jcfg.optimizer,
                          jcfg.optimizer_config.get("grad_clip"), sched)


def test_two_sgd_steps_match_jax(parity):
    """From a carried-over JAX train state (step 3, inside the warmup, a
    nonzero momentum trace): one step whose gradient norm (100) is
    clipped to 35, one below the clip (norm 10)."""
    jcfg, variables = parity["jcfg"], parity["variables"]
    params = variables["params"]
    g = parity["jgrads_tree"]
    norm = float(optax.global_norm(g))
    steps = [jax.tree.map(lambda x: x * (100.0 / norm), g),
             jax.tree.map(lambda x: -x * (10.0 / norm), g)]
    rng = np.random.RandomState(9)
    trace = jax.tree.map(
        lambda x: (rng.randn(*np.shape(x)) * 0.01).astype(np.float32),
        params)
    tx = _jax_chain(jcfg)
    st = tx.init(params)
    st = (st[0], st[1], optax.TraceState(trace=trace),
          optax.ScaleByScheduleState(count=jnp.asarray(3, jnp.int32)))

    @jax.jit
    def update(grad, st, p):
        updates, st = tx.update(grad, st, p)
        return optax.apply_updates(p, updates), st

    jparams = params
    for grad in steps:
        jparams, st = update(grad, st, jparams)

    model = port_train_model(variables)
    state = create_train_state(model, small_train_config())
    load_train_state(state, params, variables["batch_stats"], trace, 3)
    for grad in steps:
        mapped = state_dict_from_jax({"params": grad})
        for name, p in model.named_parameters():
            p.grad = torch.empty_like(p).copy_(mapped[name])
        apply_gradients(state)
    assert state.step == 5
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                       jparams)})
    start = state_dict_from_jax({"params": params})
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        moved = max(moved, float((want[name] - start[name]).abs().max()))
    assert moved > 1e-4, "the steps moved nothing: vacuous case"
    buf = state.optimizer.state[model.backbone.conv1.weight]
    want_trace = state_dict_from_jax({"params": jax.tree.map(
        np.asarray, st[2].trace)})["backbone.conv1.weight"].numpy()
    np.testing.assert_allclose(buf["momentum_buffer"].numpy(), want_trace,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("iters_per_epoch", [None, 7])
def test_schedule_matches_jax(iters_per_epoch):
    """The train state's learning rate against the JAX schedule as its
    callers build it: with iters_per_epoch, `train_api`'s (the config's
    lr steps in epochs of that many iterations); without, the benches'
    (no steps).  Counts around the warmup's end and each boundary."""
    cfg = small_train_config()
    lr_cfg = cfg.lr_config
    state = create_train_state(torch.nn.Linear(2, 2), cfg,
                               iters_per_epoch=iters_per_epoch)
    if iters_per_epoch is None:
        want = step_lr_schedule(cfg.optimizer["lr"], [], 100)
    else:
        want = step_lr_schedule(
            cfg.optimizer["lr"], lr_cfg["step"], iters_per_epoch,
            lr_cfg["warmup_iters"], lr_cfg["warmup_ratio"])
    bounds = [int(e) * 7 for e in lr_cfg["step"]]
    counts = [0, 5, 9, 10, 11] + [b + d for b in bounds for d in (-1, 0, 1)]
    got = [state.schedule(c) for c in counts]
    np.testing.assert_allclose(got, [float(want(c)) for c in counts],
                               rtol=1e-6)
    decayed = got[-1] < got[4] * 0.5
    assert decayed == (iters_per_epoch is not None)


def _batch(seed):
    return {k: torch.from_numpy(v) for k, v in small_train_batch(seed).items()}


def test_checkpoint_round_trip(tmp_path):
    """Save after a step, restore into a trainer built from another seed:
    weights, momentum and step come back, and the next step is the same
    as the original trainer's (same draws)."""
    cfg = small_train_config()
    first = build_trainer(cfg, device="cpu", seed=0)
    losses = first.step(_batch(3))
    assert all(torch.isfinite(v) for v in losses.values())
    manager = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    checkpoint.save(manager, first.state)
    second = build_trainer(cfg, device="cpu", seed=1)
    assert checkpoint.restore(manager, second.state).step == 1
    for (name, a), b in zip(first.model.state_dict().items(),
                            second.model.state_dict().values()):
        assert torch.equal(a, b), name
    p1 = first.model.backbone.conv1.weight
    p2 = second.model.backbone.conv1.weight
    assert torch.equal(first.state.optimizer.state[p1]["momentum_buffer"],
                       second.state.optimizer.state[p2]["momentum_buffer"])
    second.draws.generator.set_state(first.draws.generator.get_state())
    a = first.step(_batch(4))
    b = second.step(_batch(4))
    assert torch.equal(a["loss"], b["loss"])
    assert torch.equal(p1, p2)
    for step in (2, 3):
        first.state.step = step
        checkpoint.save(manager, first.state)
    assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
    served = checkpoint.restore_params(manager)
    assert served["step"] == 3
    assert torch.equal(served["params"]["backbone.conv1.weight"], p1)
    assert checkpoint.restore_params(checkpoint.CheckpointManager(
        str(tmp_path / "empty"))) is None
