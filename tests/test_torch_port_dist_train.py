"""Data-parallel training of the port on the CPU: gloo processes spawned
per test (`mrcnn3d_torch.parallel.launch.spawn`, a file store under
tmp_path).

The slice as a whole: 2 ranks x 1 image take one step against the JAX
package's mesh step (`make_train_step(..., mesh=make_mesh(2))` on the
conftest's virtual CPU devices) over the same global batch of 2, from
the same weights (`state_dict_from_jax`), the JAX key tree replayed at
the images' global indices: the losses within 2e-3 and every parameter's
update within UPDATE_TOL (2e-3, as in test_torch_port_steps.py) of the
JAX update's largest; the same ranks in float64 against one float64
process within 1e-5.  N ranks against one process over the global
batch (keyed draws): every update and gradient within 1e-5 of its
parameter's largest, for the flagship and for RetinaNet3D, whose focal
normalizer (the batch's positives) differs between its images.  Those
run the model in float64: in float32 a convolution over one image and
over two round differently, and a ReLU input within that rounding of 0
takes the other branch on the other side (RetinaNet3D's seed-0 step
has one, which moves a layer4 bias's gradient by 3% of its largest).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.compilation_cache import compilation_cache

import chip_smoke as cs
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.parallel.mesh import make_mesh as j_make_mesh
from mrcnn3d.train.optim import make_optimizer, step_lr_schedule
from mrcnn3d.train.step import TrainState, make_train_step
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.core.targets import KeyedDraws
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.parallel import mesh as pmesh
from mrcnn3d_torch.parallel.launch import spawn
from test_torch_port_models import jax_flagship
from test_torch_port_targets import forward_train_draws
from torch_port_fixtures import torch_threads  # noqa: F401
from torch_port_ranks import allreduce_rank, train_detector_rank

LOSS_TOL = 2e-3
UPDATE_TOL = 2e-3
# the JAX comparison's learning rate: a float32 parameter's change after
# a step resolves the update only to the parameter's last bit, which at
# the flagship's 1e-3 (a third of it in the warmup) is up to 3e-3 of the
# update of the least-moved heads; 1e-1 puts every update far above it
JAX_STEP_LR = 0.1


def _small_budgets(cfg):
    """small_train_config's budgets on a config of either package."""
    tc = cfg.train_cfg
    for k in ("nms_pre", "nms_post", "max_num"):
        tc["rpn_proposal"][k] = cs.SMALL_BUDGET
    tc["rpn"]["sampler"]["num"] = 64
    tc["rcnn"]["sampler"]["num"] = 32
    return cfg


def _jax_mesh_step(jcfg, jmodel, variables, batch, rng):
    """The JAX package's data-parallel step over a 2-device mesh: (new
    params as a state dict, metrics)."""
    sched = step_lr_schedule(jcfg.optimizer["lr"], [], 1,
                             jcfg.lr_config["warmup_iters"],
                             jcfg.lr_config["warmup_ratio"])
    tx = make_optimizer(jcfg.optimizer,
                        jcfg.optimizer_config.get("grad_clip"), sched)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=tx.init(params))
    jb = {k: jnp.asarray(np.moveaxis(v, 1, -1) if k.startswith("imgs")
                         else v) for k, v in batch.items()}
    sets = []
    for s, ac in enumerate(j_anchor_cfgs(jcfg)):
        d, h, w = jb["imgs" + ("", "_2")[s]].shape[1:4]
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
    step = make_train_step(jmodel, tx, jcfg, sets, mesh=j_make_mesh(2))
    state, metrics = step(state, jb, rng)
    new = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                      state.params)})
    return new, {k: float(v) for k, v in metrics.items()}


@pytest.fixture
def no_compile_cache():
    """XLA:CPU aborts when it reloads some serialized multi-device
    executables from the persistent cache (tests/conftest.py): the mesh
    step compiles fresh.  JAX decides at a process's first compile
    whether it uses the cache and keeps that decision, so the switch
    alone did nothing in an xdist worker that had compiled before (the
    worker aborted loading the mesh step); `reset_cache` makes JAX decide
    again on each side of the test."""
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    compilation_cache.reset_cache()


def test_dp_step_matches_jax_mesh_step(tmp_path, no_compile_cache):
    jcfg, jmodel, variables = jax_flagship()
    jcfg = _small_budgets(jcfg)
    cfg = cs.small_train_config()
    for c in (jcfg, cfg):
        c.optimizer["lr"] = JAX_STEP_LR
    weights = state_dict_from_jax(variables)
    batch = cs.small_train_batch(3, 2)
    rng = jax.random.PRNGKey(1)
    want, jm = _jax_mesh_step(jcfg, jmodel, variables, batch, rng)

    # one process over the global batch, JAX's draws recorded by site;
    # then two ranks replaying them at their images' global indices: in
    # float64 against the one process (in float32 the two sum the
    # gradients in other orders, up to 1.4e-5 of a parameter's largest,
    # as much as MULTICARD_TOL), and in float32 against JAX
    for dtype in (torch.float64, torch.float32):
        record = cs.RecordDraws(forward_train_draws(rng, 2))
        serial = cs.serial_train(cfg, weights, batch, "cpu", record,
                                 dtype=dtype)
        ranks = spawn(cs.dist_train_rank, 2,
                      (cfg, weights, batch, (2, 1), "cpu", record.table,
                       dtype),
                      workdir=str(tmp_path / str(dtype)))
        if dtype == torch.float64:
            for i, got in enumerate(ranks):
                cs.compare_steps(got, serial, cs.MULTICARD_TOL, f"rank {i}")
    assert abs(serial["losses"]["loss"] - jm["loss"]) <= LOSS_TOL
    for i, got in enumerate(ranks):
        assert abs(got["losses"]["loss"] - jm["loss"]) <= LOSS_TOL
        assert abs(got["losses"]["loss_mask"] - jm["loss_mask"]) <= LOSS_TOL
        for name, after in got["params"].items():
            upd = want[name] - weights[name]
            scale = float(upd.abs().max())
            err = float((after - weights[name] - upd).abs().max())
            assert err <= UPDATE_TOL * scale, (i, name, err, scale)


@pytest.mark.parametrize("type_name", ["flagship", "RetinaNet3D"])
def test_dp_step_matches_one_process(tmp_path, type_name):
    if type_name == "flagship":
        cfg, batch = cs.small_train_config(), cs.small_train_batch(3, 2)
    else:
        cfg = cs.family_narrow(cs.family_config(type_name), 64)
        batch = cs.family_train_batch(5, type_name)
    worst, _ = cs.check_dist_train(cfg, batch, (2, 1), "cpu",
                                   workdir=str(tmp_path),
                                   dtype=torch.float64)
    assert worst <= cs.MULTICARD_TOL


def test_keyed_draws_follow_the_site():
    """A keyed draw depends on (seed, step, site) alone: the order of the
    calls does not matter, the step and the image do."""
    high = torch.tensor(1000)
    a, b = KeyedDraws(3).at(5), KeyedDraws(3).at(5)
    first = a(("rcnn", 0, 1, "pos"), 8, high)
    b(("rcnn", 0, 0, "pos"), 8, high)
    assert torch.equal(first, b(("rcnn", 0, 1, "pos"), 8, high))
    assert not torch.equal(first, a(("rcnn", 0, 0, "pos"), 8, high))
    assert not torch.equal(first, KeyedDraws(3).at(6)(
        ("rcnn", 0, 1, "pos"), 8, high))
    assert int(first.min()) >= 0 and int(first.max()) < 1000


def test_local_rows_take_the_jax_layout():
    batch = {"imgs": torch.arange(8).reshape(4, 2), "info": list("abcd")}
    rows = [pmesh.local_rows(batch, r, 2) for r in range(2)]
    assert rows[1]["imgs"].tolist() == [[4, 5], [6, 7]]
    assert rows[0]["info"] == ["a", "b"]
    with pytest.raises(ValueError, match="does not split"):
        pmesh.local_rows(batch, 0, 3)


def test_allreduce_grads_and_global_sum(tmp_path):
    out = spawn(allreduce_rank, 4, workdir=str(tmp_path))
    for grads, count, depth_rank, local in out:
        assert local
        for i, g in enumerate(grads):
            want = torch.arange(g.numel(), dtype=g.dtype) * 10 + 4 * i
            assert torch.equal(g, want)
        # a 2x2 mesh's data groups, depth innermost: ranks {0, 2}, {1, 3}
        assert count == (2.0 if depth_rank == 0 else 4.0)


def test_train_detector_world2_keeps_replicas_equal(tmp_path):
    """Two ranks, each on its shard of the epoch: the replicas stay
    equal (one broadcast, then summed gradients), rank 0 writes the
    checkpoint every rank can read."""
    make_synthetic_coco3d(str(tmp_path / "data"), num_volumes=4, hw=96,
                          depth=12, seed=5)
    out = spawn(train_detector_rank, 2, (str(tmp_path),),
                workdir=str(tmp_path / "spawn"))
    (p0, step0, ck0), (p1, step1, ck1) = out
    assert step0 == step1 == 2 and ck0 == ck1 == [2]
    for name, v in p0.items():
        assert torch.equal(v, p1[name]), name
