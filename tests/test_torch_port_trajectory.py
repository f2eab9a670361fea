"""The learning protocol's trajectory, JAX package against the port, in
lockstep on the CPU (ROADMAP Queue C 6, step 1).

Both packages train the narrow flagship from one JAX init on the same
batches: the pinned generator's volumes (`mrcnn3d_torch.data.synthetic`
with `tools/learning_bench.py`'s constants), cropped by each package's
own `Coco3D2ScalesDataset` (64x64x48 and its 96x96x72 twin, batch 1,
the crops held equal), in the loader's epoch order from the train seed;
JAX's `make_train_step` with the protocol's optimizer and step schedule;
JAX's per-step keys replayed into the port's samplers
(`forward_train_draws`).  Two measures per iteration, for each head in
HEADS and for the backbone and neck:

  * re-anchored: the port is loaded with JAX's parameters and momentum
    before the step (`load_train_state`); each side takes one step; the
    largest difference of a parameter's update, relative to that
    parameter's largest JAX update, taken over the group's parameters.
    This isolates a difference that depends on the state (saturated
    logits, a batch with no mask positives, the lr after the warmup).
    Its baseline: JAX's own step from its state with 1e-7 relative noise
    on the parameters, which shows what rounding alone moves within one
    step (a near-tie of two proposals' scores that flips their order);
  * free-running: the port's parameters, and those of a second JAX run
    whose initial parameters carry 1e-7 relative noise, each as an L2
    distance from the JAX run's, relative to its norm.  The noise run is
    the baseline that tells drift from chaos.

As a script it runs the trajectory and writes one JSON line per
iteration, then a summary line:

    JAX_PLATFORMS=cpu python tests/test_torch_port_trajectory.py \
        --iters 200 [--out work_dirs/trajectory/trajectory.jsonl]
        [--hours 1.0] [--threads N]

(the generated data, about 310 MB, goes to a temporary directory; one
iteration took 20-25 s on 8 CPU cores).  From a trained port state in
place of JAX's init, at the flagship's own widths, re-anchored only (each
step against JAX's, beside the noise baseline):

    JAX_PLATFORMS=cpu python tests/test_torch_port_trajectory.py \
        --state STATE.pt --full-width --iters 12

(STATE.pt: `torch.save({"model": model.state_dict()})`, e.g. of a
`learning_bench` checkpoint's "model"; its momentum is not carried.)

The tier-1 test takes RE_ANCHORED_ITERS re-anchored iterations at a
tiny geometry with cut budgets, and holds each head's update within
UPDATE_TOL.
"""
import argparse
import json
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import main_config, small_config  # noqa: E402
from mrcnn3d.compat.torch_convert import convert_state_dict  # noqa: E402
from mrcnn3d.data.coco3d import Coco3D2ScalesDataset as JDataset  # noqa
from mrcnn3d.detectors import pipeline as jpl  # noqa: E402
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs  # noqa
from mrcnn3d.detectors.build import build_detector as j_build  # noqa: E402
from mrcnn3d.train.optim import make_optimizer, step_lr_schedule  # noqa
from mrcnn3d.train.step import create_train_state as j_create  # noqa: E402
from mrcnn3d.train.step import make_train_step  # noqa: E402
from mrcnn3d.utils.config import Config as JConfig  # noqa: E402
from mrcnn3d_torch.compat.jax_weights import (  # noqa: E402
    load_train_state,
    state_dict_from_jax,
)
from mrcnn3d_torch.data.loader import epoch_indices  # noqa: E402
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d  # noqa
from mrcnn3d_torch.detectors.build import build_detector  # noqa: E402
from mrcnn3d_torch.tools import learning_bench as lb  # noqa: E402
from mrcnn3d_torch.train.step import create_train_state, train_step  # noqa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_models import narrow_cfg  # noqa: E402
from test_torch_port_steps import HEADS, UPDATE_TOL  # noqa: E402
from test_torch_port_targets import forward_train_draws  # noqa: E402
from torch_port_fixtures import torch_threads  # noqa: E402,F401

GROUPS = ("backbone", "neck") + HEADS
# relative noise on the baseline JAX run's initial parameters
NOISE = 1e-7
# the tier-1 test: tiny volumes (hw, depth, train volumes), cut budgets
TINY = (96, 32, 3)
TINY_BUDGET = 64
RE_ANCHORED_ITERS = 8


def _np_tree(tree):
    """A copy of a JAX tree as numpy (the step donates its state)."""
    return jax.tree.map(lambda x: np.array(x), tree)


def _group(name):
    return name.split(".")[0]


def _noisy(x, rng):
    """x with NOISE relative noise, in its dtype."""
    return (x * (1 + NOISE * rng.randn(*x.shape))).astype(x.dtype)


def _update_errors(got, want, worst=None):
    """Per group, the largest of each parameter's update difference
    relative to that parameter's largest `want` update (updates as
    momentum traces: the learning rate is the same on both sides).
    worst: a dict, given per group the parameter that sets it."""
    out = dict.fromkeys(GROUPS, 0.0)
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name] - w).abs().max())
        g = _group(name)
        rel = err / scale if scale else (0.0 if err == 0 else float("inf"))
        if rel >= out[g]:
            out[g] = rel
            if worst is not None:
                worst[g] = name
    return out


def _cut_budgets(cfg):
    """The tier-1 test's budgets: proposals, the RPN and R-CNN samplers
    at TINY_BUDGET."""
    tc = cfg.train_cfg
    for k in ("nms_pre", "nms_post", "max_num"):
        tc["rpn_proposal"][k] = TINY_BUDGET
    tc["rpn"]["sampler"]["num"] = TINY_BUDGET
    tc["rcnn"]["sampler"]["num"] = TINY_BUDGET // 2


class Lockstep:
    """Both packages at the protocol's data, optimizer and schedule, the
    data generated under `workdir`.

    geometry: (hw, depth, train volumes) of the generated data;
    cut_budgets: `_cut_budgets` in place of the flagship's training
    budgets; free_running: also the free-running runs (the port's and the
    noisy JAX run) and the re-anchored baseline; full_width: the
    flagship's own widths; start: a port state_dict both sides start
    from in place of JAX's init (with the re-anchored baseline)."""

    def __init__(self, workdir, geometry=(lb.HW, lb.DEPTH, lb.TRAIN_VOLUMES),
                 seed=lb.TRAIN_SEED, cut_budgets=False, free_running=True,
                 full_width=False, start=None):
        hw, depth, n = geometry
        ann, img = make_synthetic_coco3d(
            os.path.join(workdir, "train_data"), num_volumes=n, hw=hw,
            depth=depth, lesions_per_volume=lb.LESIONS,
            seed=lb.DATA_SEED_TRAIN)
        if full_width:
            self.tcfg = main_config()
            self.jcfg = JConfig.fromfile(lb.CONFIG)
        else:
            self.tcfg = small_config()
            self.jcfg = narrow_cfg(JConfig)
        if cut_budgets:
            _cut_budgets(self.tcfg)
            _cut_budgets(self.jcfg)
        tr = self.jcfg.data["train"]
        self.jds = JDataset(
            ann, img, upscale_factor=self.jcfg.get("upscale_factor", 1.5),
            img_norm_cfg=tr["img_norm_cfg"],
            size_divisor=tr.get("size_divisor", 32), with_mask=True,
            max_gt=self.jcfg.get("static_shapes", {}).get("max_gt", 16),
            extra_aug=tr.get("extra_aug"), seed=seed)
        self.tds = lb.train_dataset(self.tcfg, ann, img, seed)
        # both training loops probe one sample for the crop shapes
        probe = self.jds[0]
        self.tds[0]
        self.shapes = [probe["imgs"].shape[:3], probe["imgs_2"].shape[:3]]
        self.seed = seed
        self.iters_per_epoch = len(self.jds)

        jcfg = self.jcfg
        self.jmodel = j_build(jcfg)
        sched = step_lr_schedule(
            jcfg.optimizer["lr"], jcfg.lr_config.get("step", []),
            self.iters_per_epoch, jcfg.lr_config.get("warmup_iters", 10),
            jcfg.lr_config.get("warmup_ratio", 1.0 / 3))
        self.schedule = sched
        tx = make_optimizer(jcfg.optimizer,
                            jcfg.optimizer_config.get("grad_clip"), sched)
        # train_detector's key tree: init, then a key per step
        rng = jax.random.PRNGKey(seed)
        init_rng, self.rng = jax.random.split(rng)
        d, h, w = self.shapes[0]
        example = jnp.zeros((1, min(d, 8), min(h, 32), min(w, 32), 3))
        self.jstate = j_create(self.jmodel, init_rng, example, tx)
        if start is not None:
            # a port state (name -> tensor) in place of JAX's init, the
            # momentum trace at zero
            params, stats = convert_state_dict(
                {k: v.float() for k, v in start.items()},
                channels=self.tcfg.model["neck"]["out_channels"])
            self.jstate = self.jstate._replace(
                params=jax.tree.map(jnp.asarray, params),
                batch_stats=jax.tree.map(jnp.asarray, stats))
        variables = {"params": self.jstate.params,
                     "batch_stats": self.jstate.batch_stats}
        sets = []
        for (d, h, w), ac in zip(self.shapes, j_anchor_cfgs(jcfg)):
            feats = jax.eval_shape(
                lambda x: self.jmodel.apply(variables, x,
                                            method=self.jmodel.extract_feat),
                jnp.zeros((1, d, h, w, 3)))
            sets.append(jpl.build_anchor_set(
                [f.shape[1:4] for f in feats], (h, w, 3, d), ac))
        self.step_fn = make_train_step(self.jmodel, tx, jcfg, sets)
        self.batch_stats = _np_tree(self.jstate.batch_stats)

        init = _np_tree(self.jstate.params)
        zeros = jax.tree.map(np.zeros_like, init)
        self.anchored = self._port_state(init, zeros)
        self.free = self._port_state(init, zeros) if free_running else None
        self.baseline = free_running or start is not None
        self.noisy = None
        if free_running:
            noise = np.random.RandomState(seed)
            # its own buffers: the step donates the state it is given
            own = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                               self.jstate)
            self.noisy = own._replace(params=jax.tree.map(
                lambda x: jnp.asarray(_noisy(x, noise)), init))
        self.order = []
        self.it = 0

    def _port_state(self, params, trace):
        model = build_detector(self.tcfg, device="cpu", train=True)
        state = create_train_state(model, self.tcfg,
                                   iters_per_epoch=self.iters_per_epoch)
        return load_train_state(state, params, self.batch_stats, trace, 0)

    def _batch(self):
        """The loader's next sample from each package, equal array for
        array: (JAX batch, port batch, gt count)."""
        if not self.order:
            epoch = self.it // self.iters_per_epoch
            self.order = list(epoch_indices(self.iters_per_epoch, epoch,
                                            True, 0, 1, self.seed))
        i = int(self.order.pop(0))
        js, ts = self.jds[i], self.tds[i]
        arrays = {k: v for k, v in js.items() if isinstance(v, np.ndarray)}
        for k, v in arrays.items():
            if not np.array_equal(v, ts[k]):
                raise AssertionError(f"iteration {self.it}: the crops' {k} "
                                     "differ between the packages")
        tb = {k: torch.from_numpy(np.ascontiguousarray(v[None]))
              for k, v in arrays.items()}
        for k in ("imgs", "imgs_2"):
            tb[k] = tb[k].permute(0, 4, 1, 2, 3)
        jb = {k: jnp.asarray(v[None]) for k, v in arrays.items()}
        return jb, tb, int(arrays["gt_valid"].sum())

    def step(self):
        """One iteration on every run; returns its record."""
        jb, tb, gts = self._batch()
        self.rng, step_rng = jax.random.split(self.rng)
        before = _np_tree(self.jstate.params)
        trace = _np_tree(self.jstate.opt_state[2].trace)
        twin = None
        if self.baseline:
            # the re-anchored baseline: JAX's own step from its state with
            # NOISE on the parameters
            noise = np.random.RandomState(self.seed + 1 + self.it)
            twin = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                                self.jstate)._replace(params=jax.tree.map(
                                    lambda x: jnp.asarray(_noisy(x, noise)),
                                    before))
        self.jstate, jm = self.step_fn(self.jstate, jb, step_rng)

        load_train_state(self.anchored, before, self.batch_stats, trace,
                         self.it)
        draws = forward_train_draws(step_rng, 1)
        tm = train_step(self.anchored, tb, draws)
        # a step's update is -lr times the new momentum trace on both
        # sides (optax's trace then scale_by_learning_rate; SGD's buffer):
        # compared there, before it is rounded into the parameter
        lr = float(self.schedule(self.it))
        want_trace = state_dict_from_jax({"params": _np_tree(
            self.jstate.opt_state[2].trace)})
        buffers = self.anchored.optimizer.state
        got = {name: buffers[p]["momentum_buffer"]
               for name, p in self.anchored.model.named_parameters()}
        largest = dict.fromkeys(GROUPS, 0.0)
        worst = {}
        for name, want in want_trace.items():
            g = _group(name)
            largest[g] = max(largest[g], lr * float(want.abs().max()))
        rec = dict(
            it=self.it, lr=lr, gts=gts,
            rcnn_positives=[h for site, _, h in draws.highs
                            if site[0] == "rcnn" and site[-1] == "pos"],
            loss_jax={k: float(v) for k, v in jm.items()},
            loss_port={k: float(v) for k, v in tm.items()},
            update_rel_err=_update_errors(got, want_trace, worst),
            update_worst=worst,
            largest_update=largest)

        if twin is not None:
            twin, twin_m = self.step_fn(twin, jb, step_rng)
            rec["noise_update_rel_err"] = _update_errors(
                state_dict_from_jax({"params": _np_tree(
                    twin.opt_state[2].trace)}), want_trace)
            rec["loss_noise"] = {k: float(v) for k, v in twin_m.items()}
            del twin
        if self.free is not None:
            self.noisy, _ = self.step_fn(self.noisy, jb, step_rng)
            train_step(self.free, tb, forward_train_draws(step_rng, 1))
            noisy = state_dict_from_jax({"params": _np_tree(
                self.noisy.params)})
            want = state_dict_from_jax({"params": _np_tree(
                self.jstate.params)})
            sums = {g: np.zeros(3) for g in GROUPS}
            for name, p in self.free.model.named_parameters():
                ref = want[name].double()
                s = sums[_group(name)]
                s[0] += float((p.detach().double() - ref).pow(2).sum())
                s[1] += float((noisy[name].double() - ref).pow(2).sum())
                s[2] += float(ref.pow(2).sum())
            rec["port_dist"] = {g: float(np.sqrt(s[0] / s[2]))
                                for g, s in sums.items()}
            rec["noise_dist"] = {g: float(np.sqrt(s[1] / s[2]))
                                 for g, s in sums.items()}
        self.it += 1
        return rec


def summarise(records):
    """Per group: the largest re-anchored update difference and the
    first iteration over UPDATE_TOL; the free-running distances at the
    end and their largest ratio (port over noise)."""
    out = {"iters": len(records), "update_tol": UPDATE_TOL, "groups": {}}
    for g in GROUPS:
        errs = [r["update_rel_err"][g] for r in records]
        over = [r["it"] for r in records if r["update_rel_err"][g] >
                UPDATE_TOL]
        row = dict(max_update_rel_err=max(errs),
                   at=records[int(np.argmax(errs))]["it"],
                   first_over_tol=over[0] if over else None,
                   n_over_tol=len(over))
        if "noise_update_rel_err" in records[-1]:
            noise = [r["noise_update_rel_err"][g] for r in records]
            row.update(noise_max_update_rel_err=max(noise),
                       noise_n_over_tol=sum(e > UPDATE_TOL for e in noise))
        if "port_dist" in records[-1]:
            ratio = [r["port_dist"][g] / r["noise_dist"][g]
                     for r in records if r["noise_dist"][g] > 0]
            row.update(port_dist_last=records[-1]["port_dist"][g],
                       noise_dist_last=records[-1]["noise_dist"][g],
                       max_port_over_noise=max(ratio) if ratio else None)
        out["groups"][g] = row
    out["iters_with_mask_positives"] = sum(
        1 for r in records if any(r["rcnn_positives"]))
    return out


def test_re_anchored_updates_match_jax(tmp_path):
    """RE_ANCHORED_ITERS iterations of the protocol's loop at a tiny
    geometry, cut budgets: each head's update from JAX's state within
    UPDATE_TOL of JAX's, on batches that include mask positives."""
    run = Lockstep(str(tmp_path), geometry=TINY, cut_budgets=True,
                   free_running=False)
    records = [run.step() for _ in range(RE_ANCHORED_ITERS)]
    assert any(any(r["rcnn_positives"]) for r in records), \
        "no batch with mask positives"
    for r in records:
        for g in HEADS:
            assert r["update_rel_err"][g] <= UPDATE_TOL, (r["it"], g, r)
        assert abs(r["loss_port"]["loss_mask"]
                   - r["loss_jax"]["loss_mask"]) <= 1e-5, r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--hours", type=float, default=1.0,
                   help="stop after the iteration that passes this")
    p.add_argument("--out", default=os.path.join(
        _REPO, "work_dirs", "trajectory", "trajectory.jsonl"))
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--state", default=None,
                   help="start from this port checkpoint's model state "
                        "(a torch.save of {'model': state_dict}) instead "
                        "of JAX's init: re-anchored steps and their noise "
                        "baseline only")
    p.add_argument("--full-width", action="store_true",
                   help="the flagship at its own widths, not narrow")
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    data = tempfile.TemporaryDirectory()
    if args.state:
        start = torch.load(args.state, map_location="cpu",
                           weights_only=True)["model"]
        run = Lockstep(data.name, full_width=args.full_width, start=start,
                       free_running=False)
    else:
        run = Lockstep(data.name, full_width=args.full_width)
    records = []
    with data, open(args.out, "w") as f:
        for _ in range(args.iters):
            rec = run.step()
            rec["seconds"] = time.perf_counter() - t0
            records.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if rec["seconds"] > args.hours * 3600:
                break
        summary = summarise(records)
        summary["seconds"] = time.perf_counter() - t0
        f.write(json.dumps({"summary": summary}) + "\n")
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
