"""The learning protocol's comparison with the JAX package, as scripts
(the JAX package on the CPU; results as one JSON line on stdout and in
--out).  The tier-1 test of the same scoring is
`test_torch_port_learning_eval.py`.

    JAX_PLATFORMS=cpu python tests/torch_port_learning_scripts.py \\
        score STATE.pt --workdir DIR [--out PATH]
    JAX_PLATFORMS=cpu python tests/torch_port_learning_scripts.py \\
        jax-narrow --seed 2024 [--iters 400] --workdir DIR [--out PATH]

`score`: a trained port state (STATE.pt: `torch.save({"model":
state_dict})`, any float dtype) scored by both packages on the pinned
val set at the protocol's geometry and budgets, with each package's
placement record (`mrcnn3d_torch.tools.mask_placement`).
`jax-narrow`: the JAX package's narrow flagship (`narrow_cfg`) trained
on the pinned data by its own `train_detector`, then scored by its
evaluation body (about 5 s an iteration on 6 cores).  Neither writes
the tracked LEARNING.json.

    JAX_PLATFORMS=cpu python tests/torch_port_learning_scripts.py \\
        tie-replay STATE.pt --step 2 --threads 4 --workdir DIR

`tie-replay`: from a trained port state at full width, JAX's
re-anchored steps up to --step, then the port's step there as it runs
and with the relu unit behind its largest update difference flipped
(`tie_replay`; about 6 minutes on 8 cores).  --threads sets the port's
intra-op threads, which decide its float32 rounding and so which way a
tie falls.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(_TESTS), _TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from mrcnn3d.data.coco3d import Coco3D2ScalesDataset as JDataset  # noqa
from mrcnn3d_torch.eval.coco_eval3d import CocoEval3D  # noqa: E402
from mrcnn3d_torch.tools import learning_bench as lb  # noqa: E402
from mrcnn3d_torch.tools.mask_placement import (  # noqa: E402
    placement_rows,
    summarize,
)
from test_torch_port_learning_eval import jax_evaluation  # noqa: E402


def _record(stats, single, segm, rows):
    """One package's scores, oracle and placement summary, under the keys
    of a `learning_bench` artifact (so that `learning_seeds --reference`
    can rank against it)."""
    best = np.array([r["iou"] for r in rows])

    def floats(d):
        return {k: float(v) for k, v in d.items()}
    return dict(
        stats=floats(stats), stats_single_pass=floats(single),
        segm_stats=floats(segm),
        mask_quality=dict(n_gt=int(best.size), mean=float(best.mean()),
                          median=float(np.median(best)),
                          frac_ge_50=float((best >= 0.5).mean())),
        placement=summarize(rows))


def _jax_rows(ann_va, sentries):
    """The placement rows of the JAX package's segm entries, measured by
    the port's evaluator on the same gt."""
    with open(ann_va) as f:
        coco = json.load(f)
    return placement_rows(CocoEval3D(coco, sentries, iou_type="segm"))


def score_state(state_path, workdir):
    """A trained port state scored by both packages: the port's
    evaluate_protocol against the JAX package's evaluation body on the
    converted weights."""
    from mrcnn3d.compat.torch_convert import convert_state_dict
    from mrcnn3d.detectors.build import build_detector as j_build
    from mrcnn3d.utils.config import Config as JConfig
    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.utils.config import Config as TConfig

    sd = {k: v.float() for k, v in torch.load(
        state_path, map_location="cpu", weights_only=True)["model"].items()}
    _, _, _, ann_va, dir_va, ann_va2, dir_va2 = lb.generate_pinned_data(
        workdir, 1.5)
    tcfg = TConfig.fromfile(lb.CONFIG)
    tmodel = build(tcfg, device="cpu").model
    tmodel.load_state_dict(sd, strict=True)
    passes = {}
    stats, single, segm, _ = lb.evaluate_protocol(
        tcfg, tmodel, ann_va, dir_va, ann_va2, dir_va2, passes=passes)
    rows = placement_rows(passes["segm_eval"])

    jcfg = JConfig.fromfile(lb.CONFIG)
    params, bstats = convert_state_dict(
        sd, channels=jcfg.model["neck"]["out_channels"])
    got = jax_evaluation(jcfg, j_build(jcfg), {"params": params,
                                               "batch_stats": bstats},
                         ann_va, dir_va, ann_va2, dir_va2)
    jrows = _jax_rows(ann_va, got[5])
    return dict(port=_record(stats, single, segm, rows),
                jax=_record(*got[:3], jrows),
                largest_iou_difference=max(
                    abs(a["iou"] - b["iou"]) for a, b in zip(rows, jrows)))


def train_jax_narrow(seed, iters, workdir):
    """The JAX package's narrow flagship trained for `iters` iterations
    from `seed` and scored, with the placement record of its pass-1
    masks."""
    from mrcnn3d.apis.train_api import train_detector
    from mrcnn3d.detectors.build import build_detector as j_build
    from mrcnn3d.train import checkpoint as jckpt
    from mrcnn3d.utils.config import Config as JConfig
    from test_torch_port_models import narrow_cfg

    cfg = narrow_cfg(JConfig)
    cfg.work_dir = workdir
    (data_hash, ann_tr, dir_tr, ann_va, dir_va, ann_va2,
     dir_va2) = lb.generate_pinned_data(workdir, 1.5)
    tr = cfg.data["train"]
    ds = JDataset(ann_tr, dir_tr, upscale_factor=1.5,
                  img_norm_cfg=tr["img_norm_cfg"],
                  size_divisor=tr.get("size_divisor", 32), with_mask=True,
                  max_gt=16, extra_aug=tr.get("extra_aug"), seed=seed)
    t0 = time.time()
    train_detector(cfg, ds, work_dir=workdir, seed=seed, max_iters=iters,
                   mesh=None, log_interval=20)
    train_s = time.time() - t0
    restored = jckpt.restore_params(jckpt.make_manager(workdir))
    variables = {"params": restored["params"]}
    if restored["batch_stats"]:
        variables["batch_stats"] = restored["batch_stats"]
    got = jax_evaluation(cfg, j_build(cfg), variables, ann_va, dir_va,
                         ann_va2, dir_va2)
    return dict(seed=seed, iters=int(restored["step"]), train_s=train_s,
                data_matches_pinned=data_hash == lb.PINNED_SHA256,
                **_record(*got[:3], _jax_rows(ann_va, got[5])))


def tie_replay(state_path, step, workdir):
    """Re-anchored steps 0..`step` from a trained port state at full
    width (`Lockstep`, JAX's steps only before `step`), then the port's
    step `step` from JAX's state, twice: as it runs, and with the one
    relu unit that sets its largest update difference flipped to the
    other branch (`chip_smoke.ReluBranches`, the flip proven a tie by
    `check_relu_ties`).  The unit is found from the worst parameter's
    difference against JAX's update: a linear layer's weight whose
    difference is one output unit times one row's input."""
    import tempfile

    import jax
    from torch import nn

    from chip_smoke import ReluBranches, TIE_TOL, check_relu_ties
    from mrcnn3d_torch.compat.jax_weights import (
        load_train_state,
        state_dict_from_jax,
    )
    from mrcnn3d_torch.train.step import train_step
    from test_torch_port_targets import forward_train_draws
    from test_torch_port_trajectory import Lockstep, _np_tree, \
        _update_errors

    start = torch.load(state_path, map_location="cpu",
                       weights_only=True)["model"]
    data = tempfile.TemporaryDirectory(dir=workdir)
    run = Lockstep(data.name, full_width=True, start=start,
                   free_running=False)
    run.baseline = False
    for _ in range(step + 1):
        jb, tb, _ = run._batch()
        run.rng, step_rng = jax.random.split(run.rng)
        before = _np_tree(run.jstate.params)
        trace = _np_tree(run.jstate.opt_state[2].trace)
        run.jstate, _ = run.step_fn(run.jstate, jb, step_rng)
        run.it += 1
    want = state_dict_from_jax({"params": _np_tree(
        run.jstate.opt_state[2].trace)})
    model = run.anchored.model

    def port(take=None):
        load_train_state(run.anchored, before, run.batch_stats, trace, step)
        calls = {}

        def hook(mod, inp, out, name):
            calls.setdefault(name, []).append(
                (len(relus.branches), inp[0].detach().clone(),
                 out.detach().clone()))
        hooks = [m.register_forward_hook(
                     lambda mod, i, o, n=n: hook(mod, i, o, n))
                 for n, m in model.named_modules()
                 if isinstance(m, nn.Linear)]
        try:
            with ReluBranches(take) as relus:
                train_step(run.anchored, tb,
                           forward_train_draws(step_rng, 1))
        finally:
            for h in hooks:
                h.remove()
        opt = run.anchored.optimizer.state
        got = {n: opt[p]["momentum_buffer"].clone()
               for n, p in model.named_parameters()}
        return got, relus, calls

    got, relus, calls = port()
    rel = {n: float((got[n] - w).abs().max() / w.abs().max())
           for n, w in want.items() if float(w.abs().max())}
    worst = max(rel, key=rel.get)
    module = worst.rsplit(".", 1)[0]
    if not worst.endswith(".weight") or module not in calls:
        raise SystemExit(f"the worst parameter {worst} is not a linear "
                         "layer's weight")
    u, sv, v = torch.linalg.svd((got[worst] - want[worst]).double(),
                                full_matrices=False)
    unit = int(u[:, 0].abs().argmax())
    best = None
    for call, x, h in calls[module]:
        cos = (x.double() @ v[0]).abs() / (x.double().norm(dim=1)
                                           * v[0].norm() + 1e-300)
        row = int(cos.argmax())
        if best is None or cos[row] > best[0]:
            best = (float(cos[row]), call, row, h)
    cos, call, row, h = best
    take = [b.clone() for b in relus.branches]
    take[call][row, unit] = ~take[call][row, unit]
    got2, relus2, _ = port(take)
    check_relu_ties(relus2.ties, "tie replay")
    return dict(
        step=step, threads=torch.get_num_threads(), worst=worst,
        worst_rel_err=rel[worst],
        singular_values=[float(x) for x in sv[:3]],
        unit=unit, unit_share_of_left_vector=float(u[unit, 0].abs()),
        row=row, row_input_cosine=cos,
        unit_input=float(h[row, unit]),
        call_max_abs_input=float(h.abs().max()), tie_tol=TIE_TOL,
        port_branch_on=bool(relus.branches[call][row, unit]),
        ties_replayed=relus2.ties,
        update_rel_err=_update_errors(got, want),
        update_rel_err_replayed=_update_errors(got2, want),
        worst_rel_err_replayed=float(
            (got2[worst] - want[worst]).abs().max()
            / want[worst].abs().max()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("score", "jax-narrow", "tie-replay"))
    p.add_argument("state", nargs="?")
    p.add_argument("--seed", type=int, default=lb.TRAIN_SEED)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--workdir", required=True)
    p.add_argument("--step", type=int, default=2)
    p.add_argument("--threads", type=int, default=None,
                   help="the port's intra-op threads (its rounding)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.what == "score":
        rec = score_state(args.state, args.workdir)
    elif args.what == "tie-replay":
        rec = tie_replay(args.state, args.step, args.workdir)
    else:
        rec = train_jax_narrow(args.seed, args.iters, args.workdir)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
