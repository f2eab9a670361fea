"""The learning protocol over several train seeds on one card, and the
rank test of its mask-quality oracle against the JAX package's runs.

Each seed is one `learning_bench` process in a work dir of its own
(`--parallel` of them at a time share the card; each takes
cores / parallel intra-op threads unless OMP_NUM_THREADS is set).  The
summary gives, per seed, the columns of the protocol's table (bbox mAP
dual and single pass, segm mAP and mAP@0.5, the oracle's mean, median
and share >= 0.5, train seconds and the loader's wait share) and the
means of its placement record (`mask_placement`); then, for the
oracle's mean, segm mAP@0.5 and the share >= 0.5, the exact one-sided
rank test of the reference runs (default: the JAX package's LEARNING.json and
LEARNING_seed2025.json) ranking above the port's seeds.

    python -m mrcnn3d_torch.tools.learning_seeds --seeds 2024 2025 ...
        --out DIR [--parallel 4] [--iters 1600] [--config PATH]
        [--workroot DIR] [--device cuda|cpu] [--reference A.json ...]
        [--synthetic] [--summary-only]

DIR receives LEARNING_torch_<seed>.json, log_<seed>.txt and
summary.json.  `--summary-only` rebuilds summary.json from the
artifacts already in DIR.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from .learning_bench import REPO

REFERENCES = (os.path.join(REPO, "LEARNING.json"),
              os.path.join(REPO, "LEARNING_seed2025.json"))
# the statistics the rank test reads: (name, getter)
TESTED = (
    ("oracle_mean", lambda r: r["mask_quality"]["mean"]),
    ("segm_mAP_0.5", lambda r: r["segm_stats"]["segm_mAP_0.5"]),
    ("frac_ge_50", lambda r: r["mask_quality"]["frac_ge_50"]),
)


def rank_p_value(ref, port):
    """Exact one-sided p of the rank-sum test: the chance, with every
    value drawn from one distribution, that the reference values' rank
    sum among all of them is at least the observed one (ranks ascending,
    ties at their mean rank)."""
    allv = sorted(ref + port)

    def rank(v):
        lo = allv.index(v)
        hi = len(allv) - allv[::-1].index(v)
        return (lo + 1 + hi) / 2.0

    ranks = [rank(v) for v in ref + port]
    observed = sum(ranks[:len(ref)])
    combos = list(itertools.combinations(range(len(ranks)), len(ref)))
    hits = sum(1 for c in combos
               if sum(ranks[i] for i in c) >= observed - 1e-9)
    return hits / len(combos)


def row_of(rec):
    """One seed's table row from its learning_bench artifact."""
    q = rec.get("mask_quality", {})
    port = rec.get("port", {})
    loop = port.get("train_loop_s")
    wait = port.get("loader_wait_s")
    row = dict(
        seed=rec["protocol"]["train_seed"],
        bbox_mAP=rec["stats"].get("bbox_mAP"),
        bbox_mAP_single=rec["stats_single_pass"].get("bbox_mAP"),
        segm_mAP=rec["segm_stats"].get("segm_mAP"),
        segm_mAP_50=rec["segm_stats"].get("segm_mAP_0.5"),
        oracle_mean=q.get("mean"), oracle_median=q.get("median"),
        frac_ge_50=q.get("frac_ge_50"),
        train_s=rec.get("train_seconds"),
        loader_wait_share=(wait / loop if wait is not None and loop
                           else None),
        data_matches_pinned=rec.get("data_matches_pinned"),
    )
    s = rec.get("placement")
    if s:
        for k in ("vol_ratio", "dz", "dy", "dx", "ez", "ey", "ex", "fill",
                  "gt_fill", "box_iou"):
            if k in s:
                row[k + "_mean"] = s[k]["mean"]
        row["vol_ratio_geomean"] = s.get("vol_ratio_geomean")
    return row


def summary(out_dir, seeds, references):
    rows, recs = [], []
    for s in seeds:
        path = os.path.join(out_dir, f"LEARNING_torch_{s}.json")
        if not os.path.exists(path):
            rows.append(dict(seed=s, missing=True))
            continue
        with open(path) as f:
            rec = json.load(f)
        recs.append(rec)
        rows.append(row_of(rec))
    refs = []
    for path in references:
        with open(path) as f:
            refs.append(json.load(f))
    tests = {}
    for name, get in TESTED:
        ref = [float(get(r)) for r in refs]
        port = [float(get(r)) for r in recs]
        if not port:
            continue
        above = [sum(1 for v in port if v >= x) for x in sorted(ref)]
        tests[name] = dict(reference=ref, port=port,
                           p=rank_p_value(ref, port),
                           port_at_or_above_each_reference=above)
        tests[name]["verdict"] = ("systematic" if tests[name]["p"] <= 0.05
                                  else "within seed noise")
    out = dict(rows=rows, rank_tests=tests,
               references=[os.path.relpath(p, REPO) for p in references])
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def run_seed(seed, args, threads):
    work = os.path.join(args.workroot, str(seed))
    log = os.path.join(args.out, f"log_{seed}.txt")
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", str(threads))
    extra = ["--synthetic"] if args.synthetic else []
    cmd = [sys.executable, "-m", "mrcnn3d_torch.tools.learning_bench",
           "--train-seed", str(seed), "--iters", str(args.iters),
           "--workdir", work, "--config", args.config, "--device",
           args.device, "--json-out",
           os.path.join(args.out, f"LEARNING_torch_{seed}.json")] + extra
    with open(log, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            env=env, cwd=REPO).returncode
    return seed, rc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--parallel", type=int, default=1)
    p.add_argument("--iters", type=int, default=1600)
    p.add_argument("--config", default=os.path.join(
        REPO, "configs", "mask_rcnn_3d_2scales.py"))
    p.add_argument("--workroot", default=os.path.join(
        REPO, "work_dirs", "learning_seeds"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--reference", nargs="+", default=list(REFERENCES))
    p.add_argument("--synthetic", action="store_true",
                   help="the learning bench's small generated set (smoke "
                        "runs)")
    p.add_argument("--summary-only", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failed = []
    if not args.summary_only:
        threads = max(1, (os.cpu_count() or 1) // max(args.parallel, 1))
        with ThreadPoolExecutor(args.parallel) as pool:
            for seed, rc in pool.map(lambda s: run_seed(s, args, threads),
                                     args.seeds):
                print(f"seed {seed}: rc {rc}", flush=True)
                if rc:
                    failed.append(seed)
    out = summary(args.out, args.seeds, args.reference)
    for r in out["rows"]:
        print(json.dumps(r))
    print(json.dumps(out["rank_tests"]))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
