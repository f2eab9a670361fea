"""The output check over many seeds in one process, at a cell's own size
and load: per seed, the program's short window and its checked requests
against the reference; and the control (the reference with float8
operands, in the program's place) on the window's first request.  The
readings that the limits in `configs/<config>.json` are set from.

    python3 -m portbench.sweep --workload flagship-infer-pair \
        --seeds 1401893404 11 12 --seconds 6 [--out chiprun_out/x.jsonl]

One JSON line a seed: the program's numbers, the control's, and the
diagnostics.  Needs a card, as the benchmark does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("portbench.sweep: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json("BENCHMARK.json"), args.workload)
    run = harness.Run(cell, "cuda")
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        run.load(seed)
        run.warm_up()
        rec = run.window(args.seconds)
        checked = [(run.pool[i], o, c) for i, o, c in rec["checked"]]
        nums, diag = harness.reference_check(cell, run.state, checked,
                                             run.device)
        line = dict(workload=cell.name, seed=seed, program=nums,
                    diagnostics=diag, requests=len(rec["latency_s"]),
                    failed=rec["failed"])
        batch = run.pool[rec["checked"][0][0]]
        c_out, c_cap = harness.control_outputs(cell, run.state, batch,
                                               run.device)
        line["control"], line["control_diagnostics"] = \
            harness.reference_check(cell, run.state,
                                    [(batch, c_out, c_cap)], run.device)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
