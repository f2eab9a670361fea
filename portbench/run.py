"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 -m portbench.run --workload flagship-infer-pair --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints, last on standard output, one JSON line: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, breakdown (--trace 1) and
checks (each number compared with the reference, with its limit, also
the last lines of standard error).  Exits non-zero, with no result,
without CUDA or enough cards, or if the JAX package or JAX was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from . import harness, isolation

    bench = harness.load_json("BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    need = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, info = harness.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_PROCESS)
    found = isolation.forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(info), flush=True)
    for d in info["diagnostics"]:
        if "fault" in d:
            print(f"portbench: {d['fault']}", file=sys.stderr)
    for name, c in result["checks"].items():
        mark = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {mark}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
