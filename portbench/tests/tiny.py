"""A cell of BENCHMARK.json at a size a CPU test can hold: the
configuration at its published widths, a 8x32x32 volume (12x48x48
twin), budgets of 8 rows, a pool of 2; limits as the configuration
file states them."""
from __future__ import annotations

import os
import time

import torch

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPE = (8, 32, 32)
BUDGET = 8


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_cell(name):
    cell = harness.Cell(bench(), name, root=ROOT)
    test = cell.cfg["test_cfg"]
    for k in ("nms_pre", "nms_post", "max_num"):
        test["rpn"][k] = BUDGET
    test["rcnn"]["max_per_img"] = BUDGET
    vol = cell.mix["volume"]
    vol["shape"] = list(SHAPE)
    vol["texture"]["coarse"] = [2, 4, 4]
    vol["foci"]["count"] = 2
    cell.mix["pool"] = 2
    return cell


def run(cell, seed=2**31 + 7, seconds=1.0):
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            time.perf_counter())
