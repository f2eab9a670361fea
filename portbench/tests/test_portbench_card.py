"""On the card, each cell at its own size: the program's checked
requests pass their limits and the control fails them.  Skips without a
card (the kernels have no CPU mode).  Run from the checkout's root:

    python3 -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import ROOT, bench

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_at_size_program_passes_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    cell = harness.Cell(bench(), name, root=ROOT)
    run = harness.Run(cell, "cuda")
    run.load(2**31 + 101)
    run.warm_up()
    rec = run.window(2.0)
    checked = [(run.pool[i], o, c) for i, o, c in rec["checked"]]
    nums, _ = harness.reference_check(cell, run.state, checked, run.device)
    ok, checks = harness.judge(nums, cell.config["limits"], rec["failed"],
                               len(checked))
    assert ok, checks
    batch = checked[0][0]
    out, cap = harness.control_outputs(cell, run.state, batch, run.device)
    nums, _ = harness.reference_check(cell, run.state, [(batch, out, cap)],
                                      run.device)
    ok, checks = harness.judge(nums, cell.config["limits"], 0, 1)
    assert not ok, checks
