"""The output check at a size a CPU test holds: the program passes; the
control (the reference with float8 operands in the program's place)
fails; a run whose timed path is broken underneath fails.  The run
skips the harness's look for a card and runs the rest as the command
does, on the CPU, under the limits the configuration files state."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import bench, run, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes(name):
    result, info = run(tiny_cell(name))
    assert result["correct"], result["checks"]
    assert all(d["replay_mismatch"] == 0 for d in info["diagnostics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    r = harness.Run(cell, "cpu")
    r.load(2**31 + 11)
    batch = r.pool[0]
    out, cap = harness.control_outputs(cell, r.state, batch, r.device)
    nums, _ = harness.reference_check(cell, r.state, [(batch, out, cap)],
                                      r.device)
    ok, checks = harness.judge(nums, cell.config["limits"], 0, 1)
    assert not ok, checks


def _alter_answer(run_obj):
    """A detection's box moved by 2 voxels where it is produced."""
    simple_test = run_obj.det.simple_test

    def broken(batch, mark=None):
        out = simple_test(batch, mark=mark)
        with torch.inference_mode():
            out["dets"][0, 0, :4] += 2.0
        return out

    run_obj.det.simple_test = broken


def _alter_mask(run_obj):
    """One detection's mask logits replaced by another's."""
    simple_test = run_obj.det.simple_test

    def broken(batch, mark=None):
        out = simple_test(batch, mark=mark)
        with torch.inference_mode():
            out["mask_logits"][0] = out["mask_logits"][1]
        return out

    run_obj.det.simple_test = broken


def _bypass_head(run_obj):
    """The first module the check reads runs outside its forward hooks,
    as a fused or graph-replayed head would."""
    for h in run_obj.capture.handles[:1]:
        h.remove()


def _nms_keeps_all(monkeypatch):
    """K1's scan keeps every valid row (no suppression)."""
    from mrcnn3d_torch.ops import nms3d

    monkeypatch.setattr(nms3d, "greedy_scan",
                        lambda boxes, valid, counts, thr: valid.clone())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["answer", "mask", "nms", "bypass"])
def test_broken_timed_path_fails(name, fault, monkeypatch):
    real_init = harness.Run.__init__

    def init(self, cell, device):
        real_init(self, cell, device)
        if fault == "answer":
            _alter_answer(self)
        elif fault == "mask":
            _alter_mask(self)
        elif fault == "bypass":
            _bypass_head(self)

    monkeypatch.setattr(harness.Run, "__init__", init)
    if fault == "nms":
        _nms_keeps_all(monkeypatch)
    result, info = run(tiny_cell(name))
    assert not result["correct"], result["checks"]
    if fault == "bypass":
        assert "rpn_head" in info["diagnostics"][0]["fault"]
