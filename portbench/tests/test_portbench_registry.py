"""The harness finds every cell, configuration, mix, reference and metric
by name, the reference mirrors the program's modules, and a run's last
line has the contract's keys."""
from __future__ import annotations

import os

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import ROOT, bench, run, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.Cell(bench(), name, root=ROOT)
    assert cell.cfg["model"]["type"]
    for attr in ("make_pool", "order", "request"):
        assert callable(getattr(cell.kind, attr)), attr
    for attr in ("capture", "Detector", "anchors", "infer", "check",
                 "flop_plan"):
        assert hasattr(cell.reference, attr), attr
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    for m in cell.end_to_end:
        assert callable(harness.reader("e2e_metrics", m["name"]))
    for m in cell.per_layer:
        assert callable(harness.reader("layer_metrics", m["name"]))
    assert set(cell.config["limits"]), "the configuration states limits"


def test_every_file_named_exists():
    b = bench()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        mix = os.path.join(ROOT, "portbench", "traffic",
                           w["traffic"] + ".json")
        assert os.path.isfile(mix)
        kind = harness.load_json(mix)["kind"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "kinds",
                                           kind + ".py"))


@pytest.mark.parametrize("name", CELLS)
def test_reference_mirrors_program(name):
    from mrcnn3d_torch.entry import build

    cell = harness.Cell(bench(), name, root=ROOT)
    det = build(harness.program_config(cell.cfg), device="cpu",
                dtype=torch.bfloat16)
    with torch.device("meta"):
        ref = cell.reference.Detector(cell.cfg)
    mine = {k: tuple(v.shape) for k, v in det.model.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert mine == theirs
    for n in cell.reference.capture(cell.cfg):
        det.model.get_submodule(n)


def test_result_line_has_the_contract_keys():
    result, info = run(tiny_cell(CELLS[0]))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    assert set(result["metrics"]) == {"volumes_per_s", "latency_p95_ms",
                                      "setup_s"}  # no peak memory on a CPU
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert result["attempted"] >= 1 and info["compared_requests"][0] == 0
