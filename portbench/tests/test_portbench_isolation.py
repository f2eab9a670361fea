"""The isolation check compares top-level module names whole."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.isolation import forbidden_loaded
from portbench.tests.tiny import ROOT


def test_catches_jax_and_the_jax_package_whole():
    assert forbidden_loaded(["jax", "jax.numpy", "os"]) == ["jax"]
    assert forbidden_loaded(["mrcnn3d.ops.nms3d"]) == ["mrcnn3d"]
    assert forbidden_loaded(["jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jaxlib"]


def test_passes_the_port_and_lookalikes():
    assert forbidden_loaded(["mrcnn3d_torch", "mrcnn3d_torch.entry",
                             "jaxtyping", "mrcnn3dx"]) == []


def test_a_run_loads_neither():
    code = ("import sys, json, portbench.run, portbench.harness, "
            "mrcnn3d_torch.entry; from portbench.isolation import "
            "forbidden_loaded; print(json.dumps(forbidden_loaded()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "flagship-infer-pair", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
