"""The plain reference imports nothing of the program, nor JAX."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench.tests.tiny import ROOT

REF = os.path.join(ROOT, "portbench", "reference")
ALLOWED = {"__future__", "math", "numpy", "torch"}


def test_reference_sources_import_only_torch_and_numpy():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: inside the reference
                    continue
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ALLOWED, (name, m)


def test_importing_the_reference_loads_no_port_code():
    code = ("import sys, json; import portbench.reference.two_stage, "
            "portbench.reference.cascade; print(json.dumps(sorted({m.split("
            "'.')[0] for m in sys.modules} & {'mrcnn3d_torch', 'mrcnn3d', "
            "'jax'})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
