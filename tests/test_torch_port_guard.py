"""The port stands alone: it imports neither JAX nor the JAX package
(its training modules included), and its entry points never fall back to
the CPU on its own."""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    sys.modules["mrcnn3d"] = None
    import torch
    import mrcnn3d_torch
    names = [m.name for m in pkgutil.walk_packages(
        mrcnn3d_torch.__path__, "mrcnn3d_torch.")]
    for name in names:
        importlib.import_module(name)
    from mrcnn3d_torch.entry import build
    det = build(device="cpu")
    assert det.model.num_scales == 2 and det.model.with_refinement_mask
    assert next(det.model.parameters()).device.type == "cpu"
    for name in ("core.targets", "ops.losses", "train.optim", "train.step",
                 "train.checkpoint"):
        assert "mrcnn3d_torch." + name in names, name
    import chip_smoke
    from mrcnn3d_torch.entry import build_trainer
    trainer = build_trainer(chip_smoke.small_train_config(), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in chip_smoke.small_train_batch(3).items()}
    losses = trainer.step(batch)
    assert trainer.state.step == 1 and len(losses) == 11
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    torch.cuda.is_available = lambda: False
    for entry in (build, build_trainer):
        try:
            entry(device=None)
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"{entry.__name__}(device=None) ran "
                                 "without CUDA")
    print(len(names), "modules")
    """
)


def test_port_imports_and_builds_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 21, proc.stdout


def test_no_jax_import_lines():
    """No module of the port, nor chip_smoke.py, names JAX, flax or the
    JAX package in an import statement."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mrcnn3d)(\.|\s|$)")
    files = [*sorted((REPO / "mrcnn3d_torch").rglob("*.py")),
             REPO / "chip_smoke.py"]
    bad = [
        f"{f.relative_to(REPO)}:{i}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pat.match(line)
    ]
    assert not bad, bad
