"""The 3-D leftovers (ROADMAP A12) against the JAX package, on the CPU.

  * `backbone.with_cp` (JAX: `remat`, `mrcnn3d/detectors/build.py:137`,
    `mrcnn3d/models/resnet3d.py:344-345`): ResNet3D's blocks recompute
    their activations in the backward pass, the gradients equal to the
    plain pass's (a basic and a bottleneck ResNet3D) and within 2e-3 of
    JAX's remat gradients (2e-2 for the stem conv under its max-pool,
    `chip_smoke.JAX_UPDATE_TOL`); ResNeXt3D and UNet3D ignore it, as in
    JAX;
  * reference checkpoints (`compat/reference_ckpt.py` against
    `load_torch_checkpoint` + `merge_into_variables`): a Runner-wrapped,
    `module.`-prefixed .pth of the narrow flagship, with BN counters and
    a projection key the loaders skip, loaded into each package: equal
    `simple_test` outputs (valid and labels equal, the rest within
    2e-3); a backbone-only file leaves the heads as they were; an
    unknown key and a shape mismatch raise in both;
  * `bbox_overlaps_3d(mode="iof")` and `bbox_overlaps_aligned_3d`
    against JAX's (`mrcnn3d/ops/box3d.py:132-172`), 1e-5;
  * `mrcnn3d_torch/tools/slurm_{train,test}.sh` against a fake `srun` on
    PATH that records its arguments and runs the command it was given
    (`--help`), beside the JAX package's scripts.
"""
import functools
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (
    JAX_UPDATE_TOL,
    SMALL_BUDGET,
    SMALL_SHAPES,
    compare_outputs,
    small_inputs,
    small_run,
)
from mrcnn3d.compat.torch_convert import (
    load_torch_checkpoint,
    merge_into_variables,
)
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.models.resnet3d import ResNet3D as JResNet3D
from mrcnn3d.ops import box3d as jbox
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.compat.reference_ckpt import (
    load_reference_checkpoint,
    merge,
    reference_state_dict,
)
from mrcnn3d_torch.detectors.build import build_detector, detector_flags
from mrcnn3d_torch.entry import Flagship
from mrcnn3d_torch.models.resnet3d import ResNet3D
from mrcnn3d_torch.ops import box3d as tbox
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_models import _randomise, jax_flagship, narrow_cfg
from torch_port_fixtures import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-3

# ---------------------------------------------------------------------------
# with_cp
# ---------------------------------------------------------------------------


def _count_forwards(block):
    """Counts the block's forward runs (the recomputation included, which
    runs no module hooks) in the returned list."""
    calls, forward = [], block.forward

    def counted(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)

    block.forward = counted
    return calls


def _backbone_grads(model, x):
    """{parameter: gradient} of the stage outputs' weighted sum, and how
    often the first block of layer1 ran forward."""
    calls = _count_forwards(model.layer1[0])
    model.zero_grad(set_to_none=True)
    outs = model(x)
    sum(o.sum() * (i + 1) for i, o in enumerate(outs)).backward()
    del model.layer1[0].forward
    return {n: p.grad.clone() for n, p in model.named_parameters()}, \
        len(calls)


@pytest.mark.parametrize("depth", [18, 50])
def test_with_cp_recomputes_blocks_with_equal_gradients(depth):
    """with_cp: each block runs forward again in the backward pass (two
    calls of layer1's first block, one without), the gradients equal to
    the plain pass's; outside autograd it is a plain forward."""
    torch.manual_seed(0)
    plain = ResNet3D(depth=depth, base_width=4)
    cp = ResNet3D(depth=depth, base_width=4, with_cp=True)
    cp.load_state_dict(plain.state_dict())
    x = torch.randn(1, 3, 8, 32, 32,
                    generator=torch.Generator().manual_seed(1))
    g_plain, n_plain = _backbone_grads(plain, x)
    g_cp, n_cp = _backbone_grads(cp, x)
    assert (n_plain, n_cp) == (1, 2)
    for name, g in g_plain.items():
        torch.testing.assert_close(g_cp[name], g, rtol=0, atol=0)
    calls = _count_forwards(cp.layer1[0])
    with torch.no_grad():
        cp(x)
    assert calls == [1]


def test_with_cp_gradients_match_jax_remat():
    """The port's with_cp gradients against JAX's remat ResNet3D-50's."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 3, 8, 32, 32).astype(np.float32)
    jm = JResNet3D(depth=50, base_width=4, remat=True)
    jx = jnp.asarray(np.transpose(x, (0, 2, 3, 4, 1)))
    v = _randomise(jax.jit(jm.init)(jax.random.PRNGKey(0), jx), rng)

    def loss(params):
        outs = jm.apply({"params": params,
                         "batch_stats": v["batch_stats"]}, jx)
        return sum(o.sum() * (i + 1) for i, o in enumerate(outs))

    jg = jax.jit(jax.grad(loss))(v["params"])
    want = state_dict_from_jax({"params": {"backbone": jax.tree.map(
        np.asarray, jg), "neck": {}}})
    model = ResNet3D(depth=50, base_width=4, with_cp=True)
    sd = state_dict_from_jax({"params": {"backbone": v["params"],
                                         "neck": {}},
                              "batch_stats": {"backbone":
                                              v["batch_stats"]}})
    model.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()})
    got, runs = _backbone_grads(model, torch.from_numpy(x))
    assert runs == 2
    for name, w in want.items():
        w = w.numpy()
        tol = JAX_UPDATE_TOL.get(name, ATOL) * float(np.abs(w).max())
        np.testing.assert_allclose(got[name[len("backbone."):]].numpy(), w,
                                   rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("backbone", ["ResNet3D", "ResNeXt3D", "UNet3D"])
def test_with_cp_read_from_config_for_resnet3d_only(backbone):
    """The builder reads backbone.with_cp (no new key) and hands it to
    ResNet3D alone, as the JAX package hands `remat` to ResNet3D alone
    (`mrcnn3d/models/detector.py:107-125`)."""
    cfg = narrow_cfg(TConfig)
    cfg.model["backbone"].update(type=backbone, with_cp=True)
    assert detector_flags(cfg)["with_cp"]
    model = build_detector(cfg, device="cpu", train=True)
    assert getattr(model.backbone, "with_cp", False) == (
        backbone == "ResNet3D")


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------


def _budgets(cfg):
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.test_cfg["rpn"][k] = SMALL_BUDGET
    cfg.test_cfg["rcnn"]["max_per_img"] = SMALL_BUDGET
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


def _write_reference(path, state, bn_counters=True):
    """A reference-style .pth: the Runner's {"state_dict", "meta"}, every
    key under `module.` (DataParallel), BatchNorm3d's
    num_batches_tracked beside each BN's statistics, and one of the
    reference backbone's projection keys."""
    sd = {}
    for k, v in state.items():
        sd[f"module.{k}"] = v
        if bn_counters and k.endswith(".running_var"):
            sd[f"module.{k[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(7)
    sd["module.backbone.projection_original_features.0.weight"] = \
        torch.zeros(4, 4)
    torch.save({"state_dict": sd, "meta": {"epoch": 3}}, path)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(jitted simple_test, the narrow flagship's fresh variables of
    seed 1, the reference state of seed 0's randomised variables)."""
    jcfg, jmodel, variables = jax_flagship(seed=0)
    _, _, fresh = jax_flagship(seed=1)
    _budgets(jcfg)
    sets = []
    for (d, h, w), ac in zip(SMALL_SHAPES, j_anchor_cfgs(jcfg)):
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set([f.shape[1:4] for f in feats],
                                         (h, w, 3, d), ac))
    jrun = jax.jit(lambda v, b: jpl.simple_test(jmodel, v, b, jcfg, sets))
    return jrun, fresh, state_dict_from_jax(variables)


def _port(seed=1):
    cfg = _budgets(narrow_cfg(TConfig))
    return Flagship(cfg, build_detector(cfg, device="cpu", seed=seed),
                    torch.device("cpu"))


def test_reference_checkpoint_replays_in_both_packages(tmp_path):
    jrun, fresh, state = _jax_run()
    path = str(tmp_path / "epoch_3.pth")
    _write_reference(path, state)
    params, stats = load_torch_checkpoint(path, channels=8)
    jvars = merge_into_variables(fresh, params, stats)
    det = _port()
    left = load_reference_checkpoint(det.model, path)
    assert left == []
    batch = small_inputs(7, False)
    got = small_run(det, batch)
    jb = {k: jnp.asarray(np.transpose(v, (0, 2, 3, 4, 1)))
          for k, v in batch.items()}
    want = jax.tree.map(np.asarray, jrun(jvars, jb))
    want["labels"] = want["labels"].astype(got["labels"].dtype)
    assert int(got["valid"].sum()) > 4, "vacuous case"
    compare_outputs(got, want, ATOL, "reference checkpoint, port vs JAX")
    # the port's load is exact: the same weights as the bridged state
    sd = det.model.state_dict()
    for k, v in state.items():
        assert torch.equal(sd[k], v), k


def test_backbone_only_checkpoint_leaves_the_heads(tmp_path):
    """A backbone-only pretrain: the backbone takes the file's values,
    every other key keeps its value and is reported."""
    _, _, state = _jax_run()
    path = str(tmp_path / "backbone.pth")
    _write_reference(path, {k: v for k, v in state.items()
                            if k.startswith("backbone.")})
    det = _port()
    before = {k: v.clone() for k, v in det.model.state_dict().items()}
    left = load_reference_checkpoint(det.model, path)
    after = det.model.state_dict()
    assert left == sorted(k for k in before if not k.startswith("backbone."))
    for k, v in after.items():
        want = state[k] if k.startswith("backbone.") else before[k]
        assert torch.equal(v, want), k


def test_unwrapping_and_skipped_keys(tmp_path):
    """`state_dict`, then `model_state_dict`, else the file itself;
    `module.` stripped; BN counters and projection keys dropped."""
    _, _, state = _jax_run()
    small = {k: v for k, v in list(state.items())[:6]}
    for wrap in ("state_dict", "model_state_dict", None):
        path = str(tmp_path / f"{wrap}.pth")
        sd = {f"module.{k}": v for k, v in small.items()}
        sd["module.backbone.bn1.num_batches_tracked"] = torch.tensor(1)
        sd["connect_patches_feature.weight"] = torch.zeros(2)
        torch.save({wrap: sd} if wrap else sd, path)
        got = reference_state_dict(path)
        assert sorted(got) == sorted(small)


@pytest.mark.parametrize("case", ["unknown", "shape"])
def test_bad_checkpoint_raises_in_both(tmp_path, case):
    """A key the model lacks (a second bbox head on the shared-head
    flagship) raises KeyError, a shape that differs ValueError, in both
    packages, and the port writes nothing first."""
    jrun, fresh, state = _jax_run()
    bad = dict(state)
    if case == "unknown":
        bad["bbox_head_2.shared_fcs.0.weight"] = \
            state["bbox_head.shared_fcs.0.weight"]
        bad["bbox_head_2.shared_fcs.0.bias"] = \
            state["bbox_head.shared_fcs.0.bias"]
        err = KeyError
    else:
        bad["rpn_head.rpn_cls.weight"] = torch.zeros(2, 8, 1, 1, 1)
        err = ValueError
    path = str(tmp_path / "bad.pth")
    _write_reference(path, bad)
    with pytest.raises(err):
        merge_into_variables(fresh, *load_torch_checkpoint(path, channels=8))
    det = _port()
    before = {k: v.clone() for k, v in det.model.state_dict().items()}
    with pytest.raises(err):
        load_reference_checkpoint(det.model, path)
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(err):
        merge(det.model, reference_state_dict(path))


# ---------------------------------------------------------------------------
# box overlaps
# ---------------------------------------------------------------------------


def _boxes(rng, n, flat_z=False):
    xyz = rng.uniform(0, 30, (n, 3))
    ext = rng.uniform(0, 12, (n, 3))
    b = np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 0] + ext[:, 0],
                  xyz[:, 1] + ext[:, 1], xyz[:, 2], xyz[:, 2] + ext[:, 2]],
                 1)
    if flat_z:  # the 2-D family's z [0, 0]
        b[:, 4:] = 0
    return b.astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "iof", "aligned"])
@pytest.mark.parametrize("flat_z", [False, True], ids=["3d", "z0"])
def test_box_overlaps_match_jax(mode, flat_z):
    rng = np.random.RandomState(3 + flat_z)
    a, b = _boxes(rng, 40, flat_z), _boxes(rng, 40, flat_z)
    b[:5] = a[:5]  # identical pairs
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if mode == "aligned":
        got = tbox.bbox_overlaps_aligned_3d(ta, tb)
        want = jbox.bbox_overlaps_aligned_3d(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(got[:5].numpy(), 1.0, rtol=0, atol=1e-6)
    else:
        got = tbox.bbox_overlaps_3d(ta, tb, mode=mode)
        want = jbox.bbox_overlaps_3d(jnp.asarray(a), jnp.asarray(b), mode)
        assert got.shape == (40, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert float(got.max()) > 0.5 and float(got.min()) == 0.0


def test_iof_is_the_first_box_share():
    """iof: a box inside another overlaps it by its whole volume (1 in
    the inner box's row), the outer one by its share; bad modes raise."""
    inner = torch.tensor([[2.0, 2.0, 5.0, 5.0, 0.0, 1.0]])
    outer = torch.tensor([[0.0, 0.0, 9.0, 9.0, 0.0, 3.0]])
    assert float(tbox.bbox_overlaps_3d(inner, outer, "iof")) == 1.0
    assert float(tbox.bbox_overlaps_3d(outer, inner, "iof")) == \
        pytest.approx(32.0 / 400.0)
    with pytest.raises(ValueError):
        tbox.bbox_overlaps_3d(inner, outer, "giou")


# ---------------------------------------------------------------------------
# Slurm scripts
# ---------------------------------------------------------------------------


def _run_with_fake_srun(tmp_path, script, args):
    """Runs `script args` with a fake srun first on PATH that appends its
    arguments (one per line, then a blank line) to a log and runs the
    command after its four option words.  Returns (the recorded arguments,
    the process)."""
    log = tmp_path / "srun.log"
    fake = tmp_path / "bin" / "srun"
    fake.parent.mkdir(exist_ok=True)
    fake.write_text('#!/usr/bin/env bash\n'
                    f'printf "%s\\n" "$@" >> "{log}"\n'
                    f'echo >> "{log}"\n'
                    'shift 4\n'
                    'exec "$@"\n')
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{fake.parent}:{os.environ['PATH']}",
               PYTHONPATH="")
    proc = subprocess.run(["bash", str(script), *args], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    recorded = log.read_text().split("\n\n")[0].splitlines() \
        if log.exists() else []
    return recorded, proc


@pytest.mark.parametrize("kind", ["train", "test"])
def test_slurm_scripts_call_srun_as_the_jax_ones(tmp_path, kind):
    """The port's script hands srun the JAX script's partition, job name
    and --kill-on-bad-exit, then `python -m mrcnn3d_torch.tools.<kind>`
    with the config (and checkpoint) and the remaining arguments; the
    command runs from any directory (`--help` exits 0)."""
    cfg = "configs/faster_rcnn_2d.py"
    pos = [cfg] + (["work_dirs/latest.pth"] if kind == "test" else [])
    args = ["gpu", f"job_{kind}", *pos, "--help"]
    got, proc = _run_with_fake_srun(
        tmp_path, REPO / "mrcnn3d_torch" / "tools" / f"slurm_{kind}.sh", args)
    assert proc.returncode == 0, proc.stderr
    assert "usage" in proc.stdout.lower()
    opts = ["-p", "gpu", f"--job-name=job_{kind}", "--kill-on-bad-exit=1"]
    assert got == [*opts, "python", "-m", f"mrcnn3d_torch.tools.{kind}",
                   *pos, "--help"]
    jlog = tmp_path / "jax"
    jlog.mkdir()
    jax_got, _ = _run_with_fake_srun(
        jlog, REPO / "tools" / f"slurm_{kind}.sh", ["gpu", f"job_{kind}",
                                                     *pos, "--help"])
    assert jax_got[:4] == opts
    assert jax_got[4] == "python"
    assert jax_got[5].endswith(f"tools/{kind}.py")
    assert jax_got[6:] == got[7:]


def test_slurm_script_needs_its_arguments(tmp_path):
    _, proc = _run_with_fake_srun(
        tmp_path, REPO / "mrcnn3d_torch" / "tools" / "slurm_test.sh",
        ["gpu", "job", "cfg.py"])
    assert proc.returncode != 0
