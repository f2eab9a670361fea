"""The port's command-line tools (`python -m mrcnn3d_torch.tools.<name>`),
each run as a subprocess on the CPU with its --synthetic set and a
narrow config: train, then test (double_test, bbox and segm) on its
checkpoint, coco_eval on the saved results, serve and test_images on the
same checkpoint, and the learning bench on its smoke set."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_port_fixtures import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# two intra-op threads a tool: the tier-1 run shares the CPU among its
# workers, and a tool on every core slows them all
THREADS = dict(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")

# the flagship at narrow widths with the budgets of chip_smoke.py's
# small_train_config, one loader worker
NARROW = """
exec(open({flagship!r}).read())
model["backbone"]["base_width"] = 4
model["neck"]["out_channels"] = 8
for _h in ("bbox_head", "refinement_head"):
    model[_h]["fc_out_channels"] = 32
for _c in (test_cfg, test_cfg2):
    for _k in ("nms_pre", "nms_post", "max_num"):
        _c["rpn"][_k] = 64
    _c["rcnn"]["max_per_img"] = 64
for _k in ("nms_pre", "nms_post", "max_num"):
    train_cfg["rpn_proposal"][_k] = 64
train_cfg["rpn"]["sampler"]["num"] = 64
train_cfg["rcnn"]["sampler"]["num"] = 32
data["workers_per_gpu"] = 1
"""


def _run(tmp, tool, *args):
    """The tool on the CPU (coco_eval runs on the host alone)."""
    if tool != "coco_eval":
        args += ("--device", "cpu")
    env = dict(os.environ, TMPDIR=str(tmp), PYTHONPATH=str(REPO),
               **THREADS)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"mrcnn3d_torch.tools.{tool}", *args],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout + proc.stderr


def _stats(out, prefix):
    return {line.split(":")[0]: float(line.split(":")[1])
            for line in out.splitlines() if line.startswith(prefix + "_")}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tools")
    cfg = tmp / "narrow.py"
    cfg.write_text(NARROW.format(
        flagship=str(REPO / "configs" / "mask_rcnn_3d_2scales.py")))
    wd = tmp / "wd"
    out = _run(tmp, "train", str(cfg), "--synthetic", "--max-iters", "2",
               "--work_dir", str(wd))
    assert "max_iters reached at step 2" in out
    return tmp, cfg, wd


def test_train_then_test_and_coco_eval(trained):
    tmp, cfg, wd = trained
    assert (wd / "checkpoints" / "2" / "state.pt").exists()
    out = _run(tmp, "test", str(cfg), str(wd), "--synthetic", "--eval",
               "bbox", "segm", "--out", str(tmp / "res.pkl"))
    assert "loaded checkpoint at step 2" in out
    bbox, segm = _stats(out, "bbox"), _stats(out, "segm")
    assert len(bbox) == 29 and len(segm) == 29
    # the pickle holds both passes' results (4 volumes each); scored
    # against the 1.0x gt its first four images are pass 1
    gt = tmp / "mrcnn3d_torch_synth_test" / "instances.json"
    out = _run(tmp, "coco_eval", str(tmp / "res.pkl"), str(gt))
    assert len(_stats(out, "bbox")) == 29


def test_serve_once(trained):
    tmp, cfg, wd = trained
    in_dir = tmp / "in"
    in_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        np.save(in_dir / f"v{i}.npy",
                rng.normal(100, 30, (64, 64, 12)).astype(np.float32))
    _run(tmp, "serve", str(cfg), str(wd), "--in-dir", str(in_dir),
         "--out-dir", str(tmp / "out"), "--once", "--dtype", "float32")
    for i in range(2):
        with open(tmp / "out" / f"v{i}.json") as f:
            rec = json.load(f)
        assert list(rec) == ["class_1"]
        assert all(len(r) == 7 and r[6] >= 0.05 for r in rec["class_1"])


def test_test_images(trained):
    tmp, cfg, wd = trained
    out = _run(tmp, "test_images", str(cfg), str(wd), "--synthetic",
               "--out-dir", str(tmp / "viz"), "--score-thr", "0.0")
    assert out.count("slice overlays") == 2
    assert list((tmp / "viz").glob("synthetic_0001/slice_*.png"))


def test_learning_bench_smoke(tmp_path):
    cfg = tmp_path / "narrow.py"
    cfg.write_text(NARROW.format(
        flagship=str(REPO / "configs" / "mask_rcnn_3d_2scales.py")))
    out_json = tmp_path / "rec.json"
    _run(tmp_path, "learning_bench", "--synthetic", "--config", str(cfg),
         "--iters", "2", "--workdir", str(tmp_path / "wd"), "--json-out",
         str(out_json))
    rec = json.loads(out_json.read_text())
    assert rec["step"] == 2 and rec["protocol"]["synthetic"]
    assert not rec["data_matches_pinned"]
    assert len(rec["stats"]) == len(rec["stats_single_pass"]) == 29
    assert len(rec["segm_stats"]) == 29 and rec["mask_quality"]["n_gt"] > 0
    assert len(rec["port"]["eval_timers"]) >= 4


def test_cuda_device_flag_raises_without_a_card(tmp_path):
    """--device cuda (the default) on a machine without CUDA raises."""
    env = dict(os.environ, PYTHONPATH=str(REPO), **THREADS)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False; "
         "from mrcnn3d_torch.tools import learning_bench; "
         "learning_bench.main(['--synthetic', '--workdir', 'wd'])"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("port, want", [
    # no port seed reaches either reference: 1 of C(10, 2) orders
    ([0.40, 0.45, 0.47, 0.48, 0.49, 0.50, 0.51, 0.55], 1 / 45),
    # one seed between them: still p <= 0.05, systematic
    ([0.40, 0.45, 0.47, 0.48, 0.49, 0.50, 0.51, 0.60], 2 / 45),
    # two seeds between, or one above both: seed noise
    ([0.40, 0.45, 0.47, 0.48, 0.49, 0.50, 0.57, 0.60], 4 / 45),
    ([0.40, 0.45, 0.47, 0.48, 0.49, 0.50, 0.51, 0.70], 4 / 45),
])
def test_rank_test_of_the_seed_distribution(port, want):
    """The exact one-sided rank-sum p of two reference runs above eight
    port seeds (JAX's oracle means 0.559 and 0.618)."""
    from mrcnn3d_torch.tools.learning_seeds import rank_p_value

    assert rank_p_value([0.559, 0.618], port) == pytest.approx(want)


def test_learning_seeds_smoke(tmp_path):
    """Two seeds of the protocol (generated set, 2 iterations, narrow
    config), each artifact with its placement record, and the summary
    with its rank tests."""
    cfg = tmp_path / "narrow.py"
    cfg.write_text(NARROW.format(
        flagship=str(REPO / "configs" / "mask_rcnn_3d_2scales.py")))
    out = tmp_path / "out"
    _run(tmp_path, "learning_seeds", "--seeds", "3", "4", "--iters", "2",
         "--synthetic", "--config", str(cfg), "--out", str(out),
         "--workroot", str(tmp_path / "work"))
    summary = json.loads((out / "summary.json").read_text())
    assert [r["seed"] for r in summary["rows"]] == [3, 4]
    for r in summary["rows"]:
        assert not r.get("missing") and r["oracle_mean"] is not None
        assert "vol_ratio_mean" in r and "box_iou_mean" in r
    for name in ("oracle_mean", "segm_mAP_0.5", "frac_ge_50"):
        assert 0 < summary["rank_tests"][name]["p"] <= 1
    rec = json.loads((out / "LEARNING_torch_3.json").read_text())
    assert rec["step"] == 2
    assert rec["placement"]["n_gt"] == rec["mask_quality"]["n_gt"] > 0
