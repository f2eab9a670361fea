"""Sharded evaluation, batched inference and the multi-process dry run of
the port on the CPU, gloo processes spawned per test.

  * `evaluate_dataset` at world 2 against world 1, on a set whose two
    volumes each have a second patch (a copy at offset 0 under the
    volume's `full_volume_id`) that lands on the other rank: the same
    stats, and the same merged entries, which needs the patch merge to
    run after the all-gather;
  * `entry.dryrun_multichip` asks for the card unless given the CPU;
  * `make_batched_infer` at world 2 against serial simple_test: valid
    and labels equal, the rest within 2e-3;
  * `entry.dryrun_multichip(2)`;
  * `tools.train` and `tools.test` under torchrun (`--launcher
    pytorch`, two ranks): the test tool's results and stats as one
    process's.
"""
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mrcnn3d_torch.apis import test_api
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.parallel.launch import spawn
from test_torch_port_tools import NARROW, REPO
from torch_port_fixtures import torch_threads  # noqa: F401


def _eval_cfg():
    cfg = cs.small_config()
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.test_cfg["rpn"][k] = cs.SMALL_BUDGET
    cfg.test_cfg["rcnn"]["max_per_img"] = 16
    return cfg


def _patch_set(root):
    """Two synthetic volumes, each followed by a patch of itself: images
    [1, 3 (patch of 1), 2, 4 (patch of 2)], so at world 2 rank 0 runs
    volumes 1 and 2 and rank 1 their patches."""
    ann, img_dir = make_synthetic_coco3d(root, num_volumes=2, hw=64,
                                         depth=12, seed=1)
    with open(ann) as f:
        coco = json.load(f)
    images = []
    for im in coco["images"]:
        images += [dict(im, full_volume_id=im["id"]),
                   dict(im, id=im["id"] + 2, full_volume_id=im["id"],
                        pos_top=0, pos_left=0, pos_front=0)]
    coco["images"] = images
    with open(ann, "w") as f:
        json.dump(coco, f)
    return ann, img_dir


def _evaluate(rank, world, ann, img_dir):
    """(stats, the merged bbox entries, the count before the merge) of
    this rank's sharded run."""
    from mrcnn3d_torch.entry import build
    from mrcnn3d_torch.eval.results import (merge_patch_detections,
                                            results2json3d)
    from mrcnn3d_torch.tools.common import test_dataset

    cfg = _eval_cfg()
    model = build(cfg, device="cpu", seed=0).model
    ds = test_dataset(cfg.data["test"], ann, img_dir, 2)
    stats = test_api.evaluate_dataset(cfg, model, ds, rank=rank,
                                      world=world)
    results, infos = (test_api.gather_shards(items, world) for items in
                      test_api.run_inference(cfg, model, ds, False, rank,
                                             world)[:2])
    raw = results2json3d(results, infos, False)
    return stats, merge_patch_detections(raw), len(raw)


def _rows(entries):
    """The entries as rows (image, category, score, box), sorted."""
    rows = np.array([[e["image_id"], e["category_id"], e["score"],
                      *e["bbox"]] for e in entries])
    return rows[np.lexsort(rows[:, ::-1].T)]


def test_evaluate_dataset_world2_matches_world1(tmp_path):
    ann, img_dir = _patch_set(str(tmp_path / "data"))
    want_stats, want, n_raw = _evaluate(0, 1, ann, img_dir)
    assert 0 < len(want) < n_raw
    for stats, entries, _ in spawn(_evaluate, 2, (ann, img_dir),
                                   workdir=str(tmp_path / "spawn")):
        assert stats == want_stats
        # scores and boxes as the ranks' float32 runs round them
        np.testing.assert_allclose(_rows(entries), _rows(want), rtol=0,
                                   atol=1e-4)


def test_batched_infer_world2_matches_serial(tmp_path):
    cfg = _eval_cfg()
    cfg.test_cfg["return_bbox_only"] = False
    volumes = {k: v for k, v in cs.small_train_batch(4, 2).items()
               if k.startswith("imgs")}
    out = cs.check_dist_infer(cfg, {"batched": volumes}, "cpu",
                              workdir=str(tmp_path))
    assert out["batched"][0] <= cs.PIPELINE_ATOL


def test_dryrun_multichip(capsys):
    from mrcnn3d_torch.entry import dryrun_multichip

    dp, hybrid = dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2) OK" in capsys.readouterr().out
    assert dp > 0 and hybrid > 0


def test_dryrun_multichip_runs_on_the_card_unless_asked(monkeypatch):
    from mrcnn3d_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)


def test_gathers_outside_a_group_pass_through():
    entries = [dict(image_id=1)]
    assert test_api.gather_shards(entries, 1) is entries


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tool(tmp, module, *args, nproc=1):
    """A tool on the CPU, under torchrun with --launcher pytorch when
    nproc > 1; its output."""
    env = dict(os.environ, TMPDIR=str(tmp), PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    cmd = [sys.executable, "-m", f"mrcnn3d_torch.tools.{module}", *args,
           "--device", "cpu"]
    if nproc > 1:
        cmd[1:2] = ["-m", "torch.distributed.run",
                    f"--nproc_per_node={nproc}",
                    f"--master_port={_free_port()}", "-m"]
        cmd += ["--launcher", "pytorch"]
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def test_tools_under_torchrun(tmp_path):
    """tools.train and tools.test as torchrun launches them, two ranks
    on the CPU: one data-parallel iteration checkpointed by rank 0; the
    test passes (double_test) sharded over the ranks give rank 0 the
    results and the stats of one process."""
    cfg = tmp_path / "narrow.py"
    cfg.write_text(NARROW.format(
        flagship=str(REPO / "configs" / "mask_rcnn_3d_2scales.py")))
    wd = tmp_path / "wd"
    _tool(tmp_path, "train", str(cfg), "--synthetic", "--max-iters", "1",
          "--work_dir", str(wd), nproc=2)
    assert (wd / "checkpoints" / "1" / "state.pt").exists()
    outs = [_tool(tmp_path, "test", str(cfg), str(wd), "--synthetic",
                  "--out", str(tmp_path / f"res{n}.pkl"), nproc=n)
            for n in (1, 2)]
    stats = [[ln for ln in out.splitlines() if ln.startswith("bbox_")]
             for out in outs]
    assert len(stats[0]) == 29 and stats[0] == stats[1]
    with open(tmp_path / "res1.pkl", "rb") as f1, \
            open(tmp_path / "res2.pkl", "rb") as f2:
        one, two = pickle.load(f1), pickle.load(f2)
    assert len(one) == len(two) == 8
    for a, b in zip(one, two):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
