"""The port's training, test and serving APIs on the CPU, against the JAX
package's where it has a counterpart.

Inference: the narrow flagship (`test_torch_port_models`), budgets 64,
masks on, over a tiny synthetic set of 64x64x12 volumes (no padding, so
the serving loop's twin is the dataset's): per-class counts equal, rows
within 2e-3 after pairing (as chip_smoke.py's `compare_tiled` pairs
them), pasted masks equal on every voxel whose probability lies farther
than 1e-2 from the 0.25 threshold.  Training: `train_detector` for a few
iterations of the narrow config on generated crops.
"""
import copy
import json
import os
import signal

import numpy as np
import pytest
import torch

from chip_smoke import (
    MASK_PROB_BAND,
    PIPELINE_ATOL,
    SMALL_BUDGET,
    _paste,
    compare_tiled,
    small_train_config,
)
from mrcnn3d.apis import test_api as jtest_api
from mrcnn3d.data import coco3d as jcoco3d
from mrcnn3d.eval.coco_eval3d import CocoEval3D as JCocoEval3D
from mrcnn3d.eval.masks import segm_entries as jsegm_entries
from mrcnn3d.eval.results import results2json3d as jresults2json3d
from mrcnn3d.train.optim import step_lr_schedule as jstep_lr_schedule
from mrcnn3d_torch.apis import serve, test_api, train_api
from mrcnn3d_torch.data import coco3d
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.eval.masks import (
    _sigmoid,
    _trilinear_resize,
    box_extent,
    paste_mask_3d,
    segm_entries,
)
from mrcnn3d_torch.eval.results import results2json3d
from mrcnn3d_torch.train import checkpoint
from mrcnn3d_torch.train import step as step_mod
from test_torch_port_models import jax_flagship, port_flagship

ATOL = PIPELINE_ATOL
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: the tier-1 run shares the
    CPU among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _budgets(cfg):
    for k in ("nms_pre", "nms_post", "max_num"):
        cfg.test_cfg["rpn"][k] = SMALL_BUDGET
    cfg.test_cfg["rcnn"]["max_per_img"] = SMALL_BUDGET
    cfg.test_cfg["return_bbox_only"] = False
    return cfg


@pytest.fixture(scope="module")
def models():
    jcfg, jmodel, variables = jax_flagship(seed=0)
    tcfg, tmodel = port_flagship(variables)
    return _budgets(jcfg), jmodel, variables, _budgets(tcfg), tmodel


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("apis")
    ann, img_dir = make_synthetic_coco3d(str(root), num_volumes=2, hw=64,
                                         depth=12, seed=21)
    kw = dict(img_norm_cfg=NORM, with_mask=False, test_mode=True)
    return (ann, img_dir, jcoco3d.Coco3D2ScalesDataset(ann, img_dir, **kw),
            coco3d.Coco3D2ScalesDataset(ann, img_dir, **kw))


@pytest.fixture(scope="module")
def inferred(models, synth):
    """(port's run_inference, JAX's, the port's resized mask probs per
    detection, keyed by the id of its mask)."""
    jcfg, jmodel, variables, tcfg, tmodel = models
    _, _, jds, tds = synth
    probs = {}
    real = test_api.get_box_masks_3d

    def record(logits, dets, labels, valid, thr):
        out = real(logits, dets, labels, valid, thr)
        for bm, lg in zip(out, logits):
            probs[id(bm["mask"])] = _trilinear_resize(
                _sigmoid(lg), box_extent(bm["box"]))
        return out

    test_api.get_box_masks_3d = record
    try:
        got = test_api.run_inference(tcfg, tmodel, tds, progress=False)
    finally:
        test_api.get_box_masks_3d = real
    want = jtest_api.run_inference(jcfg, jmodel, variables, jds,
                                   progress=False)
    return got, want, probs


def test_run_inference_matches_jax(inferred):
    """Rows and counts as the JAX package's; each pasted mask as its
    full-volume mask off the band."""
    (results, infos, segms), (jresults, jinfos, jsegms), probs = inferred
    assert infos == jinfos and len(results) == 2
    n = 0
    for res, seg, jres, jseg in zip(results, segms, jresults, jsegms):
        compare_tiled((res, [[]] * len(res)), (jres, [[]] * len(jres)), {},
                      ATOL, "run_inference port vs JAX")
        for c, (rows, jrows) in enumerate(zip(res, jres)):
            pair = np.abs(rows[:, None] - jrows[None]).max(-1).argmin(1)
            assert len(seg[c]) == len(rows) == len(jseg[c])
            for carrier, j in zip(seg[c], pair):
                shape = carrier["shape"]
                assert shape == jseg[c][j].shape
                pasted = paste_mask_3d(carrier["box"], carrier["mask"],
                                       shape)
                # the port's probabilities decide the band
                p = _paste(carrier["box"], probs[id(carrier["mask"])], shape)
                near = np.abs(p - 0.25) <= MASK_PROB_BAND
                assert not ((pasted != jseg[c][j]) & ~near).any()
            n += len(rows)
    assert n > 4, f"{n} detections: vacuous case"


def test_evaluate_dataset_stats(models, synth, inferred):
    """evaluate_dataset's bbox and segm stats equal the JAX evaluator's on
    the same entries (masks pasted into full volumes for it)."""
    _, _, _, tcfg, tmodel = models
    ds = synth[3]
    (results, infos, segms), _, _ = inferred
    bbox = test_api.evaluate_dataset(tcfg, tmodel, ds, "bbox")
    want = JCocoEval3D(ds.coco, jresults2json3d(results, infos)).named_stats()
    assert bbox == pytest.approx(want, abs=1e-12)
    assert bbox == pytest.approx(JCocoEval3D(
        ds.coco, results2json3d(results, infos)).named_stats(), abs=1e-12)
    segm = test_api.evaluate_dataset(tcfg, tmodel, ds, "segm")
    entries = []
    for cls_segms, per_class, info in zip(segms, results, infos):
        pasted = [[paste_mask_3d(s["box"], s["mask"], s["shape"])
                   for s in c] for c in cls_segms]
        entries.extend(jsegm_entries(pasted, per_class, info))
        assert len(segm_entries(cls_segms, per_class, info)) == \
            sum(len(c) for c in cls_segms)
    want = JCocoEval3D(ds.coco, entries, iou_type="segm").named_stats("segm")
    assert segm == pytest.approx(want, abs=1e-12)
    assert 29 == len(segm) == len(bbox)


def test_serve_matches_run_inference(models, synth, inferred, tmp_path):
    """serve_paths over the dataset's raw volumes, and watch's json, give
    run_inference's rows (the twin derived from the normalised volume:
    float rounding apart)."""
    _, _, _, tcfg, tmodel = models
    ann, img_dir, _, tds = synth
    (results, infos, _), _, _ = inferred
    runner = test_api.InferenceRunner(tcfg, tmodel)
    paths = [os.path.join(img_dir, i["file_name"]) for i in infos]
    served = list(serve.serve_paths(runner, paths, NORM))
    assert [p for p, _ in served] == paths
    out_dir = tmp_path / "out"
    serve.watch(runner, img_dir, str(out_dir), NORM, poll_s=0.01,
                stop_after=len(paths))
    assert sorted(os.listdir(out_dir)) == sorted(
        os.path.splitext(i["file_name"])[0] + ".json" for i in infos)
    for (path, per_class), res, info in zip(served, results, infos):
        name = os.path.splitext(info["file_name"])[0] + ".json"
        with open(out_dir / name) as f:
            rec = json.load(f)
        rows = [np.asarray(rec["class_1"], np.float32).reshape(-1, 7)]
        for got in (per_class, rows):
            compare_tiled((got, [[]]), (res, [[]]), {}, ATOL,
                          "serve vs run_inference")
        assert len(rows[0]) == len(res[0])
    assert set(runner.det._anchor_sets) == {((12, 64, 64), (18, 96, 96))}


def _train_set(root, seed=0, n=2):
    ann, img_dir = make_synthetic_coco3d(str(root), num_volumes=n, hw=64,
                                         depth=12, seed=seed)
    cfg = small_train_config()
    tr = cfg.data["train"]
    return cfg, coco3d.Coco3D2ScalesDataset(
        ann, img_dir, img_norm_cfg=tr["img_norm_cfg"], max_gt=4,
        extra_aug=tr["extra_aug"], seed=seed)


def _record_lrs(monkeypatch, hook=None):
    lrs = []
    real = step_mod.apply_gradients

    def record(state):
        real(state)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        if hook is not None:
            hook(state)

    monkeypatch.setattr(step_mod, "apply_gradients", record)
    return lrs


def test_train_detector_schedule_checkpoint_resume(tmp_path, monkeypatch):
    """Three iterations: each step's lr is the JAX schedule's (lr steps
    placed by the dataset's iterations per epoch: 2 volumes, batch 1), a
    checkpoint at max_iters; a second call resumes at its step."""
    cfg, ds = _train_set(tmp_path / "data")
    cfg.lr_config["step"] = [1]
    cfg.data["workers_per_gpu"] = 1
    lrs = _record_lrs(monkeypatch)
    stats = {}
    state = train_api.train_detector(
        cfg, ds, work_dir=str(tmp_path / "wd"), max_iters=3, device="cpu",
        log_interval=1, stats=stats)
    lr = cfg.lr_config
    sched = jstep_lr_schedule(cfg.optimizer["lr"], [1], 2,
                              lr["warmup_iters"], lr["warmup_ratio"])
    np.testing.assert_allclose(lrs, [float(sched(k)) for k in range(3)],
                               rtol=1e-6)
    assert lrs[2] < lrs[1] * 0.2   # the lr step at iteration 2
    assert state.step == 3 and stats["iters"] == 3
    assert len(stats["losses"]) == 3 and np.isfinite(stats["losses"]).all()
    assert 0 <= stats["loader_wait_s"] <= stats["seconds"]
    manager = checkpoint.CheckpointManager(str(tmp_path / "wd"))
    assert manager.all_steps() == [3]
    resumed = {}
    state = train_api.train_detector(
        cfg, ds, work_dir=str(tmp_path / "wd"), max_iters=5, device="cpu",
        stats=resumed, profile_steps=(3, 4))
    assert state.step == 5 and resumed["iters"] == 2
    assert (tmp_path / "wd" / "profile" / "trace.json").stat().st_size > 0
    assert manager.all_steps() == [3, 5]
    np.testing.assert_allclose(lrs[3:], [float(sched(k)) for k in (3, 4)],
                               rtol=1e-6)


def test_train_detector_sigterm_checkpoints(tmp_path, monkeypatch):
    """A SIGTERM raised during the second step: the loop checkpoints
    that step and returns, and the previous handler is back."""
    cfg, ds = _train_set(tmp_path / "data", seed=1)
    cfg.data["workers_per_gpu"] = 1

    def kill(state):
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    _record_lrs(monkeypatch, kill)
    before = signal.getsignal(signal.SIGTERM)
    state = train_api.train_detector(
        cfg, ds, work_dir=str(tmp_path / "wd"), max_iters=10, device="cpu")
    assert state.step == 2
    assert checkpoint.CheckpointManager(
        str(tmp_path / "wd")).all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is before


def test_multi_card_asks_raise(tmp_path):
    cfg, ds = _train_set(tmp_path / "data")
    with pytest.raises(NotImplementedError, match="item 10"):
        train_api.train_detector(cfg, ds, mesh="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        test_api.run_inference(cfg, None, ds, world=2)


def test_train_shapes_probe_advances_the_crops(tmp_path):
    """train_shapes probes dataset[0], which draws a crop: the JAX
    package's probe does the same, so the samples after it agree."""
    from mrcnn3d.apis.train_api import train_shapes as jtrain_shapes

    cfg, ds = _train_set(tmp_path, seed=4)
    jds = jcoco3d.Coco3D2ScalesDataset(
        os.path.join(tmp_path, "instances.json"),
        os.path.join(tmp_path, "volumes"),
        img_norm_cfg=cfg.data["train"]["img_norm_cfg"], max_gt=4,
        extra_aug=cfg.data["train"]["extra_aug"], seed=4)
    # the 16-voxel quarter crop padded to 32; its twin, of the padded
    # crop, padded to 64
    shapes = [(12, 32, 32), (18, 64, 64)]
    assert train_api.train_shapes(cfg, ds) == shapes
    assert [tuple(s) for s in jtrain_shapes(cfg, jds)] == shapes
    for idx in (1, 0):
        a, b = ds[idx], jds[idx]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert train_api.train_shapes(cfg) == [(64, 128, 128), (96, 192, 192)]


def test_show_result_3d(tmp_path, monkeypatch):
    """One PNG per slice that a detection or a gt box covers; without
    matplotlib the call raises instead of skipping."""
    import sys

    from mrcnn3d_torch.apis.inference import show_result_3d

    vol = np.random.RandomState(0).rand(16, 16, 6).astype(np.float32)
    dets = [np.array([[2, 2, 8, 8, 1, 2, 0.9], [1, 1, 4, 4, 4, 4, 0.1]],
                     np.float32)]
    gt = np.array([[3, 3, 9, 9, 2, 3]], np.float32)
    written = show_result_3d(vol, dets, str(tmp_path / "viz"),
                             score_thr=0.2, gt_boxes=gt)
    assert [os.path.basename(p) for p in written] == [
        "slice_001.png", "slice_002.png", "slice_003.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        show_result_3d(vol, dets, str(tmp_path / "none"))


def test_load_detector(tmp_path):
    cfg = copy.deepcopy(small_train_config())
    model, step = test_api.load_detector(cfg, str(tmp_path), device="cpu")
    assert step is None and not model.training
    trained = train_api.build_trainer(cfg, device="cpu", seed=3)
    trained.state.step = 7
    checkpoint.save(checkpoint.CheckpointManager(str(tmp_path)),
                    trained.state)
    model, step = test_api.load_detector(cfg, str(tmp_path), device="cpu")
    assert step == 7
    for (k, a), b in zip(trained.model.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k
