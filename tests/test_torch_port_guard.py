"""The port stands alone: it imports neither JAX nor the JAX package
(its training, whole-volume, evaluation, data, API, tool and parallel
modules included), every 3-D two-stage variant and every single-stage and
cascade family builds and takes a CPU step and an inference without
them, the flagship runs inference with every backbone, test-time
augmentation, soft-NMS, RoIPool3D, VOC mAP and recall run, every 2-D type
builds and takes a CPU step and an inference, the 2-D datasets, VOC
tools, DCN and the reference-checkpoint loader import, SSD and the RGB
types (not yet ported) raise naming their ROADMAP item, 11.8 (b) or (c),
and its entry points never fall back to the CPU on their own."""
import os
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
    for name in ("core.targets", "core.reduce", "ops.losses", "train.optim", "train.step",
                 "train.checkpoint", "native", "ops.resize3d",
                 "data.transforms", "eval.masks", "eval.results",
                 "eval.coco_eval3d", "apis.tiled", "apis.inference",
                 "data.synthetic", "data.random_crop3d", "data.coco3d",
                 "data.loader", "apis.train_api", "apis.test_api",
                 "apis.serve", "tools.train", "tools.test",
                 "tools.coco_eval", "tools.serve", "tools.test_images",
                 "tools.learning_bench", "parallel.mesh", "parallel.batched",
                 "parallel.spatial", "parallel.launch",
                 "models.backbones_extra", "detectors.aug", "ops.roi_pool3d",
                 "eval.mean_ap", "eval.recall", "eval.class_names",
                 "data.legacy2d", "ops.dcn", "compat.reference_ckpt",
                 "tools.voc_eval", "tools.convert_datasets.pascal_voc"):
        assert "mrcnn3d_torch." + name in names, name
    import chip_smoke
    from mrcnn3d_torch.entry import build_trainer
    trainer = build_trainer(chip_smoke.small_train_config(), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in chip_smoke.small_train_batch(3).items()}
    losses = trainer.step(batch)
    assert trainer.state.step == 1 and len(losses) == 11
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    import numpy as np
    from mrcnn3d_torch.eval.coco_eval3d import CocoEval3D
    from mrcnn3d_torch.ops.box3d import xyxyzz_to_xywhzd
    small = build(chip_smoke.small_config(), device="cpu", budgets=16)
    vol = np.random.RandomState(0).randn(8, 32, 48, 3).astype(np.float32)
    timers = {}
    per_class, segms = small.tiled(dict(imgs=vol), patch_hw=32, patch_d=8,
                                   overlap=0.5, max_dets_per_tile=4,
                                   timers=timers)
    assert timers["n_tiles"] == 2 and timers["n_entries"] == 8
    assert per_class[0].shape[1] == 7 and len(segms[0]) == len(per_class[0])
    entries = [dict(image_id=0, category_id=1, score=float(r[6]),
                    bbox=[float(v) for v in xyxyzz_to_xywhzd(r[:6])],
                    segmentation=s) for r, s in zip(per_class[0], segms[0])]
    gt = dict(images=[dict(id=0)], categories=[dict(id=1)], annotations=[
        dict(id=1, image_id=0, category_id=1, bbox=entries[0]["bbox"],
             segmentation=np.ones((8, 32, 48), np.uint8))])
    assert CocoEval3D(gt, entries, "segm").summarize().shape == (29,)
    import tempfile
    from mrcnn3d_torch.apis.train_api import train_detector
    from mrcnn3d_torch.data.coco3d import Coco3D2ScalesDataset
    from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
    cfg = chip_smoke.small_train_config()
    cfg.data["workers_per_gpu"] = 1
    tr = cfg.data["train"]
    with tempfile.TemporaryDirectory() as tmp:
        ann, img_dir = make_synthetic_coco3d(tmp, num_volumes=2, hw=64,
                                             depth=12, seed=0)
        ds = Coco3D2ScalesDataset(ann, img_dir, max_gt=4,
                                  img_norm_cfg=tr["img_norm_cfg"],
                                  extra_aug=tr["extra_aug"])
        stats = {}
        state = train_detector(cfg, ds, work_dir=tmp, max_iters=2,
                               device="cpu", stats=stats)
        assert state.step == 2 and len(stats["losses"]) == 2
    for kind in chip_smoke.VARIANTS:
        vcfg = chip_smoke.variant_recipe(chip_smoke.small_train_config(),
                                         kind)
        vtrainer = build_trainer(vcfg, device="cpu")
        scales = vtrainer.model.num_scales
        vbatch = chip_smoke.variant_train_batch(
            3, scales, vtrainer.model.num_parcellations > 0)
        vlosses = vtrainer.step({k: torch.from_numpy(v)
                                 for k, v in vbatch.items()})
        assert all(bool(torch.isfinite(v)) for v in vlosses.values()), kind
        vdet = build(chip_smoke.variant_recipe(chip_smoke.small_config(),
                                               kind), device="cpu",
                     budgets=16)
        out = vdet.run(*(torch.from_numpy(v) for v in
                         chip_smoke.variant_inputs(7, scales).values()))
        assert out[0].shape == (1, 16, 7), kind
    for kind in chip_smoke.FAMILIES:
        fcfg = chip_smoke.family_narrow(chip_smoke.family_config(kind), 16)
        ftrainer = build_trainer(fcfg, device="cpu")
        fbatch = chip_smoke.family_train_batch(3, kind)
        flosses = ftrainer.step({k: torch.from_numpy(v)
                                 for k, v in fbatch.items()})
        assert all(bool(torch.isfinite(v)) for v in flosses.values()), kind
        fdet = build(fcfg, device="cpu")
        out = fdet.run(
            torch.from_numpy(chip_smoke.variant_inputs(7, 1)["imgs"]))
        assert out[0].shape == (1, 8, 7), kind
        assert (out[3] is not None) == (kind == "HybridTaskCascade3D"), kind
        swept = fdet.tiled(dict(imgs=vol[:, :, :32]), patch_hw=32,
                           patch_d=8, overlap=0.5)
        if kind == "HybridTaskCascade3D":
            per_class, segms = swept
            assert len(segms[0]) == len(per_class[0]) > 0, kind
    for name in chip_smoke.BACKBONES:
        bcfg = chip_smoke.backbone_recipe(chip_smoke.small_config(), name)
        bdet = build(bcfg, device="cpu", budgets=16)
        shape = (16, 32, 32) if name == "UNet3D" else (8, 32, 32)
        out = bdet.run(torch.randn(1, 3, *shape),
                       torch.randn(1, 3, *(n * 3 // 2 for n in shape)))
        assert out[0].shape == (1, 16, 7), name
    tcfg = chip_smoke.variant_recipe(chip_smoke.small_config(), "MaskRCNN3D")
    tdet = build(tcfg, device="cpu", budgets=16)
    x = torch.randn(1, 3, 8, 32, 32)
    tta = tdet.aug_test([dict(imgs=x), dict(imgs=x.flip(-1))],
                        [dict(scale_factor=1.0, flip=False),
                         dict(scale_factor=1.0, flip=True)])
    assert tta["dets"].shape == (1, 16, 7) and "mask_probs" in tta
    from mrcnn3d_torch.eval.mean_ap import eval_map_3d
    from mrcnn3d_torch.eval.recall import eval_recalls_3d
    from mrcnn3d_torch.ops.nms3d import soft_nms_3d
    from mrcnn3d_torch.ops.roi_pool3d import roi_pool_3d
    dets = tta["dets"][0][tta["valid"][0]]
    kept, _ = soft_nms_3d(dets, method="gaussian")
    gt = [dets[:1, :6].numpy()]
    assert eval_map_3d([kept], gt)[0] > 0
    assert eval_recalls_3d(gt, [dets.numpy()], (1,)).shape == (1, 1)
    rois = torch.cat([torch.zeros(len(dets), 1), dets[:, :6]], 1)
    assert roi_pool_3d(torch.randn(1, 4, 8, 32, 32), rois, 7, 3, 1.0,
                       1.0).shape == (len(dets), 4, 3, 7, 7)
    for kind in chip_smoke.TWO_D:
        ccfg = chip_smoke.two_d_narrow(chip_smoke.two_d_config(kind))
        tr = build_trainer(ccfg, device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in
              chip_smoke.two_d_train_batch(3, kind).items()}
        assert all(bool(torch.isfinite(v)) for v in tr.step(tb).values())
        out = build(ccfg, device="cpu").simple_test(
            {k: torch.from_numpy(v) for k, v in chip_smoke.two_d_inputs(
                7, proposals=kind == "FastRCNN").items()})
        assert out["dets"].shape[-1] == 7, kind
    for kind, item in (("SSD", "11.8 (b)"), ("MaskRCNNRGB", "11.8 (c)"),
                       ("MaskRCNNRGB2", "11.8 (c)")):
        vcfg = chip_smoke.small_config()
        vcfg.model["type"] = kind
        try:
            build(vcfg, device="cpu")
        except NotImplementedError as e:
            assert f"item {item}" in str(e), e
        else:
            raise AssertionError(f"{kind} built")
    torch.cuda.is_available = lambda: False
    for entry in (build, build_trainer, lambda device: train_detector(
            cfg, ds, device=device)):
        try:
            entry(device=None)
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"{entry}(device=None) ran without CUDA")
    print(len(names), "modules")
    """
)


def test_port_imports_and_builds_without_jax():
    # two intra-op threads: the tier-1 run shares the CPU among workers
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 30, proc.stdout


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
