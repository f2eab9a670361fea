"""The 2-D data and VOC tools against the JAX package, on the CPU:
`Coco2DDataset` (`mrcnn3d/data/coco3d.py:336-368`), the VOC/XML, Concat
and Repeat datasets (`mrcnn3d/data/legacy2d.py:32-76, :150-287`),
`mrcnn3d_torch.tools.voc_eval` and
`mrcnn3d_torch.tools.convert_datasets.pascal_voc` against
tools/voc_eval.py and tools/convert_datasets/pascal_voc.py, on trees the
tests write (.npy images, and one JPEG that PIL decodes); then
`train_detector` for two iterations of a narrow FasterRCNN on a
Coco2DDataset.  Samples are compared exactly.
"""
import contextlib
import importlib.util
import io
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import two_d_config, two_d_narrow
from mrcnn3d.data import coco3d as jcoco3d
from mrcnn3d.data import legacy2d as jlegacy2d
from mrcnn3d_torch.data import coco3d, legacy2d
from mrcnn3d_torch.tools import voc_eval
from mrcnn3d_torch.tools.convert_datasets import pascal_voc
from mrcnn3d_torch.utils.config import Config as TConfig

REPO = Path(__file__).resolve().parent.parent
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture()
def coco2d_root(tmp_path):
    """Four 64x64 images, (H, W) and (H, W, 3) .npy, COCO boxes of 4
    elements (and one of 6), one image without gt."""
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(4):
        shape = (64, 64) if i % 2 else (64, 64, 3)
        np.save(tmp_path / f"img{i}.npy",
                (rng.rand(*shape) * 255).astype(np.float32))
        images.append(dict(id=i + 1, file_name=f"img{i}.npy", width=64,
                           height=64))
        for j in range(0 if i == 3 else 2 + i % 2):
            x, y = rng.uniform(2, 40, 2).round(1)
            w, h = rng.uniform(6, 20, 2).round(1)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=1 + (j % 2), iscrowd=0,
                             bbox=[x, y, w, h], area=w * h))
    anns[0]["bbox"] = anns[0]["bbox"] + [0, 1]  # a 6-element box
    coco = dict(images=images, annotations=anns,
                categories=[dict(id=1, name="a"), dict(id=2, name="b")])
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(coco))
    return str(ann), str(tmp_path)


@pytest.mark.parametrize("test_mode", [False, True])
def test_coco2d_samples_match_jax(coco2d_root, test_mode):
    ann, root = coco2d_root
    kw = dict(with_mask=False, max_gt=4, test_mode=test_mode)
    ours = coco3d.Coco2DDataset(ann, root, NORM, **kw)
    theirs = jcoco3d.Coco2DDataset(ann, root, NORM, **kw)
    assert len(ours) == len(theirs) == (4 if test_mode else 3)
    for i in range(len(ours)):
        _same(ours[i], theirs[i])
    s = ours[0]
    assert s["imgs"].shape == (1, 64, 64, 3)
    if not test_mode:
        assert (s["gt_boxes"][s["gt_valid"]][1:, 4:] == 0).all()


def _voc_tree(root, ids=("000001", "000002", "000003"), jpeg="000003"):
    """A VOC tree: .npy images under JPEGImages/<id>.jpg.npy (one real
    JPEG), XML annotations with difficult boxes, ImageSets/Main lists."""
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.RandomState(1)
    objs = {"000001": [("dog", 0, (5, 6, 15, 18)), ("cat", 1, (1, 1, 8, 8))],
            "000002": [("dog", 0, (3, 3, 20, 25)), ("car", 0, (10, 2, 28, 9)),
                       ("car", 1, (0, 0, 4, 4))],
            "000003": [("person", 0, (4, 4, 26, 28))]}
    for img_id in ids:
        img = (rng.rand(30, 30, 3) * 255).astype(np.uint8)
        if img_id == jpeg:
            from PIL import Image

            Image.fromarray(img).save(root / "JPEGImages" / f"{img_id}.jpg")
        else:
            np.save(root / "JPEGImages" / f"{img_id}.jpg.npy", img)
        body = "".join(
            f"<object><name>{n}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
            f"<ymax>{b[3]}</ymax></bndbox></object>"
            for n, d, b in objs[img_id])
        (root / "Annotations" / f"{img_id}.xml").write_text(
            "<annotation><size><width>30</width><height>30</height>"
            f"<depth>3</depth></size>{body}</annotation>")
    main = root / "ImageSets" / "Main"
    main.joinpath("train.txt").write_text("000001\n000002\n")
    main.joinpath("val.txt").write_text("000003 1\n")
    main.joinpath("trainval.txt").write_text("\n".join(ids) + "\n")
    lst = root / "trainval.txt"
    lst.write_text("\n".join(ids) + "\n")
    return str(lst), str(root)


def _npy_images(cls):
    """The dataset reading <id>.jpg.npy where the JPEG is absent (the
    JAX tests' trick, tests/test_legacy2d_data.py:82-90)."""

    class Npy(cls):
        def __getitem__(self, idx):
            info = self.img_infos[idx]
            path = os.path.join(self.img_prefix, info["file_name"])
            if not os.path.exists(path):
                info = dict(info, file_name=info["file_name"] + ".npy")
            saved, self.img_infos = self.img_infos, list(self.img_infos)
            self.img_infos[idx] = info
            try:
                return super().__getitem__(idx)
            finally:
                self.img_infos = saved

    return Npy


@pytest.mark.parametrize("test_mode", [False, True])
def test_voc_samples_match_jax(tmp_path, test_mode):
    """VOCDataset: labels by VOC_CLASSES, 0-based corners, difficult
    boxes kept apart and out of the gt; samples equal to JAX's (the
    JPEG decoded by PIL in both)."""
    lst, root = _voc_tree(tmp_path)
    assert legacy2d.VOC_CLASSES == jlegacy2d.VOC_CLASSES
    ours = _npy_images(legacy2d.VOCDataset)(lst, root, NORM, max_gt=4,
                                            test_mode=test_mode)
    theirs = _npy_images(jlegacy2d.VOCDataset)(lst, root, NORM, max_gt=4,
                                               test_mode=test_mode)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _same(ours.get_ann_info(i), theirs.get_ann_info(i))
        _same(ours[i], theirs[i])
    ann = ours.get_ann_info(0)
    assert ann["labels"].tolist() == [legacy2d.VOC_CLASSES.index("dog") + 1]
    np.testing.assert_array_equal(ann["bboxes"][0], [4, 5, 14, 17])
    assert ann["bboxes_ignore"].shape == (1, 4)
    if not test_mode:
        assert ours[1]["gt_valid"].sum() == 2  # the difficult car left out
        assert ours[0]["imgs"].shape == (1, 32, 32, 3)


def test_xml_dataset_unknown_class_is_background(tmp_path):
    """XMLDataset with its own CLASSES: a name outside them labels 0."""
    lst, root = _voc_tree(tmp_path)

    class Pets(legacy2d.XMLDataset):
        CLASSES = ("dog", "cat")

    ann = Pets(lst, root, NORM).get_ann_info(1)
    assert ann["labels"].tolist() == [1, 0]


def test_concat_and_repeat_index_as_jax(tmp_path):
    lst, root = _voc_tree(tmp_path)
    ours = _npy_images(legacy2d.VOCDataset)(lst, root, NORM, max_gt=4)
    theirs = _npy_images(jlegacy2d.VOCDataset)(lst, root, NORM, max_gt=4)
    for wrap, jwrap in ((lambda d: legacy2d.ConcatDataset([d, d]),
                         lambda d: jlegacy2d.ConcatDataset([d, d])),
                        (lambda d: legacy2d.RepeatDataset(d, 3),
                         lambda d: jlegacy2d.RepeatDataset(d, 3))):
        a, b = wrap(ours), jwrap(theirs)
        assert len(a) == len(b) in (6, 9)
        for i in range(len(a)):
            _same(a[i], b[i])
    cat = legacy2d.ConcatDataset([ours, legacy2d.RepeatDataset(ours, 2)])
    assert len(cat) == 9
    _same(cat[5], ours[2])
    ours.test_mode = True
    _same(cat.prepare_test(8), ours.prepare_test(2))
    assert len(legacy2d.ConcatDataset([])) == 0


def _run_jax_tool(rel, argv):
    """Runs a JAX tool's main() with argv; returns its stdout."""
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = [str(path), *argv]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def test_voc_eval_matches_the_jax_tool(tmp_path):
    """Both tools on the same results pickle (7-wide depth-1 rows) and
    VOC tree: the same printed table, per-class lines and mAP."""
    lst, root = _voc_tree(tmp_path / "voc")
    names = legacy2d.VOC_CLASSES
    rng = np.random.RandomState(3)
    results = []
    for boxes in ([[4, 5, 14, 17]], [[2, 2, 19, 24], [9, 1, 27, 8]],
                  [[3, 3, 25, 27]]):
        per_class = [np.zeros((0, 7), np.float32) for _ in names]
        for k, (b, cls) in enumerate(zip(boxes, ("dog", "car"))):
            rows = [list(b) + [0, 0, 0.9 - 0.1 * k]]
            rows += [[*(np.array(b) + rng.uniform(-6, 6, 4)), 0, 0,
                      float(rng.uniform(0.05, 0.8))] for _ in range(3)]
            per_class[names.index(cls)] = np.array(rows, np.float32)
        per_class[names.index("person")] = np.array(
            [[3, 3, 25, 27, 0, 0, 0.7]], np.float32)
        results.append(per_class)
    res = tmp_path / "results.pkl"
    with open(res, "wb") as f:
        pickle.dump(results, f)
    want = _run_jax_tool("tools/voc_eval.py", [str(res), lst, root])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mean_ap, _ = voc_eval.main([str(res), lst, root])
    assert out.getvalue() == want
    assert 0.0 < mean_ap < 1.0
    assert "dog" in want and "mAP" in want


def test_pascal_voc_conversion_matches_the_jax_tool(tmp_path):
    _, root = _voc_tree(tmp_path / "voc")
    want_out = _run_jax_tool("tools/convert_datasets/pascal_voc.py",
                             [root, str(tmp_path / "jax")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        written = pascal_voc.main([root, str(tmp_path / "port")])
    assert sorted(written) == ["train", "trainval", "val"]
    for split in written:
        a = (tmp_path / "port" / f"{split}.txt").read_text()
        assert a == (tmp_path / "jax" / f"{split}.txt").read_text()
    assert (tmp_path / "port" / "val.txt").read_text() == "000003\n"
    assert out.getvalue().replace(str(tmp_path / "port"), "X") == \
        want_out.replace(str(tmp_path / "jax"), "X")


def test_train_detector_on_coco2d(coco2d_root, tmp_path):
    """The 2-D end-to-end path through the API: two iterations of the
    narrow FasterRCNN on a Coco2DDataset, batch 2, on the CPU; finite
    losses, a checkpoint written."""
    from mrcnn3d_torch.apis.train_api import train_detector

    ann, root = coco2d_root
    cfg = two_d_narrow(two_d_config("FasterRCNN", TConfig))
    cfg.data["imgs_per_gpu"] = 2
    cfg.data["workers_per_gpu"] = 0
    ds = coco3d.Coco2DDataset(ann, root, cfg.data["train"]["img_norm_cfg"],
                              with_mask=False, max_gt=4)
    stats = {}
    state = train_detector(cfg, ds, work_dir=str(tmp_path / "work"),
                           max_iters=2, device="cpu", stats=stats,
                           log_interval=1)
    assert stats["iters"] == 2 and state.step == 2
    assert all(np.isfinite(stats["losses"]))
    assert any(os.scandir(tmp_path / "work"))
    assert torch.isfinite(state.model.backbone.conv1.weight).all()
