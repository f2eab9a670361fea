"""The port's evaluation modules against the JAX package, exactly.

Masks (`eval.masks`), result assembly and the merge NMS
(`eval.results`), the 3-D COCO evaluator (`eval.coco_eval3d`: all 29
stats, bbox and segm, full-volume masks and {box, mask, shape}
carriers), the host transforms and the A2 box helpers, on seeded numpy
inputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrcnn3d.data import transforms as jtransforms
from mrcnn3d.eval import coco_eval3d as jcoco
from mrcnn3d.eval import masks as jmasks
from mrcnn3d.eval import results as jresults
from mrcnn3d.ops import box3d as jbox
from mrcnn3d_torch.data import transforms
from mrcnn3d_torch.eval import coco_eval3d as coco
from mrcnn3d_torch.eval import masks
from mrcnn3d_torch.eval import results
from mrcnn3d_torch.ops import box3d
from torch_port_fixtures import torch_threads  # noqa: F401

VOL = (12, 40, 36)   # (D, H, W)


def _boxes(rng, n, shape=VOL, scores=True):
    d, h, w = shape
    xy = rng.uniform(-2, min(h, w) - 6, (n, 2))
    z = rng.uniform(-1, d - 3, (n, 1))
    size = rng.uniform(1, 14, (n, 3))
    cols = [xy, xy + size[:, :2], z, z + size[:, 2:] / 3]
    if scores:
        cols.append(rng.rand(n, 1))
    return np.concatenate(cols, 1).astype(np.float32)


def test_box_helpers_equal_jax():
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 50, scores=False) * 1.5 - 3
    img_shape = (40, 36, 3, 12)
    np.testing.assert_array_equal(
        box3d.clip_boxes(torch.from_numpy(boxes), img_shape).numpy(),
        np.asarray(jbox.clip_boxes(jnp.asarray(boxes), img_shape)))
    np.testing.assert_array_equal(box3d.xyxyzz_to_xywhzd(boxes),
                                  jbox.xyxyzz_to_xywhzd(boxes))


def test_transforms_equal_jax():
    rng = np.random.RandomState(1)
    raw = rng.uniform(0, 255, (30, 45, 7)).astype(np.float32)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    img = transforms.normalize_volume(raw, mean, std)
    np.testing.assert_array_equal(img, jtransforms.normalize_volume(
        raw, mean, std))
    for kw in ({}, {"divisor": 16, "depth_divisor": 4}, {"divisor": 5}):
        got, ori = transforms.pad_to_divisor(img, **kw)
        want, jori = jtransforms.pad_to_divisor(img, **kw)
        np.testing.assert_array_equal(got, want)
        assert ori == jori


@pytest.fixture(scope="module")
def dets():
    """20 detection slots, 15 valid, 2 foreground classes (3 in all),
    with mask logits of every class."""
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 20)
    labels = rng.randint(0, 2, 20)
    valid = rng.rand(20) > 0.25
    logits = rng.randn(20, 3, 6, 7, 7).astype(np.float32) * 2
    return boxes, labels, valid, logits


def _equal_box_masks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_masks_equal_jax(dets, scale):
    boxes, labels, valid, logits = dets
    args = (logits, boxes, labels, valid, 0.25, scale)
    _equal_box_masks(masks.get_box_masks_3d(*args),
                     jmasks.get_box_masks_3d(*args))
    # the class slice gathered already, as the tiled driver fetches it
    pre = logits[np.arange(20), labels + 1]
    _equal_box_masks(masks.get_box_masks_3d(pre, *args[1:]),
                     jmasks.get_box_masks_3d(pre, *args[1:]))
    ori = (VOL[1], VOL[2], VOL[0])
    got = masks.get_seg_masks_3d(logits, boxes, labels, valid, 3, ori,
                                 scale_factor=scale)
    want = jmasks.get_seg_masks_3d(logits, boxes, labels, valid, 3, ori,
                                   scale_factor=scale)
    assert [len(c) for c in got] == [len(c) for c in want]
    assert sum(len(c) for c in got) == int(valid.sum())
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)
    per_class = [boxes[valid & (labels == c)] for c in range(2)]
    info = dict(id=3, full_volume_id=9)
    got = masks.segm_entries(got, per_class, info)
    want = jmasks.segm_entries(want, per_class, info)
    assert [{k: v for k, v in e.items() if k != "segmentation"}
            for e in got] == [{k: v for k, v in e.items()
                               if k != "segmentation"} for e in want]


def test_mask_helpers_equal_jax(dets):
    boxes, labels, _, logits = dets
    np.testing.assert_array_equal(masks._sigmoid(logits),
                                  jmasks._sigmoid(logits))
    probs = masks._sigmoid(logits[:, 1])
    for i in range(20):
        box = boxes[i, :6].astype(np.int32)
        mask = masks.box_mask_from_probs(probs[i], box)
        np.testing.assert_array_equal(mask, jmasks.box_mask_from_probs(
            probs[i], box))
        # boxes that cross the volume's far and near edges
        for shift in (np.array([-4, -4, -4, -4, -2, -2]),
                      np.array([30, 30, 30, 30, 9, 9])):
            np.testing.assert_array_equal(
                masks.paste_mask_3d(box + shift, mask, VOL),
                jmasks.paste_mask_3d(box + shift, mask, VOL))


def _patch_results(rng, n_patches, n=12):
    res, infos = [], []
    for p in range(n_patches):
        res.append([_boxes(rng, n), _boxes(rng, rng.randint(0, 4))])
        infos.append(dict(id=p, full_volume_id=p % 2, pos_top=8 * p,
                          pos_left=4 * p, pos_front=p))
    return res, infos


def test_results_equal_jax():
    rng = np.random.RandomState(3)
    res, infos = _patch_results(rng, 5)
    for info, per_class in zip(infos, res):
        assert results.det_entries(per_class, info) == \
            jresults.det_entries(per_class, info)
        assert results.det_entries(per_class, info, [7, 9], 1 / 1.5) == \
            jresults.det_entries(per_class, info, [7, 9], 1 / 1.5)
    entries = [e for per_class, info in zip(res, infos)
               for e in results.det_entries(per_class, info)]
    merged = results.merge_patch_detections(entries)
    assert merged == jresults.merge_patch_detections(entries)
    assert 0 < len(merged) < len(entries)
    for merge in (True, False):
        assert results.results2json3d(res, infos, merge) == \
            jresults.results2json3d(res, infos, merge)
    res2, infos2 = _patch_results(rng, 3)
    for r2 in (res2, None):
        assert results.results2json3d_multi(res, infos, r2, infos2) == \
            jresults.results2json3d_multi(res, infos, r2, infos2)


def _coco_case(seed, carriers):
    """A 3-image gt with lesion boxes and masks, and detections: jittered
    copies of most gts, spurious boxes, and (for segm) masks as
    full-volume arrays or {box, mask, shape} carriers."""
    rng = np.random.RandomState(seed)
    d, h, w = VOL
    anns, dts = [], []
    for img in range(3):
        for j in range(rng.randint(2, 6)):
            lo = np.array([rng.randint(0, w - 10), rng.randint(0, h - 10),
                           rng.randint(0, d - 4)])
            ext = np.array([rng.randint(2, 10), rng.randint(2, 10),
                            rng.randint(1, 4)])
            mask = np.zeros(VOL, np.uint8)
            mask[lo[2]:lo[2] + ext[2], lo[1]:lo[1] + ext[1],
                 lo[0]:lo[0] + ext[0]] = rng.rand(ext[2], ext[1], ext[0]) > .3
            cat = int(rng.randint(1, 3))
            bbox = [float(lo[0]), float(lo[1]), float(ext[0]),
                    float(ext[1]), float(lo[2]), float(ext[2])]
            ann = dict(id=len(anns) + 1, image_id=img, category_id=cat,
                       bbox=bbox, segmentation=mask)
            if rng.rand() < 0.15:
                ann["iscrowd"] = 1
            anns.append(ann)
            if rng.rand() < 0.8:
                jit = rng.randint(-1, 2, 3)
                box = np.concatenate([lo + jit, lo + jit + ext - 1])
                dts.append((img, cat, box, rng.rand()))
        for _ in range(rng.randint(1, 5)):
            lo = np.array([rng.randint(0, w - 10), rng.randint(0, h - 10),
                           rng.randint(0, d - 4)])
            box = np.concatenate([lo, lo + rng.randint(1, 9, 3)])
            dts.append((img, int(rng.randint(1, 3)), box, rng.rand()))
    entries = []
    for img, cat, box, score in dts:
        x0, y0, z0, x1, y1, z1 = (int(v) for v in box)
        xyxyzz = np.array([x0, y0, x1, y1, z0, z1])
        bm = (rng.rand(z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1) > .4).astype(
            np.uint8)
        seg = (dict(box=xyxyzz, mask=bm, shape=VOL) if carriers
               else masks.paste_mask_3d(xyxyzz, bm, VOL))
        entries.append(dict(image_id=img, category_id=cat, score=float(score),
                            bbox=[float(v) for v in
                                  box3d.xyxyzz_to_xywhzd(xyxyzz)],
                            segmentation=seg))
    gt = dict(images=[dict(id=i) for i in range(3)], annotations=anns,
              categories=[dict(id=1), dict(id=2)])
    return gt, entries


@pytest.mark.parametrize("iou_type,carriers", [("bbox", False),
                                               ("segm", False),
                                               ("segm", True)])
def test_coco_eval3d_equals_jax(iou_type, carriers):
    gt, entries = _coco_case(4, carriers)
    ev = coco.CocoEval3D(gt, entries, iou_type)
    jev = jcoco.CocoEval3D(gt, entries, iou_type)
    stats = ev.summarize()
    assert stats.shape == (29,)
    np.testing.assert_array_equal(stats, jev.summarize())
    assert 0 < stats[0] < 1
    assert ev.named_stats(iou_type) == jev.named_stats(iou_type)
    assert ev.best_overlaps == jev.best_overlaps


def test_coco_eval3d_from_json(tmp_path):
    import json

    gt, entries = _coco_case(5, False)
    for a in gt["annotations"]:
        del a["segmentation"]
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    np.testing.assert_array_equal(
        coco.CocoEval3D(str(path), entries).summarize(),
        jcoco.CocoEval3D(str(path), entries).summarize())


def test_iou_helpers_equal_jax():
    rng = np.random.RandomState(6)
    a = box3d.xyxyzz_to_xywhzd(_boxes(rng, 9, scores=False))
    b = box3d.xyxyzz_to_xywhzd(_boxes(rng, 7, scores=False))
    np.testing.assert_array_equal(coco.iou3d_xywhzd(a, b),
                                  jcoco.iou3d_xywhzd(a, b))
    assert coco.iou3d_xywhzd(a, []).shape == (9, 0)
    ma = [(rng.rand(*VOL) > 0.7).astype(np.uint8) for _ in range(4)]
    mb = [(rng.rand(*VOL) > 0.6).astype(np.uint8) for _ in range(3)]
    np.testing.assert_array_equal(coco.voxel_iou(ma, mb),
                                  jcoco.voxel_iou(ma, mb))
