"""The port's data pipeline against the JAX package's, on the same seeds:
the synthetic generator byte for byte, the crop augmentation draw for
draw, the datasets' samples, the epoch shards, collation and the
single-worker prefetcher exactly; and the pinned learning data's hash.
"""
import json
import os

import numpy as np
import pytest
import torch

from mrcnn3d.data import coco3d as jcoco3d
from mrcnn3d.data import loader as jloader
from mrcnn3d.data import random_crop3d as jcrop
from mrcnn3d.data import synthetic as jsynthetic
from mrcnn3d_torch.data import coco3d, loader, random_crop3d, synthetic
from mrcnn3d_torch.data.transforms import pad_gt
from torch_port_fixtures import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
CROP = dict(random_crop_3d=dict(min_ious=(0.1, 0.3, 0.5, 0.7, 0.9)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _generate(make, make_scaled, root):
    ann, img_dir = make(str(root), num_volumes=3, hw=96, depth=12,
                        lesions_per_volume=(2, 5), seed=4)
    make_scaled(ann, img_dir, str(root) + "_1dot5x", 1.5)
    return ann, img_dir


def test_synthetic_byte_identical(tmp_path):
    """Same files, same bytes; the json differs only by its root."""
    a, b = tmp_path / "jax", tmp_path / "port"
    _generate(jsynthetic.make_synthetic_coco3d,
              jsynthetic.make_synthetic_coco3d_scaled, a)
    _generate(synthetic.make_synthetic_coco3d,
              synthetic.make_synthetic_coco3d_scaled, b)
    for ra, rb in ((a, b), (f"{a}_1dot5x", f"{b}_1dot5x")):
        files = _files(ra)
        assert files == _files(rb) and len(files) > 5
        for f in files:
            da = open(os.path.join(ra, f), "rb").read()
            db = open(os.path.join(rb, f), "rb").read()
            if f.endswith(".json"):
                da = da.replace(str(a).encode(), str(b).encode())
            assert da == db, f


def _boxes(rng, n, hw, depth, big=False):
    """n boxes in an (hw, hw, depth) volume; `big` ones wider than the
    quarter crop, so that no crop can hold one (the None path)."""
    size = rng.uniform(hw / 4 + 1, hw / 3, (n, 2)) if big \
        else rng.uniform(2, hw / 6, (n, 2))
    lo = rng.uniform(0, hw - size - 1, (n, 2))
    z = rng.uniform(0, depth / 2, (n, 1))
    return np.concatenate(
        [lo, lo + size, z, z + rng.uniform(1, depth / 2 - 1, (n, 1))], 1
    ).astype(np.float32)


@pytest.mark.parametrize("draw", range(20))
def test_crop_and_photometric_equal(draw):
    """RandomCrop3D and PhotoMetricDistortion3D from one seed: the same
    crop, boxes, labels, masks and intensities; every fifth draw has only
    boxes no crop can hold, and both return None."""
    rng = np.random.RandomState(100 + draw)
    hw, depth = 64, 10
    big = draw % 5 == 4
    boxes = _boxes(rng, rng.randint(1, 5), hw, depth, big)
    labels = np.arange(1, len(boxes) + 1, dtype=np.int32)
    img = rng.normal(100, 20, (hw, hw, depth)).astype(np.float32)
    masks = [(rng.rand(hw, hw, depth) > 0.9).astype(np.uint8)
             for _ in boxes]
    outs = []
    for mod in (jcrop, random_crop3d):
        aug = mod.ExtraAugmentation3D(
            photo_metric_distortion=dict(brightness_delta=32),
            random_crop_3d=dict(min_ious=(0.1, 0.3, 0.5, 0.7, 0.9)),
            rng=np.random.RandomState(draw))
        outs.append(aug(img, boxes, labels, masks))
    want, got = outs
    if big:
        assert want is None and got is None
        return
    assert want is not None and got is not None
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(w, g)
        assert w.dtype == g.dtype
    assert len(want[3]) == len(got[3]) == len(got[1]) > 0
    for w, g in zip(want[3], got[3]):
        np.testing.assert_array_equal(w, g)


def test_pad_gt_equal():
    from mrcnn3d.data.transforms import pad_gt as jpad_gt

    rng = np.random.RandomState(0)
    boxes = rng.rand(5, 6).astype(np.float32)
    masks = [(rng.rand(4, 6, 8) > 0.5).astype(np.uint8) for _ in range(5)]
    for max_gt in (3, 8):
        want = jpad_gt(boxes, np.arange(5), max_gt, masks, (4, 6, 8))
        got = pad_gt(boxes, np.arange(5), max_gt, masks, (4, 6, 8))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(want[k], got[k])
            assert want[k].dtype == got[k].dtype


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    ann, img_dir = synthetic.make_synthetic_coco3d(
        str(root), num_volumes=4, hw=96, depth=12, lesions_per_volume=(2, 5),
        seed=3)
    ann2, img_dir2 = synthetic.make_synthetic_coco3d_scaled(
        ann, img_dir, str(root) + "_1dot5x", 1.5)
    return ann, img_dir, ann2, img_dir2


def _train_sets(synth, seed=5):
    ann, img_dir = synth[:2]
    kw = dict(img_norm_cfg=NORM, max_gt=6, extra_aug=CROP, seed=seed)
    return (jcoco3d.Coco3D2ScalesDataset(ann, img_dir, **kw),
            coco3d.Coco3D2ScalesDataset(ann, img_dir, **kw))


def _assert_samples_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
            assert want[k].dtype == got[k].dtype, k
        else:
            assert want[k] == got[k], k


def test_train_samples_equal(synth):
    """Six draws in sequence (crops, the 1.5x twin, every gt array) from
    one seed, with max_gt below some volumes' lesion count."""
    jds, tds = _train_sets(synth)
    assert len(jds) == len(tds) == 4
    for idx in (0, 1, 3, 2, 0, 1):
        want, got = jds[idx], tds[idx]
        assert set(got) == {"imgs", "imgs_2", "gt_boxes", "gt_labels",
                            "gt_valid", "gt_masks", "gt_boxes_2",
                            "gt_labels_2", "gt_valid_2"}
        assert got["imgs"].shape == (12, 32, 32, 3)
        assert got["imgs_2"].shape == (18, 64, 64, 3)
        assert got["gt_masks"].shape == (6, 12, 32, 32)
        _assert_samples_equal(want, got)


def test_retry_draws_another_index(tmp_path):
    """A volume whose lesions no crop can hold: __getitem__ retries
    another index from the dataset's RandomState, as the JAX package's."""
    ann, img_dir = synthetic.make_synthetic_coco3d(
        str(tmp_path), num_volumes=3, hw=64, depth=12,
        lesions_per_volume=(2, 3), seed=1)
    with open(ann) as f:
        coco = json.load(f)
    for a in coco["annotations"]:
        if a["image_id"] == 1:   # wider than the 16-voxel quarter crop
            a["bbox"][2] = 20
    with open(ann, "w") as f:
        json.dump(coco, f)
    kw = dict(img_norm_cfg=NORM, max_gt=4, extra_aug=CROP, seed=2)
    jds = jcoco3d.Coco3D2ScalesDataset(ann, img_dir, **kw)
    tds = coco3d.Coco3D2ScalesDataset(ann, img_dir, **kw)
    assert tds.prepare_train(0) is None
    jds.prepare_train(0)
    for _ in range(3):
        _assert_samples_equal(jds[0], tds[0])


def test_test_samples_equal(synth):
    """Test mode: the derived twin, and the filename-matched 1.5x set."""
    ann, img_dir, ann2, img_dir2 = synth
    kw = dict(img_norm_cfg=NORM, with_mask=False, test_mode=True)
    for extra in ({}, dict(ann_file_2=ann2, img_prefix_2=img_dir2)):
        jds = jcoco3d.Coco3D2ScalesDataset(ann, img_dir, **kw, **extra)
        tds = coco3d.Coco3D2ScalesDataset(ann, img_dir, **kw, **extra)
        for idx in (0, 3):
            want, got = jds[idx], tds[idx]
            assert got["imgs_2"].shape == (18, 160, 160, 3)
            _assert_samples_equal(want, got)


def test_epoch_indices_and_collate_equal(synth):
    for n, epoch, shuffle, rank, world in [(7, 0, True, 0, 1),
                                           (7, 3, True, 1, 2),
                                           (10, 1, False, 2, 4),
                                           (12, 5, True, 0, 1)]:
        np.testing.assert_array_equal(
            jloader.epoch_indices(n, epoch, shuffle, rank, world, seed=9),
            loader.epoch_indices(n, epoch, shuffle, rank, world, seed=9))
    ann, img_dir = synth[:2]
    ds = coco3d.Coco3D2ScalesDataset(ann, img_dir, img_norm_cfg=NORM,
                                     with_mask=False, test_mode=True)
    samples = [ds[0], ds[1]]
    want, got = jloader.collate(samples), loader.collate(samples)
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], list):
            assert want[k] == got[k]
        else:
            np.testing.assert_array_equal(want[k], got[k])


def test_prefetcher_equal_jax(synth):
    """One worker, two epochs of batches of 2: the port's numpy batches
    equal the JAX package's; on a device (the CPU here) each array is a
    tensor with the same values, the volumes NCDHW."""
    jds, tds = _train_sets(synth, seed=11)
    _, tds_dev = _train_sets(synth, seed=11)
    for epoch in (0, 1):
        want = list(jloader.Prefetcher(jds, 2, epoch=epoch, seed=3,
                                       num_workers=1, device_put=False))
        got = list(loader.Prefetcher(tds, 2, epoch=epoch, seed=3,
                                     num_workers=1))
        dev = list(loader.Prefetcher(tds_dev, 2, epoch=epoch, seed=3,
                                     num_workers=1, device="cpu"))
        assert len(want) == len(got) == len(dev) == 2
        for w, g, d in zip(want, got, dev):
            _assert_samples_equal(w, g)
            for k, v in d.items():
                assert isinstance(v, torch.Tensor)
                t = v.permute(0, 2, 3, 4, 1) if k.startswith("imgs") else v
                np.testing.assert_array_equal(t.numpy(), g[k], err_msg=k)
            assert d["imgs"].shape[1] == 3
            assert d["imgs"].is_contiguous(
                memory_format=torch.channels_last_3d)


def test_prefetcher_process_mode(synth):
    """Spawned workers (each loads the host runtime itself) give the
    thread mode's batches on a dataset without randomness."""
    ann, img_dir = synth[:2]
    ds = coco3d.Coco3D2ScalesDataset(ann, img_dir, img_norm_cfg=NORM,
                                     with_mask=False, test_mode=True)
    kw = dict(shuffle=False, num_workers=2)
    want = list(loader.Prefetcher(ds, 2, mode="thread", **kw))
    got = list(loader.Prefetcher(ds, 2, mode="process", **kw))
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        _assert_samples_equal(w, g)


class _Broken:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise ValueError("bad sample 2")
        return dict(x=np.full((2,), i))


def test_prefetcher_close_ends_the_producer(synth):
    """A consumer that stops after one batch: close() ends the producer
    thread, which was blocked on the full queue."""
    _, tds = _train_sets(synth)
    pf = loader.Prefetcher(tds, 1, num_workers=1, depth=1)
    next(iter(pf))
    pf.close(timeout=10)
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_worker_errors():
    it = iter(loader.Prefetcher(_Broken(), 1, shuffle=False, num_workers=1))
    assert [int(next(it)["x"][0, 0]) for _ in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="bad sample 2"):
        next(it)


def test_pinned_data_hash(tmp_path):
    """The port's generator reproduces the pinned learning data:
    LEARNING.json's data_sha256 (train, val and the 1.5x val twin)."""
    from mrcnn3d_torch.tools.learning_bench import (
        PINNED_SHA256,
        generate_pinned_data,
    )

    with open(os.path.join(REPO, "LEARNING.json")) as f:
        pinned = json.load(f)["data_sha256"]
    assert PINNED_SHA256 == pinned
    assert generate_pinned_data(str(tmp_path))[0] == pinned
