"""The RGB 2.5-D family (MaskRCNNRGB, MaskRCNNRGB2) against the JAX
package, on the CPU, with the harness of
`test_torch_port_two_d_detectors_a.py`.

Each type's config is `chip_smoke.two_d_config` (configs/faster_rcnn_2d.py
with the type set and the mask recipe of the JAX tests,
tests/test_variants.py:292-312) cut by `chip_smoke.two_d_narrow` to the
JAX tests' cfg2d: ResNet-18 at base width 8, FPN 32, 3 classes, budgets
32, a 1x64x64 image.  One backbone and FPN pass, then a head set per
slice (rpn_head, rpn_head_2, rpn_head_3, ...).

  * inference: per slice (dets_r, ..., mask_logits_b) `valid` and
    `labels` equal, `dets` and `mask_logits` of valid rows within 2e-3;
    dets / labels / valid are slice r's; the port's decisions first
    survive a 1e-5 change of the input;
  * training (two images, the blue slice without gt,
    `chip_smoke.two_d_train_batch`): the samplers replay JAX's RGB key
    tree (`test_torch_port_targets.rgb_draws`), each _r/_g/_b loss within
    2e-3, each parameter's gradient within 2e-3 of the JAX gradient's
    largest (`chip_smoke.JAX_UPDATE_TOL` for the stem conv), the blue
    slice's losses 0 and its heads' gradients 0;
  * `CocoRGBDataset` equal to JAX's on tests/test_legacy2d_data.py's
    fixture recipe, and batched by the port's loader;
  * the evaluation runner on a CocoRGBDataset sample: slice r's
    detections, where the JAX package's runner asks the sample for an
    `imgs_2` twin it does not have (`mrcnn3d/apis/test_api.py:66`).
"""
import json

import numpy as np
import torch

from chip_smoke import RGB_SUFFIXES
from mrcnn3d.data import legacy2d as jlegacy2d
from mrcnn3d_torch.data import legacy2d
from mrcnn3d_torch.data.loader import Prefetcher
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.utils.config import Config as TConfig
from test_torch_port_two_d_detectors_a import (
    cfg_of,
    check_inference,
    check_one_step,
    check_training,
)
from torch_port_fixtures import torch_threads  # noqa: F401

HEADS = ("rpn_head", "bbox_head", "mask_head")


def test_rgb_types_build_as_jax():
    """Three unshared head sets over one backbone and FPN; one anchor
    config (the slices share the image), as the JAX package's
    anchor_cfgs gives it.  With them the port builds every type of the
    JAX package's table."""
    from mrcnn3d.detectors.build import _TYPES
    from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
    from mrcnn3d.utils.config import Config as JConfig
    from mrcnn3d_torch.detectors.build import SUPPORTED, anchor_cfgs

    assert set(SUPPORTED) == set(_TYPES)

    for type_name in ("MaskRCNNRGB", "MaskRCNNRGB2"):
        model = build_detector(cfg_of(type_name, TConfig), device="cpu")
        assert model.rgb and model.num_scales == 3 and not model.share_heads
        names = {n.split(".")[0] for n, _ in model.named_parameters()}
        assert names == {"backbone", "neck"} | {
            h + sfx for h in HEADS for sfx in ("", "_2", "_3")}
        assert len(anchor_cfgs(cfg_of(type_name, TConfig))) == len(
            j_anchor_cfgs(cfg_of(type_name, JConfig))) == 1


def _check_rgb_inference(type_name):
    got = check_inference(type_name)
    assert {"dets" + s for s in RGB_SUFFIXES} <= set(got)
    assert "mask_logits" not in got
    for k in ("dets", "labels", "valid"):
        np.testing.assert_array_equal(got[k], got[k + "_r"])
    for sfx in RGB_SUFFIXES:
        assert got["mask_logits" + sfx].shape[1:] == (3, 1, 28, 28)


def test_mask_rcnn_rgb_simple_test_matches_jax():
    _check_rgb_inference("MaskRCNNRGB")


def test_mask_rcnn_rgb2_simple_test_matches_jax():
    _check_rgb_inference("MaskRCNNRGB2")


def test_mask_rcnn_rgb_forward_train_matches_jax():
    """check_training on a batch whose blue slice has no gt: the blue
    slice's losses and its heads' gradients are 0 in both packages."""
    losses, grads = check_training("MaskRCNNRGB")
    want = {f"loss_{k}{s}" for k in ("rpn_cls", "rpn_reg", "cls", "reg",
                                     "mask") for s in RGB_SUFFIXES}
    assert want | {f"acc{s}" for s in RGB_SUFFIXES} == set(losses)
    for k in want:
        assert (losses[k] == 0) == k.endswith("_b"), (k, losses[k])
    for h in HEADS:
        for head, zero in ((h, False), (h + "_2", False), (h + "_3", True)):
            g = max(float(v.abs().max()) for n, v in grads.items()
                    if n.split(".")[0] == head)
            assert (g == 0) == zero, (head, g)


def test_mask_rcnn_rgb2_train_step():
    losses, moved = check_one_step("MaskRCNNRGB2")
    assert {"loss_mask_r", "loss_mask_g", "loss_mask_b"} <= set(losses)
    assert float(losses["loss_mask_b"]) == 0.0
    assert "mask_head_2.conv_logits.weight" in moved


def _rgb_root(tmp_path):
    """tests/test_legacy2d_data.py's fixture: one 40x48 image, an r and
    a g annotation; plus an image without any (dropped in training) and
    one with slice-less and b annotations."""
    rng = np.random.RandomState(0)
    np.save(tmp_path / "img0.npy",
            (rng.rand(40, 48, 3) * 255).astype(np.uint8))
    np.save(tmp_path / "img1.npy",
            (rng.rand(40, 48, 3) * 255).astype(np.uint8))
    np.save(tmp_path / "img2.npy", (rng.rand(33, 30) * 255).astype(np.uint8))
    coco = dict(
        images=[dict(id=1, file_name="img0.npy", width=48, height=40),
                dict(id=2, file_name="img1.npy", width=48, height=40),
                dict(id=3, file_name="img2.npy", width=30, height=33)],
        annotations=[
            dict(id=1, image_id=1, category_id=1, bbox=[4, 4, 10, 12],
                 slice_label="r"),
            dict(id=2, image_id=1, category_id=1, bbox=[20, 8, 8, 8],
                 slice_label="g"),
            dict(id=3, image_id=3, category_id=2, bbox=[1.5, 2, 7, 9]),
            dict(id=4, image_id=3, category_id=1, bbox=[5, 6, 12, 3],
                 slice_label="b"),
        ],
        categories=[dict(id=1, name="lesion"), dict(id=2, name="other")],
    )
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(coco))
    return str(ann), str(tmp_path)


def test_coco_rgb_dataset_matches_jax(tmp_path):
    ann, root = _rgb_root(tmp_path)
    norm = dict(mean=[10.0, 10.0, 10.0], std=[2.0, 2.0, 2.0], to_rgb=True)
    for test_mode in (False, True):
        ours = legacy2d.CocoRGBDataset(ann, root, norm, max_gt=4,
                                       test_mode=test_mode)
        theirs = jlegacy2d.CocoRGBDataset(ann, root, norm, max_gt=4,
                                          test_mode=test_mode)
        assert len(ours) == len(theirs) == (3 if test_mode else 2)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
    s = legacy2d.CocoRGBDataset(ann, root, norm, max_gt=4)[0]
    assert s["imgs"].shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(s["gt_boxes_r"][0], [4, 4, 13, 15, 0, 0])
    assert [int(s["gt_valid" + x].sum()) for x in RGB_SUFFIXES] == [1, 1, 0]
    ds = legacy2d.CocoRGBDataset(ann, root, norm, max_gt=4,
                                 size_divisor=64)
    loader = Prefetcher(ds, 2, shuffle=False, device="cpu")
    batch = next(iter(loader))
    loader.close()
    assert batch["imgs"].shape == (2, 3, 1, 64, 64)
    assert batch["gt_boxes_b"].shape == (2, 4, 6)
    assert batch["gt_valid_b"].tolist() == [[False] * 4,
                                            [True, False, False, False]]


def test_inference_runner_takes_an_rgb_sample(tmp_path):
    """The evaluation runner on a CocoRGBDataset test sample: the JAX
    package's runner reads sample["imgs_2"] for every type of two or more
    scales and raises KeyError; the port's feeds the one image and
    returns slice r's detections (those of `simple_test`)."""
    import pytest

    from mrcnn3d.apis.test_api import InferenceRunner as JRunner
    from mrcnn3d.detectors.build import build_detector as j_build
    from mrcnn3d.utils.config import Config as JConfig
    from mrcnn3d_torch.apis.test_api import InferenceRunner
    from mrcnn3d_torch.entry import Flagship

    ann, root = _rgb_root(tmp_path)
    norm = dict(mean=[10.0, 10.0, 10.0], std=[2.0, 2.0, 2.0], to_rgb=True)
    sample = legacy2d.CocoRGBDataset(ann, root, norm, test_mode=True)[0]
    assert "imgs_2" not in sample
    jcfg = cfg_of("MaskRCNNRGB", JConfig)
    with pytest.raises(KeyError, match="imgs_2"):
        JRunner(jcfg, j_build(jcfg), None)(sample)
    cfg = cfg_of("MaskRCNNRGB", TConfig)
    model = build_detector(cfg, device="cpu")
    dets, labels, valid = InferenceRunner(cfg, model)(sample)[:3]
    x = torch.from_numpy(sample["imgs"]).permute(3, 0, 1, 2)[None]
    want = Flagship(cfg, model, torch.device("cpu")).simple_test(
        {"imgs": x})
    np.testing.assert_array_equal(dets, want["dets_r"][0].numpy())
    np.testing.assert_array_equal(valid, want["valid_r"][0].numpy())
    assert valid.any()
