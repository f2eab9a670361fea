"""The 3-D two-stage variants against the JAX package, on the CPU: the
three-scale group (separate heads; one shared pathway), whose third
volume is the 2.25x twin; and the three-scale dataset.  The recipe, the
geometry and the tolerances are those of
`test_torch_port_variants_single.py`."""
import numpy as np
import pytest

from mrcnn3d.data.coco3d import Coco3D3ScalesDataset as JDataset
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.data.coco3d import Coco3D3ScalesDataset as TDataset
from test_torch_port_variants_single import (
    check_draw_margin,
    check_gradients,
    check_inference,
    check_losses,
)
from torch_port_fixtures import torch_threads  # noqa: F401

TYPES = ("MaskRCNN3D3ScalesHeads", "MaskRCNN3D3ScalesOnePathway")


@pytest.mark.parametrize("type_name", TYPES)
def test_simple_test_matches_jax(type_name):
    assert "mask_logits" in check_inference(type_name)


@pytest.mark.parametrize("type_name", TYPES)
def test_forward_train_losses_match_jax(type_name):
    keys = {k for k in check_losses(type_name) if "loss" in k}
    assert {"loss_rpn_cls_3", "loss_rpn_reg_3", "loss_mask"} <= keys
    assert ("loss_cls_3" in keys) == (type_name == "MaskRCNN3D3ScalesHeads")
    assert "loss_refinement_reg" not in keys


@pytest.mark.parametrize("type_name", TYPES)
def test_gradients_match_jax(type_name):
    grads = check_gradients(type_name)
    heads = {n.split(".")[0] for n in grads}
    assert {"rpn_head", "rpn_head_2", "rpn_head_3"} <= heads
    assert ("bbox_head_3" in heads) == (type_name == "MaskRCNN3D3ScalesHeads")


@pytest.mark.parametrize("type_name", TYPES)
def test_draws_have_margin(type_name):
    check_draw_margin(type_name)


NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
CROP = dict(random_crop_3d=dict(min_ious=(0.1, 0.3, 0.5, 0.7, 0.9)))


def assert_samples_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
            assert want[k].dtype == got[k].dtype, k
        else:
            assert want[k] == got[k], k


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
def test_three_scale_dataset_matches_jax(tmp_path, test_mode):
    """Coco3D3ScalesDataset from one seed: the same crops, the 1.5x and
    2.25x twins (the port's host runtime) and every gt array, in draws
    in sequence."""
    ann, img_dir = make_synthetic_coco3d(
        str(tmp_path), num_volumes=3, hw=96, depth=12,
        lesions_per_volume=(2, 5), seed=3)
    kw = dict(img_norm_cfg=NORM, test_mode=test_mode)
    if test_mode:
        kw["with_mask"] = False
    else:
        kw.update(max_gt=6, extra_aug=CROP, seed=5)
    jds, tds = JDataset(ann, img_dir, **kw), TDataset(ann, img_dir, **kw)
    for idx in (0, 2, 1, 0):
        want, got = jds[idx], tds[idx]
        assert {"imgs", "imgs_2", "imgs_3"} <= set(got)
        if not test_mode:
            assert {"gt_boxes_3", "gt_labels_3", "gt_valid_3"} <= set(got)
            np.testing.assert_array_equal(
                got["gt_boxes_3"], got["gt_boxes"] * np.float32(2.25))
        assert_samples_equal(want, got)
