"""The parcellation detector (MaskRCNN3DParcel, 15 brain regions by
default) against the JAX package, on the CPU: its inference (the region
scores ride through NMS by source row), its training (the parcellation
loss and accuracy), its dataset (each instance's brain_region through
the crop as a second label column) and the loader's collation.  The
recipe, the geometry and the tolerances are those of
`test_torch_port_variants_single.py`."""
import json

import numpy as np
import pytest
import torch

from mrcnn3d.data.coco3d import Coco3DParcelDataset as JDataset
from mrcnn3d_torch.data.coco3d import Coco3DParcelDataset as TDataset
from mrcnn3d_torch.data.loader import collate, to_device
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.detectors.build import DEFAULT_PARCELLATIONS
from test_torch_port_variants_single import (
    check_draw_margin,
    check_gradients,
    check_inference,
    check_losses,
    port_model,
    port_train,
    train_pair,
)
from test_torch_port_variants_three import CROP, NORM, assert_samples_equal
from torch_port_fixtures import torch_threads  # noqa: F401

TYPE = "MaskRCNN3DParcel"


def test_simple_test_matches_jax():
    got = check_inference(TYPE)
    p = got["parcellations"]
    assert p.shape == got["dets"].shape[:2] + (DEFAULT_PARCELLATIONS,)
    np.testing.assert_allclose(p[got["valid"]].sum(-1), 1.0, atol=1e-5)


def test_forward_train_losses_match_jax():
    losses = check_losses(TYPE)
    assert {"loss_parcellation_cls", "acc_parcellation", "loss_mask"} \
        <= set(losses)
    assert losses["loss_parcellation_cls"] > 0


def test_gradients_match_jax():
    grads = check_gradients(TYPE)
    g = grads["bbox_head.fc_parcellations.weight"]
    assert g.shape == (DEFAULT_PARCELLATIONS, 32) and g.abs().max() > 0


def test_draws_have_margin():
    check_draw_margin(TYPE)


def test_parcellation_targets_follow_the_samples():
    """Without gt_bregions there is no parcellation loss; a positive
    sample's target is its own gt's region (`take_along_axis(gt_bregions,
    gt_idx)`): moving every region by one moves the loss."""
    pair = train_pair(TYPE)
    batch = {k: v for k, v in pair["batch"].items() if k != "gt_bregions"}
    assert "loss_parcellation_cls" not in port_train(TYPE, batch,
                                                     pair["rng"])[0]
    shifted = dict(pair["batch"])
    shifted["gt_bregions"] = (shifted["gt_bregions"] + 1) % \
        DEFAULT_PARCELLATIONS
    moved = port_train(TYPE, shifted, pair["rng"])[0]
    assert moved["loss_parcellation_cls"] != \
        pair["port"][0]["loss_parcellation_cls"]


def test_port_model_has_the_region_branch():
    model = port_model(TYPE)[1]
    assert model.num_parcellations == DEFAULT_PARCELLATIONS
    assert model.bbox_head.fc_parcellations.out_features == 15


@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    """A synthetic set whose instances carry brain_region 1-14."""
    root = tmp_path_factory.mktemp("parcel")
    ann, img_dir = make_synthetic_coco3d(
        str(root), num_volumes=3, hw=96, depth=12,
        lesions_per_volume=(2, 5), seed=3)
    with open(ann) as f:
        coco = json.load(f)
    for i, a in enumerate(coco["annotations"]):
        a["brain_region"] = 1 + (7 * i) % 14
    with open(ann, "w") as f:
        json.dump(coco, f)
    return ann, img_dir


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
def test_parcel_dataset_matches_jax(regions, test_mode):
    ann, img_dir = regions
    kw = dict(img_norm_cfg=NORM, test_mode=test_mode)
    if test_mode:
        kw["with_mask"] = False
    else:
        kw.update(max_gt=6, extra_aug=CROP, seed=5)
    jds, tds = JDataset(ann, img_dir, **kw), TDataset(ann, img_dir, **kw)
    for idx in (0, 2, 1, 0):
        want, got = jds[idx], tds[idx]
        assert_samples_equal(want, got)
        if not test_mode:
            assert got["gt_labels"].ndim == 1
            v = got["gt_valid"]
            assert (got["gt_bregions"][v] >= 1).all()
            assert not got["gt_bregions"][~v].any()


def test_loader_collates_regions_and_the_third_volume():
    """collate stacks gt_bregions and imgs_3; to_device lays imgs_3 out
    NCDHW like the other volumes."""
    rng = np.random.RandomState(0)
    samples = [dict(imgs=rng.randn(4, 8, 8, 3).astype(np.float32),
                    imgs_3=rng.randn(9, 18, 18, 3).astype(np.float32),
                    gt_bregions=np.arange(3, dtype=np.int32) + i)
               for i in range(2)]
    batch = to_device(collate(samples), torch.device("cpu"))
    assert batch["gt_bregions"].tolist() == [[0, 1, 2], [1, 2, 3]]
    assert batch["imgs_3"].shape == (2, 3, 9, 18, 18)
    assert torch.equal(batch["imgs_3"][1].permute(1, 2, 3, 0),
                       torch.from_numpy(samples[1]["imgs_3"]))
