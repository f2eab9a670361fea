"""The 2-D legacy family's detectors against the JAX package, on the
CPU: MaskRCNN (training included), RetinaNet, CascadeRCNN and
HybridTaskCascade, with the harness of
`test_torch_port_two_d_detectors_a.py` (its docstring has the recipe
and the gates)."""
from test_torch_port_two_d_detectors_a import (
    check_inference,
    check_one_step,
    check_training,
)
from torch_port_fixtures import torch_threads  # noqa: F401


def test_mask_rcnn_simple_test_matches_jax():
    """Masks of 1x28x28 per class: the 14x14x1 align through (1, 3, 3)
    convs and the (1, 2, 2) deconv."""
    got = check_inference("MaskRCNN")
    assert got["mask_logits"].shape[1:] == (3, 1, 28, 28)


def test_mask_rcnn_forward_train_matches_jax():
    losses, grads = check_training("MaskRCNN")
    assert "loss_mask" in losses
    assert grads["mask_head.upsample.weight"].abs().max() > 0


def test_retinanet_simple_test_matches_jax():
    """The 2-D RetinaNet: (1, 3, 3) towers, one sigmoid class-wise NMS."""
    check_inference("RetinaNet")


def test_cascade_rcnn_simple_test_matches_jax():
    check_inference("CascadeRCNN")


def test_htc_simple_test_matches_jax():
    """HTC on depth-1 maps: the semantic branch's (1, 3, 3) convs, its
    stride-8 depth-1 align fused into the rois, the stages' mean mask."""
    got = check_inference("HybridTaskCascade")
    assert got["mask_logits"].shape[1:] == (3, 1, 28, 28)


def test_retinanet_train_step():
    losses, moved = check_one_step("RetinaNet")
    assert set(losses) == {"loss_cls", "loss_reg", "loss"}
    assert "bbox_head.retina_cls.weight" in moved


def test_cascade_rcnn_train_step():
    losses, moved = check_one_step("CascadeRCNN")
    assert {f"s{t}.loss_cls" for t in range(3)} <= set(losses)
    assert {f"bbox_head.{t}.fc_reg.weight" for t in range(3)} <= set(moved)


def test_htc_train_step():
    """With a gt_semantic_seg of depth 1: the semantic loss and each
    stage's mask loss."""
    losses, moved = check_one_step("HybridTaskCascade")
    assert "loss_semantic_seg" in losses
    assert {f"s{t}.loss_mask" for t in range(3)} <= set(losses)
    assert "semantic_head.conv_logits.weight" in moved
