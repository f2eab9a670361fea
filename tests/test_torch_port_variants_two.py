"""The 3-D two-stage variants against the JAX package, on the CPU: the
two-scale group (separate heads, separate heads with the refinement
head and no masks, one pathway with one RPN head).  The recipe, the
geometry and the tolerances are those of
`test_torch_port_variants_single.py`."""
import pytest

from test_torch_port_variants_single import (
    check_draw_margin,
    check_gradients,
    check_inference,
    check_losses,
)
from torch_port_fixtures import torch_threads  # noqa: F401

TYPES = ("MaskRCNN3D2ScalesHeads", "MaskRCNN3D2ScalesHeadsRefinementHead",
         "MaskRCNN3D2ScalesOnePathwayOneRPN")


@pytest.mark.parametrize("type_name", TYPES)
def test_simple_test_matches_jax(type_name):
    got = check_inference(type_name)
    assert ("mask_logits" in got) == \
        (type_name != "MaskRCNN3D2ScalesHeadsRefinementHead")


@pytest.mark.parametrize("type_name", TYPES)
def test_forward_train_losses_match_jax(type_name):
    keys = {k for k in check_losses(type_name) if "loss" in k}
    assert {"loss_rpn_cls", "loss_rpn_cls_2", "loss_cls"} <= keys
    # per-scale bbox losses are suffixed under separate heads
    assert ("loss_cls_2" in keys) == ("Heads" in type_name)
    assert ("loss_refinement_reg" in keys) == ("Refinement" in type_name
                                               or "OneRPN" in type_name)
    assert ("loss_mask" in keys) == \
        (type_name != "MaskRCNN3D2ScalesHeadsRefinementHead")
    assert ("loss_mask_refinement" in keys) == ("OneRPN" in type_name)


@pytest.mark.parametrize("type_name", TYPES)
def test_gradients_match_jax(type_name):
    grads = check_gradients(type_name)
    if type_name == "MaskRCNN3D2ScalesHeads":
        # the mask stage runs head 0; the 1.5x mask head exists, unused
        assert not any(g.any() for n, g in grads.items()
                       if n.startswith("mask_head_2."))
    if type_name == "MaskRCNN3D2ScalesOnePathwayOneRPN":
        assert not any(n.startswith("rpn_head_2.") for n in grads)


@pytest.mark.parametrize("type_name", TYPES)
def test_draws_have_margin(type_name):
    check_draw_margin(type_name)
