"""Whole-volume tiled inference and the inference API: the port on the CPU
against the JAX package.

The narrow flagship (`test_torch_port_models`), budgets 64, masks on.
Tolerances are those of chip_smoke.py's `small_tiled`: per-class counts
equal (the labels), every row within 2e-3, pasted masks equal on every
voxel whose probability (the reference side's, resized to the box) lies
farther than 1e-2 from the 0.25 threshold.  Each comparison first checks
that the port's decisions survive a 1e-4 perturbation of the input (the
margin check of test_torch_port_pipeline.py), so that a seed near a
decision boundary fails there instead of at random.  The geometries stay
off those where the JAX driver fails (see `test_plan_sweep_*`).
"""
import copy

import numpy as np
import pytest
import torch

from chip_smoke import (
    PIPELINE_ATOL,
    SMALL_BUDGET,
    MaskProbs,
    compare_tiled,
    small_config,
    small_tiled_run,
)
from mrcnn3d import native as jnative
from mrcnn3d.apis import inference as jinference
from mrcnn3d.apis import tiled as jtiled
from mrcnn3d_torch.apis import tiled
from mrcnn3d_torch.apis.inference import inference_detector_3d_2scales
from mrcnn3d_torch.entry import Flagship, build
from mrcnn3d_torch.eval.masks import get_seg_masks_3d, paste_mask_3d
from mrcnn3d_torch.ops.resize3d import resize_trilinear_3d
from test_torch_port_models import jax_flagship, port_flagship
from torch_port_fixtures import torch_threads  # noqa: F401

ATOL = PIPELINE_ATOL


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
    return (_budgets(jcfg), jmodel, variables,
            Flagship(_budgets(tcfg), tmodel, torch.device("cpu")))


@pytest.mark.parametrize("extent,patch,stride", [
    (100, 40, 30), (30, 40, 30), (64, 32, 16), (240, 64, 48), (7, 7, 1),
    (241, 166, 124), (512, 512, 384)])
def test_tile_starts_equal_jax(extent, patch, stride):
    assert tiled.tile_starts(extent, patch, stride) == \
        jtiled.tile_starts(extent, patch, stride)


def test_plan_sweep_whole_volume_geometry():
    """bench.py's whole volume: 5 tiles, origins as the JAX driver's."""
    sweep = tiled.plan_sweep((240, 512, 512), 512, 64, 0.25, 1.5)
    assert sweep.origins1 == [(z, 0, 0) for z in (0, 48, 96, 144, 176)]
    assert sweep.origins2 == [(z, 0, 0) for z in (0, 72, 144, 216, 264)]
    assert sweep.patch2 == (96, 768, 768)
    assert sweep.twin_shape == sweep.tgt2 == (360, 768, 768)
    assert sweep.tgt1 == (240, 512, 512)


def test_plan_sweep_clamps_the_twin_target():
    """D 241, patch_d 166: round-half-even puts the last 1.5x origin at
    round(112.5) = 112, and 112 + 249 = 361 is one voxel short of the twin
    (round(361.5) = 362), where the JAX driver's pad fails.  The port pads
    to the twin's shape, and to a given twin's shape."""
    sweep = tiled.plan_sweep((241, 64, 64), 64, 166, 0.25, 1.5)
    assert [o[0] for o in sweep.origins2] == [0, 112]
    assert sweep.patch2[0] == 249 and sweep.twin_shape[0] == 362
    assert sweep.tgt2 == (362, 96, 96)
    given = tiled.plan_sweep((241, 64, 64), 64, 166, 0.25, 1.5,
                             twin_shape=(364, 97, 96))
    assert given.tgt2 == (364, 97, 96)
    twin = torch.zeros((1, 3, *sweep.twin_shape))
    padded = tiled._pad_to(twin, sweep.tgt2)
    assert tuple(padded.shape[2:]) == sweep.tgt2
    for o in sweep.origins2:
        assert tuple(tiled._cut(padded, o, sweep.patch2).shape[2:]) == \
            sweep.patch2


def _port(det, vol, kw, scale=1.0):
    with MaskProbs() as rec:
        out = det.tiled(dict(imgs=vol * np.float32(scale)), **kw)
    return out, rec.probs


def _jax(models, vol, kw):
    jcfg, jmodel, variables, _ = models
    with MaskProbs(jtiled) as rec:
        out = jtiled.tiled_inference(jcfg, jmodel, variables, dict(imgs=vol),
                                     **kw)
    return out, rec.probs


# seed, volume (D, H, W), sweep
CASES = {
    "one_tile": (3, (12, 32, 32), dict(patch_hw=32, patch_d=12)),
    "four_tiles_compacted": (4, (12, 48, 32), dict(
        patch_hw=32, patch_d=8, overlap=0.5, max_dets_per_tile=16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_matches_jax(models, case):
    seed, shape, kw = CASES[case]
    det = models[3]
    vol = np.random.RandomState(seed).randn(*shape, 3).astype(np.float32)
    timers = {}
    got, probs = _port(det, vol, dict(kw, timers=timers))
    compare_tiled(_port(det, vol, kw, 1.0 + 1e-4)[0], got, probs, ATOL,
                  "seed too close to a decision boundary")
    want, jprobs = _jax(models, vol, kw)
    _, band, _ = compare_tiled(got, want, jprobs, ATOL, "port vs JAX")
    n = sum(len(r) for r in got[0])
    assert n > 4, f"{n} detections: vacuous case"
    assert timers["n_tiles"] == (1 if case == "one_tile" else 4)
    assert timers["n_merged"] == n < timers["n_entries"]
    if "max_dets_per_tile" in kw:
        assert timers["n_entries"] == 4 * kw["max_dets_per_tile"]
    assert set(timers) >= {"upload", "derive_twin_pad", "first_tile",
                           "fetch", "host_entries", "merge_nms",
                           "deferred_mask_realise", "n_entries"}


def test_tiled_given_twin_matches_jax(models):
    """A sample that carries its twin (the host runtime's resize): the
    port pads it instead of deriving one."""
    det = models[3]
    vol = np.random.RandomState(8).randn(12, 32, 32, 3).astype(np.float32)
    twin = jnative.resize_trilinear(vol, 18, 48, 48)
    kw = dict(patch_hw=32, patch_d=12)
    got = det.tiled(dict(imgs=vol, imgs_2=twin), **kw)
    jcfg, jmodel, variables, _ = models
    want = jtiled.tiled_inference(jcfg, jmodel, variables,
                                  dict(imgs=vol, imgs_2=twin), **kw)
    derived = det.tiled(dict(imgs=vol), **kw)
    for g, w, d in zip(got[0], want[0], derived[0]):
        assert g.shape == w.shape == d.shape and len(g) > 4
        np.testing.assert_allclose(g, w, atol=ATOL)
        np.testing.assert_allclose(g, d, atol=ATOL)


def test_single_tile_matches_direct(models):
    """One tile over the whole volume equals the direct `Flagship.run` on
    the volume and its twin plus `get_seg_masks_3d` (the mask logits
    rounded through bfloat16, as the tiled driver fetches them): every
    merged detection is a direct one, its pasted mask voxel-identical."""
    det = models[3]
    d, h, w = 12, 32, 32
    vol = np.random.RandomState(4).randn(d, h, w, 3).astype(np.float32)
    per_class, segms = det.tiled(dict(imgs=vol), patch_hw=32, patch_d=12,
                                 max_dets_per_tile=None)
    x = torch.from_numpy(vol).permute(3, 0, 1, 2)[None]
    dets, labels, valid, logits = det.run(
        x, resize_trilinear_3d(x, (18, 48, 48)))
    dets, labels, valid = dets[0].numpy(), labels[0].numpy(), valid[0].numpy()
    logits = logits.to(torch.bfloat16).float().numpy()
    direct = get_seg_masks_3d(logits, dets, labels, valid, 2, (h, w, d))
    direct_boxes = dets[valid & (labels == 0)]
    assert len(per_class[0]) == len(segms[0]) > 4
    assert len(per_class[0]) < len(direct_boxes)   # the merge dropped some
    for row, seg in zip(per_class[0], segms[0]):
        diffs = np.abs(direct_boxes[:, :7] - row).sum(1)
        j = int(np.argmin(diffs))
        assert diffs[j] < 1e-3
        np.testing.assert_array_equal(
            paste_mask_3d(seg["box"], seg["mask"], seg["shape"]),
            direct[0][j])


def test_card_check_has_margin():
    """chip_smoke.py's small_tiled compares this sweep (seeded port
    weights) on the card against the CPU; its decisions must not sit
    within float noise of a boundary either."""
    det = build(small_config(), device="cpu", budgets=SMALL_BUDGET)
    got, probs = small_tiled_run(det)
    assert sum(len(r) for r in got[0]) > 4
    compare_tiled(small_tiled_run(det, scale=1.0 + 1e-4)[0], got, probs,
                  ATOL, "seed too close to a decision boundary")


def test_inference_api_matches_jax(models, tmp_path):
    """inference_detector_3d_2scales on raw (H, W, D) .npy volumes and
    their twins: per-class detections as the JAX API's (rows paired one
    to one, as `compare_tiled` pairs them).  The JAX API
    unpacks three outputs, so it runs with boxes only (with masks on it
    raises; the port's ignores the mask logits)."""
    jcfg, jmodel, variables, det = models
    jcfg = copy.deepcopy(jcfg)
    jcfg.test_cfg["return_bbox_only"] = True
    rng = np.random.RandomState(13)
    paths, paths2 = [], []
    for i, (shape, shape2) in enumerate([((32, 32, 8), (48, 48, 12)),
                                         ((30, 28, 8), (45, 42, 12))]):
        for p, s, lst in ((f"v{i}.npy", shape, paths),
                          (f"v{i}_2.npy", shape2, paths2)):
            np.save(tmp_path / p, rng.normal(115, 58, s).astype(np.float32))
            lst.append(str(tmp_path / p))
    got = list(inference_detector_3d_2scales(det, paths, paths2))
    # the margin check's 1e-4 of the normalised values: the raw volume
    # scaled about the normalisation's mean intensity
    mid = np.float32(np.mean(det.cfg.img_norm_cfg["mean"]))

    def nudge(p):
        return mid + (np.load(p) - mid) * np.float32(1 + 1e-4)

    nudged = list(inference_detector_3d_2scales(
        det, [nudge(p) for p in paths], [nudge(p) for p in paths2]))
    want = list(jinference.inference_detector_3d_2scales(
        jmodel, variables, jcfg, paths, paths2))
    assert len(got) == len(want) == 2
    no_masks = [[]] * len(got[0])
    for g, n, w in zip(got, nudged, want):
        compare_tiled((n, no_masks), (g, no_masks), {}, ATOL,
                      "seed too close to a decision boundary")
        compare_tiled((g, no_masks), (w, no_masks), {}, ATOL, "port vs JAX")
    assert sum(len(c) for g in got for c in g) > 4
