"""The learning protocol's scoring on trained-like weights: the port's
`learning_bench.evaluate_protocol` against the JAX package's evaluation
body (`tools/learning_bench.py:218-274`, rebuilt here from the JAX
package's own calls: `run_inference`, `results2json3d_multi`,
`CocoEval3D` bbox and segm, `best_overlaps`).  Queue C 6.

Weights: the narrow flagship's JAX random weights
(`test_torch_port_models.jax_flagship`) with both mask heads'
`conv_logits` weight and bias scaled by SHARPEN, so that the mask
probabilities spread over [0, 1] as a trained head's do, instead of
sitting near 0.5.  Data: the pinned generator at a tiny geometry
(`learning_bench.generate_pinned_data(geometry=TINY)`): the val set, its
materialised 1.5x twin for pass 2 under test_cfg2, budgets cut to
SMALL_BUDGET.

Tolerances: detections of each pass as `test_run_inference_matches_jax`
holds them (per-class counts equal, rows within PIPELINE_ATOL, pasted
masks equal off the MASK_PROB_BAND band around the 0.25 threshold); the
29 bbox stats of both passes, the single-pass stats, the 29 segm stats
and every statistic of the mask-quality oracle within STATS_TOL.

`torch_port_learning_scripts.py` runs the same comparison as a script:
a trained port state scored by both packages at the protocol's own
geometry, and the JAX package's narrow flagship trained on the pinned
data.
"""
import copy
import os
import sys

import numpy as np
import pytest

_TESTS = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(_TESTS), _TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from chip_smoke import (  # noqa: E402
    MASK_PROB_BAND,
    PIPELINE_ATOL,
    SMALL_BUDGET,
    _paste,
    compare_tiled,
)
from mrcnn3d.apis.test_api import run_inference as j_run_inference
from mrcnn3d.data.coco3d import Coco3D2ScalesDataset as JDataset
from mrcnn3d.eval.coco_eval3d import CocoEval3D as JCocoEval3D
from mrcnn3d.eval.results import results2json3d_multi as j_multi
from mrcnn3d.eval.masks import segm_entries as j_segm_entries
from mrcnn3d_torch.apis import test_api
from mrcnn3d_torch.eval.masks import (
    _sigmoid,
    _trilinear_resize,
    box_extent,
    paste_mask_3d,
)
from mrcnn3d_torch.tools import learning_bench as lb
from test_torch_port_models import jax_flagship, port_flagship
from torch_port_fixtures import torch_threads  # noqa: E402,F401

# (hw, depth, train volumes, val volumes) of the pinned generator
TINY = (48, 16, 1, 2)
SHARPEN = 60.0
STATS_TOL = 1e-3
MASK_HEADS = ("mask_head_0", "refinement_mask_head")


def _budgets(cfg):
    for tc in (cfg.test_cfg, cfg.test_cfg2):
        for k in ("nms_pre", "nms_post", "max_num"):
            tc["rpn"][k] = SMALL_BUDGET
        tc["rcnn"]["max_per_img"] = SMALL_BUDGET
    return cfg


def _sharpen(variables):
    out = copy.deepcopy(variables)
    for head in MASK_HEADS:
        logits = out["params"][head]["conv_logits"]
        for k in ("kernel", "bias"):
            logits[k] = np.asarray(logits[k], np.float32) * SHARPEN
    return out


def jax_evaluation(jcfg, jmodel, variables, ann_va, dir_va, ann_va2,
                   dir_va2):
    """The JAX package's evaluation body as `tools/learning_bench.py:
    218-274` runs it: (bbox stats of both passes, single-pass stats,
    segm stats, each gt's best voxel IoU, (pass 1's output, pass 2's
    results and infos), pass 1's segm entries)."""
    scfg = copy.deepcopy(jcfg)
    scfg.test_cfg["return_bbox_only"] = False
    te = jcfg.data["test"]
    mk = dict(img_norm_cfg=te["img_norm_cfg"],
              size_divisor=te.get("size_divisor", 32), with_mask=False,
              test_mode=True)
    ds1 = JDataset(ann_va, dir_va, **mk)
    ds2 = JDataset(ann_va2, dir_va2, **mk)
    out1 = j_run_inference(scfg, jmodel, variables, ds1, progress=False)
    results1, infos1, segms = out1
    cfg2 = copy.deepcopy(jcfg)
    cfg2["test_cfg"] = cfg2.get("test_cfg2", cfg2["test_cfg"])
    results2, infos2 = j_run_inference(cfg2, jmodel, variables, ds2,
                                       progress=False)[:2]
    scale2 = 1.0 / jcfg.get("upscale_factor", 1.5)
    stats = JCocoEval3D(ds1.coco, j_multi(
        results1, infos1, results2, infos2, scale2=scale2)).named_stats()
    stats_single = JCocoEval3D(ds1.coco, j_multi(
        results1, infos1, None, None, scale2=scale2)).named_stats()
    sentries = []
    for cls_segms, per_class, info in zip(segms, results1, infos1):
        sentries.extend(j_segm_entries(cls_segms, per_class, info))
    seg_ev = JCocoEval3D(ds1.coco, sentries, iou_type="segm")
    seg_stats = seg_ev.named_stats(prefix="segm")
    best = np.array([v["iou"] for v in seg_ev.best_overlaps.values()])
    return (stats, stats_single, seg_stats, best, (out1, (results2, infos2)),
            sentries)


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """(the port's evaluate_protocol, JAX's evaluation body, the port's
    and JAX's raw passes, the port's mask probabilities by mask id)."""
    root = str(tmp_path_factory.mktemp("learning_eval"))
    _, _, _, ann_va, dir_va, ann_va2, dir_va2 = lb.generate_pinned_data(
        root, 1.5, TINY)
    jcfg, jmodel, variables = jax_flagship(seed=3)
    variables = _sharpen(variables)
    tcfg, tmodel = port_flagship(variables)
    jcfg, tcfg = _budgets(jcfg), _budgets(tcfg)

    probs = {}
    real = test_api.get_box_masks_3d

    def record(logits, dets, labels, valid, thr):
        out = real(logits, dets, labels, valid, thr)
        for bm, lg in zip(out, logits):
            probs[id(bm["mask"])] = _trilinear_resize(
                _sigmoid(lg), box_extent(bm["box"]))
        return out

    test_api.get_box_masks_3d = record
    passes = {}
    try:
        got = lb.evaluate_protocol(tcfg, tmodel, ann_va, dir_va, ann_va2,
                                   dir_va2, passes=passes)
    finally:
        test_api.get_box_masks_3d = real

    want = jax_evaluation(jcfg, jmodel, variables, ann_va, dir_va, ann_va2,
                          dir_va2)
    return got, want[:4], (passes["pass1"], passes["pass2"]), want[4], probs


def test_protocol_detections_match_jax(protocol):
    """Both passes' rows as the JAX package's; pass 1's pasted masks (the
    segm pass's) as JAX's full volumes off the band."""
    _, _, port, jax_out, probs = protocol
    (t1, t2), (j1, j2) = port, jax_out
    assert t1[1] == j1[1] and t2[1] == j2[1]
    n = masks = 0
    for res, seg, jres, jseg in zip(t1[0], t1[2], j1[0], j1[2]):
        compare_tiled((res, [[]] * len(res)), (jres, [[]] * len(jres)), {},
                      PIPELINE_ATOL, "pass 1 port vs JAX")
        for c, (rows, jrows) in enumerate(zip(res, jres)):
            pair = np.abs(rows[:, None] - jrows[None]).max(-1).argmin(1)
            for carrier, j in zip(seg[c], pair):
                shape = carrier["shape"]
                pasted = paste_mask_3d(carrier["box"], carrier["mask"], shape)
                p = _paste(carrier["box"], probs[id(carrier["mask"])], shape)
                near = np.abs(p - 0.25) <= MASK_PROB_BAND
                assert not ((pasted != jseg[c][j]) & ~near).any()
                masks += int(pasted.sum() > 0)
            n += len(rows)
    for res, jres in zip(t2[0], j2[0]):
        compare_tiled((res, [[]] * len(res)), (jres, [[]] * len(jres)), {},
                      PIPELINE_ATOL, "pass 2 port vs JAX")
    assert n > 4 and masks > 4, f"{n} detections, {masks} masks: vacuous"


def test_protocol_scores_match_jax(protocol):
    """The double_test bbox stats, the single-pass stats, the segm stats
    and the oracle within STATS_TOL of the JAX package's evaluation."""
    (stats, single, segm, quality), want, _, _, _ = protocol
    jstats, jsingle, jsegm, jbest = want
    for got, ref, what in ((stats, jstats, "bbox"),
                           (single, jsingle, "single pass"),
                           (segm, jsegm, "segm")):
        assert len(got) == len(ref) == 29, what
        for k, v in ref.items():
            assert abs(got[k] - v) <= STATS_TOL, (what, k, got[k], v)
    assert quality["n_gt"] == jbest.size > 0
    for k, v in dict(mean=jbest.mean(), median=np.median(jbest),
                     frac_ge_50=(jbest >= 0.5).mean()).items():
        assert abs(quality[k] - v) <= STATS_TOL, (k, quality[k], v)
    assert jbest.max() > 0, "no gt overlapped: vacuous case"


def test_masks_are_sharp(protocol):
    """SHARPEN spreads the mask probabilities over [0, 1]."""
    probs = np.concatenate([p.ravel() for p in protocol[4].values()])
    assert probs.min() < 0.05 and probs.max() > 0.9
