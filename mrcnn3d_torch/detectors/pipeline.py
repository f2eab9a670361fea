"""Flagship two-scale inference (torch): proposals, the bbox and
refinement stages, multi-class NMS and the mask stage.

Port of the flagship branch of `mrcnn3d/detectors/pipeline.py`
(reference two_stage_3d_2scales.py:335-434 simple_test).  Padded shapes
are kept, so the outputs compare directly with the JAX ones:
dets (B, max_per_img, 7), labels (B, max_per_img), valid
(B, max_per_img) and mask_logits (B*max_per_img, num_classes, Dm, Hm, Wm).

Every RoIAlign goes through the K2 wrapper (`ops/roi_align3d.py`) and
every NMS through the K1 wrapper (`ops/nms3d.py`): per step one K1
launch per scale for the proposals of all levels and images, one for
the class-wise NMS, and four K2 launches (bbox 1.0x, bbox 1.5x,
refinement, mask).

Stable sorts stand in for JAX's argsort and lax.top_k, which break ties
toward the lower index.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.anchors import AnchorGenerator3D, anchor_inside_flags
from ..core.post import multiclass_nms_3d
from ..ops.box3d import delta2bbox3d
from ..ops.nms3d import nms_3d_mask_segments, sort_desc, top_kept
from ..ops.roi_align3d import multi_level_roi_align_3d

RPN_MEANS = (0.0,) * 6
RPN_STDS = (1.0,) * 6
MASK_HEAD_CHUNK = 512


def rpn_codec(cfg):
    """RPN box codec (means, stds) from the model config."""
    head = cfg.model.get("rpn_head", {})
    means = tuple(head.get("target_means", RPN_MEANS))
    stds = tuple(head.get("target_stds", RPN_STDS))
    return means, stds


class AnchorSet(NamedTuple):
    """Per-level anchors (Nl, 6) and inside-volume flags (Nl,)."""

    anchors: Sequence[torch.Tensor]
    inside: Sequence[torch.Tensor]


def build_anchor_set(featmap_sizes, img_shape, anchor_cfg, device="cpu",
                     allowed_border=0):
    """Anchor lattice for the FPN level sizes [(d, h, w), ...].

    img_shape: (H, W, C, D) reference layout; anchor_cfg: the rpn_head
    dict (anchor_scales / anchor_depth_scales / anchor_ratios /
    anchor_strides / anchor_strides_depth).
    """
    strides = anchor_cfg["anchor_strides"]
    dstrides = anchor_cfg.get("anchor_strides_depth", [1] * len(strides))
    anchors, inside = [], []
    for lvl, size in enumerate(featmap_sizes):
        gen = AnchorGenerator3D(
            base_size=strides[lvl],
            scales=anchor_cfg["anchor_scales"],
            depth_scales=anchor_cfg["anchor_depth_scales"],
            ratios=anchor_cfg["anchor_ratios"],
            anchor_depth_base=dstrides[lvl],
        )
        a = gen.grid_anchors(size, strides[lvl], dstrides[lvl])
        flags = gen.valid_flags(size, size)
        ins = anchor_inside_flags(a, flags, img_shape, allowed_border)
        anchors.append(torch.from_numpy(a).to(device))
        inside.append(torch.from_numpy(ins).to(device))
    return AnchorSet(anchors, inside)


def gen_proposals(cls_outs, reg_outs, anchor_set, img_shape, cfg,
                  means=RPN_MEANS, stds=RPN_STDS):
    """RPN proposals (reference rpn_head_3d.py get_bboxes_single).

    cls_outs[l]: (B, A, d, h, w); reg_outs[l]: (B, A*6, d, h, w).
    Returns boxes (B, M, 6), scores (B, M), valid (B, M), M = max_num.
    One K1 launch covers every level of every image.
    """
    nms_pre, nms_post = cfg["nms_pre"], cfg["nms_post"]
    b = cls_outs[0].shape[0]
    neg_inf = float("-inf")
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for lvl, (cls, reg) in enumerate(zip(cls_outs, reg_outs)):
        # (B, A, d, h, w) -> (B, d*h*w*A): the anchors' (z, y, x, a) order
        scores = torch.sigmoid(cls.float().permute(0, 2, 3, 4, 1)
                               .reshape(b, -1))
        deltas = reg.float().permute(0, 2, 3, 4, 1).reshape(b, -1, 6)
        anchors = anchor_set.anchors[lvl]
        n = scores.shape[1]
        if n > nms_pre:
            # inside-volume pre-filter (reference :96-106 pos_indices)
            masked = torch.where(anchor_set.inside[lvl], scores, neg_inf)
            top_s, top_i = sort_desc(masked)
            top_s, top_i = top_s[:, :nms_pre], top_i[:, :nms_pre]
            anchors = anchors[top_i]
            deltas = torch.gather(
                deltas, 1, top_i[..., None].expand(b, nms_pre, 6)
            )
            valid = top_s > neg_inf
            scores = torch.where(valid, top_s, 0.0)
        else:
            anchors = anchors.expand(b, n, 6)
            valid = torch.ones((b, n), dtype=torch.bool, device=cls.device)
        lvl_boxes.append(delta2bbox3d(anchors, deltas, means, stds,
                                      img_shape))
        lvl_scores.append(scores)
        lvl_valid.append(valid)

    counts = [s.shape[1] for s in lvl_scores]
    keep = nms_3d_mask_segments(
        torch.cat(lvl_boxes, 1).reshape(-1, 6),
        torch.cat(lvl_scores, 1).reshape(-1),
        torch.cat(lvl_valid, 1).reshape(-1),
        counts * b,
        cfg["nms_thr"],
    ).reshape(b, -1)

    boxes, scores, valid = [], [], []
    for lvl, keep_l in enumerate(torch.split(keep, counts, dim=1)):
        bx, sc, vd = top_kept(lvl_boxes[lvl], lvl_scores[lvl], keep_l,
                              min(nms_post, counts[lvl]))
        boxes.append(bx)
        scores.append(torch.where(vd, sc, neg_inf))
        valid.append(vd)
    boxes = torch.cat(boxes, 1)
    scores = torch.cat(scores, 1)
    valid = torch.cat(valid, 1)

    num = min(cfg["max_num"], boxes.shape[1])
    top_s, top_i = sort_desc(scores)
    top_s, top_i = top_s[:, :num], top_i[:, :num]
    out_valid = (top_s > neg_inf) & torch.gather(valid, 1, top_i)
    out_boxes = torch.gather(boxes, 1, top_i[..., None].expand(b, num, 6))
    out_boxes = torch.where(out_valid[..., None], out_boxes, 0.0)
    out_scores = torch.where(out_valid, top_s, 0.0)
    return out_boxes, out_scores, out_valid


def flat_rois(boxes, valid=None):
    """(B, R, 6) -> (B*R, 7) [batch, x1..z2] (reference bbox2roi3D)."""
    b, r, _ = boxes.shape
    batch_idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    rois = torch.cat(
        [batch_idx.repeat_interleave(r)[:, None], boxes.reshape(b * r, 6)],
        dim=1,
    )
    if valid is None:
        return rois
    return rois, valid.reshape(b * r)


def roi_align(feats, rois, roi_cfg, valid):
    """RoIAlign under an roi extractor config (one K2 launch on the card)."""
    layer = roi_cfg["roi_layer"]
    strides = roi_cfg["featmap_strides"]
    return multi_level_roi_align_3d(
        feats[: len(strides)], rois, layer["out_size"],
        layer["out_size_depth"], strides, roi_cfg["featmap_strides_depth"],
        layer["sample_num"], valid=valid,
    )


def _img_shape(imgs):
    """(B, 3, D, H, W) -> the reference img_shape (H, W, 3, D)."""
    return (imgs.shape[3], imgs.shape[4], 3, imgs.shape[2])


def _no_mark(name):
    return None


def simple_test(model, batch, cfg, anchor_sets, rescale=True, mark=None):
    """Two-scale inference (reference two_stage_3d_2scales.py:335-434).

    batch: imgs (B, 3, D, H, W) and imgs_2 (the 1.5x twin); optionally
    proposals / proposals_2 (B, M, 6) with proposals_valid{,_2} (B, M),
    which replace the RPN.  mark: optional callable, called with a stage
    name after each stage (the timing hook of chip_smoke.py).
    Returns dict(dets, labels, valid[, mask_logits]) in the 1.0x frame.
    """
    mark = mark or _no_mark
    test_cfg = cfg.test_cfg
    rcnn_test = test_cfg["rcnn"]
    roi_cfg = cfg.model["bbox_roi_extractor"]
    upscale = cfg.get("upscale_factor", 1.5)
    rpn_means, rpn_stds = rpn_codec(cfg)
    means = tuple(cfg.model["bbox_head"]["target_means"])
    stds = tuple(cfg.model["bbox_head"]["target_stds"])
    mark("start")

    feats_s, boxes_s, scores_s, valid_s = [], [], [], []
    for s in range(model.num_scales):
        sfx = "" if s == 0 else f"_{s + 1}"
        imgs = batch["imgs" + sfx]
        b = imgs.shape[0]
        img_shape = _img_shape(imgs)
        feats = model.extract_feat(imgs)
        mark(f"backbone_fpn_{s}")
        if ("proposals" + sfx) in batch:
            pboxes = batch["proposals" + sfx]
            pvalid = batch.get(
                "proposals_valid" + sfx,
                torch.ones(pboxes.shape[:2], dtype=torch.bool,
                           device=pboxes.device),
            )
        else:
            rpn_outs = model.rpn(feats, s)
            pboxes, _, pvalid = gen_proposals(
                [o[0] for o in rpn_outs], [o[1] for o in rpn_outs],
                anchor_sets[s], img_shape, test_cfg["rpn"],
                means=rpn_means, stds=rpn_stds,
            )
        mark(f"proposals_{s}")
        rois, rvalid = flat_rois(pboxes, pvalid)
        cls_score, bbox_pred = model.bbox_forward(
            roi_align(feats, rois, roi_cfg, rvalid), s
        )
        scores = torch.softmax(cls_score.float(), dim=-1)
        boxes = delta2bbox3d(rois[:, 1:], bbox_pred.float(), means, stds,
                             img_shape)
        scale_factor = 1.0 if s == 0 else upscale ** s
        if rescale and scale_factor != 1.0:
            boxes = boxes / scale_factor
        m = pboxes.shape[1]
        feats_s.append(feats)
        boxes_s.append(boxes.reshape(b, m, -1))
        scores_s.append(scores.reshape(b, m, -1))
        valid_s.append(rvalid.reshape(b, m))
        mark(f"bbox_{s}")

    if model.with_refinement and model.num_scales >= 2:
        # refine the 1.5x class-1 boxes (already in the 1.0x frame) on
        # the 1.0x features (reference :360-364, test_mixins_3d.py:102-128)
        imgs = batch["imgs"]
        b = imgs.shape[0]
        ref_in = boxes_s[1][..., 6:12]
        rois, rvalid = flat_rois(ref_in, valid_s[1])
        ref_pred = model.refinement_forward(
            roi_align(feats_s[0], rois, roi_cfg, rvalid)
        )
        ref_boxes = delta2bbox3d(rois[:, 1:], ref_pred.float(), means, stds,
                                 _img_shape(imgs))
        boxes_s[1] = ref_boxes.reshape(b, ref_in.shape[1], -1)
        mark("refinement")

    dets, labels, dvalid, src_idx = multiclass_nms_3d(
        torch.cat(boxes_s, 1), torch.cat(scores_s, 1), torch.cat(valid_s, 1),
        rcnn_test["score_thr"], rcnn_test["nms"]["iou_thr"],
        rcnn_test["max_per_img"],
    )
    mark("nms")
    out = dict(dets=dets, labels=labels, valid=dvalid)
    if not test_cfg.get("return_bbox_only", False):
        refined = None
        if model.with_refinement_mask and model.num_scales >= 2:
            # rows >= m1 of the NMS input came from the 1.5x pathway
            refined = (src_idx >= boxes_s[0].shape[1]).reshape(-1)
        out["mask_logits"] = mask_stage(
            model, feats_s[0], dets, dvalid, refined,
            cfg.model["mask_roi_extractor"],
        )
        mark("mask")
    return out


def mask_stage(model, feats, dets, dvalid, refined, mask_roi_cfg):
    """Mask logits for every detection slot (zeros for invalid slots).

    One align over the valid slots only, then the mask heads, at most
    MASK_HEAD_CHUNK rows per call; with `refined` (B*max_per_img,) bool,
    the rows from the 1.5x pathway go to the refinement mask head
    (reference :385-434 splits by provenance too).
    """
    rois, rvalid = flat_rois(dets[..., :6], dvalid)
    rows = torch.nonzero(rvalid).flatten()
    mfeat = roi_align(feats, rois[rows], mask_roi_cfg, rvalid[rows])
    layer = mask_roi_cfg["roi_layer"]
    od, o = layer["out_size_depth"], layer["out_size"]
    out = torch.zeros((rois.shape[0], model.num_classes, 2 * od, 2 * o,
                       2 * o), dtype=mfeat.dtype, device=mfeat.device)
    # positions in `rows` (and so in mfeat), per head
    pos = torch.arange(rows.shape[0], device=rows.device)
    groups = [(pos, model.mask_forward)]
    if refined is not None:
        sel = refined[rows]
        groups = [(pos[~sel], model.mask_forward),
                  (pos[sel], model.refinement_mask_forward)]
    for idx, head in groups:
        for chunk in torch.split(idx, MASK_HEAD_CHUNK):
            out[rows[chunk]] = head(mfeat[chunk])
    return out


def bbox2result3d(dets, labels, valid, num_classes):
    """Per-class numpy result lists (reference transforms.py:274-292):
    dets (M, 7), labels (M,), valid (M,) -> [(n_c, 7) float32] for the
    foreground classes 0..num_classes-2."""
    dets = dets.detach().cpu().numpy()
    labels = labels.detach().cpu().numpy()
    valid = valid.detach().cpu().numpy().astype(bool)
    return [dets[valid & (labels == c)] for c in range(num_classes - 1)]
