"""Test-time augmentation: `aug_test` and the merge functions (torch).

Port of `mrcnn3d/detectors/aug.py` (reference mmdet/models/detectors/
base.py:60-86 aug_test, core/post_processing/merge_augs.py, test_mixins
aug_test_rpn / aug_test_bboxes / aug_test_mask): each augmented view
(rescaled and/or W-flipped) gives proposals that are mapped back to the
original frame and NMS-merged per image; the bbox head scores the merged
proposals on every view (mapped into the view's frame), the views' boxes
and scores are averaged and go through the class-wise NMS; the mask head
runs on every view, its probabilities flip-corrected and averaged.

Like the reference and the JAX package, it drives single-pathway
two-stage models (num_scales 1, with a bbox head) and raises otherwise.

Launches per call on the card, for V views: K1 V + 2 (each view's
proposals, the merge of every image's proposals, the class-wise NMS);
K2 V for the bbox align and, with masks, V more (one per view, over the
valid detections).  Padded shapes are kept: dets (B, max_per_img, 7),
labels, valid and mask_probs (B*max_per_img, num_classes, Dm, Hm, Wm),
NCDHW (the JAX package's is channel-last), zero where no detection is.
"""
from __future__ import annotations

import torch

from ..core.post import multiclass_nms_3d
from ..ops.box3d import delta2bbox3d
from ..ops.nms3d import nms_3d_mask_segments, top_kept
from .pipeline import (
    _img_shape,
    flat_rois,
    gen_proposals,
    mask_stage,
    roi_align,
    rpn_codec,
)


def bbox_flip_3d(boxes, img_shape):
    """W-axis flip of xyxyzz boxes (..., 6) (reference bbox_flip,
    mmdet/core/bbox/transforms.py:54-66).  img_shape: (H, W, C, D)."""
    w = img_shape[1]
    return torch.stack([w - boxes[..., 2] - 1, boxes[..., 1],
                        w - boxes[..., 0] - 1, boxes[..., 3],
                        boxes[..., 4], boxes[..., 5]], dim=-1)


def bbox_mapping_3d(boxes, img_shape, scale_factor, flip):
    """Original frame -> the view's frame: scale every axis, then flip."""
    out = boxes * scale_factor
    return bbox_flip_3d(out, img_shape) if flip else out


def bbox_mapping_back_3d(boxes, img_shape, scale_factor, flip):
    """The view's frame -> the original frame: un-flip, then un-scale."""
    out = bbox_flip_3d(boxes, img_shape) if flip else boxes
    return out / scale_factor


def merge_aug_proposals(aug_boxes, aug_scores, aug_valid, metas, rpn_cfg):
    """Per image, the NMS of every view's proposals mapped back to the
    original frame (reference merge_augs.py:9-38), every image in one K1
    launch.

    aug_*: per view (B, M, 6) boxes, (B, M) scores, (B, M) valid; metas:
    per view dict(img_shape, scale_factor, flip).  Returns (B, K, 6)
    boxes, (B, K) scores (-inf padding) and (B, K) valid, with the
    budget K = min(max_num, views x M) (merge_augs.py:35)."""
    boxes = torch.cat([
        bbox_mapping_back_3d(b, m["img_shape"], m["scale_factor"],
                             m["flip"])
        for b, m in zip(aug_boxes, metas)], dim=1)
    scores = torch.cat(aug_scores, dim=1)
    valid = torch.cat(aug_valid, dim=1)
    b, n = scores.shape
    keep = nms_3d_mask_segments(boxes.reshape(-1, 6), scores.reshape(-1),
                                valid.reshape(-1), [n] * b,
                                float(rpn_cfg["nms_thr"])).reshape(b, n)
    return top_kept(boxes, scores, keep, min(int(rpn_cfg["max_num"]), n))


def merge_aug_bboxes(aug_boxes, aug_scores, metas):
    """The mean of the views' decoded boxes (..., C*6), mapped back, and
    of their scores (reference merge_augs.py:41-66)."""
    recovered = []
    for b, m in zip(aug_boxes, metas):
        per_cls = b.reshape(*b.shape[:-1], -1, 6)
        per_cls = bbox_mapping_back_3d(per_cls, m["img_shape"],
                                       m["scale_factor"], m["flip"])
        recovered.append(per_cls.reshape(b.shape))
    return (torch.stack(recovered).mean(0),
            torch.stack(aug_scores).mean(0))


def merge_aug_scores(aug_scores):
    """The mean of the views' scores (reference merge_augs.py:69-74)."""
    return torch.stack(aug_scores).mean(0)


def merge_aug_masks(aug_masks, metas, weights=None):
    """The (weighted) mean of the views' mask probabilities (N, C, d, h,
    w), each flipped back along W, its last axis, where the view was
    flipped (reference merge_augs.py:77-96)."""
    recovered = torch.stack([m.flip(-1) if meta["flip"] else m
                             for m, meta in zip(aug_masks, metas)])
    if weights is None:
        return recovered.mean(0)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=recovered.device)
    w = (w / w.sum()).to(recovered.dtype)
    return torch.tensordot(w, recovered, dims=1)


def aug_test(model, aug_batches, metas, cfg, aug_anchor_sets):
    """TTA inference over augmented views of one batch of volumes.

    aug_batches: per view dict(imgs=(B, 3, D, H, W)); metas: per view
    dict(scale_factor=float, flip=bool) (img_shape comes from the view);
    aug_anchor_sets: per view the AnchorSet of its geometry.  Returns the
    simple_test dict (dets in the original frame) with mask_probs for a
    model with masks unless test_cfg.return_bbox_only."""
    if model.num_scales != 1 or not model.with_bbox:
        raise ValueError(
            "aug_test drives single-pathway two-stage models (reference "
            "two_stage.py:226; the multi-scale 3-D family has no aug_test)")
    test_cfg = cfg.test_cfg
    rcnn_test = test_cfg["rcnn"]
    rpn_means, rpn_stds = rpn_codec(cfg)
    means = tuple(cfg.model["bbox_head"]["target_means"])
    stds = tuple(cfg.model["bbox_head"]["target_stds"])
    metas = [dict(m, img_shape=_img_shape(ab["imgs"]))
             for m, ab in zip(metas, aug_batches)]

    # each view's features and proposals (aug_test_rpn)
    feats_v, pb_v, ps_v, pv_v = [], [], [], []
    for ab, meta, aset in zip(aug_batches, metas, aug_anchor_sets):
        feats = model.extract_feat(ab["imgs"])
        rpn_outs = model.rpn(feats, 0)
        pboxes, pscores, pvalid = gen_proposals(
            [o[0] for o in rpn_outs], [o[1] for o in rpn_outs], aset,
            meta["img_shape"], test_cfg["rpn"], means=rpn_means,
            stds=rpn_stds)
        feats_v.append(feats)
        pb_v.append(pboxes)
        ps_v.append(pscores)
        pv_v.append(pvalid)
    mboxes, _, mvalid = merge_aug_proposals(pb_v, ps_v, pv_v, metas,
                                            test_cfg["rpn"])

    # the bbox head on the merged proposals in every view (aug_test_bboxes)
    b, m = mvalid.shape
    aug_boxes, aug_scores = [], []
    for feats, meta in zip(feats_v, metas):
        view_props = bbox_mapping_3d(mboxes, meta["img_shape"],
                                     meta["scale_factor"], meta["flip"])
        rois, rvalid = flat_rois(view_props, mvalid)
        head_out = model.bbox_forward(
            roi_align(feats, rois, cfg.model["bbox_roi_extractor"], rvalid),
            0)
        aug_boxes.append(delta2bbox3d(rois[:, 1:], head_out[1].float(),
                                      means, stds, meta["img_shape"]))
        aug_scores.append(torch.softmax(head_out[0].float(), dim=-1))
    boxes_m, scores_m = merge_aug_bboxes(aug_boxes, aug_scores, metas)
    dets, labels, dvalid, _ = multiclass_nms_3d(
        boxes_m.reshape(b, m, -1), scores_m.reshape(b, m, -1), mvalid,
        rcnn_test["score_thr"], rcnn_test["nms"]["iou_thr"],
        rcnn_test["max_per_img"])
    out = dict(dets=dets, labels=labels, valid=dvalid)

    # the mask head on the final boxes in every view (aug_test_mask)
    if model.with_mask and not test_cfg.get("return_bbox_only", False):
        aug_masks = []
        for feats, meta in zip(feats_v, metas):
            view_boxes = bbox_mapping_3d(dets[..., :6], meta["img_shape"],
                                         meta["scale_factor"], meta["flip"])
            logits = mask_stage(model, feats, view_boxes, dvalid, None,
                                cfg.model["mask_roi_extractor"])
            aug_masks.append(torch.sigmoid(logits.float()))
        probs = merge_aug_masks(aug_masks, metas)
        # slots without a detection hold zeros
        out["mask_probs"] = torch.where(
            dvalid.reshape(-1)[:, None, None, None, None], probs, 0.0)
    return out
