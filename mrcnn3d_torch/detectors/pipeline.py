"""The 3-D two-stage detectors' inference and training losses (torch):
proposals, the bbox and refinement stages, multi-class NMS, the mask
stage, and `forward_train`.

Port of the 3-D two-stage branch of `mrcnn3d/detectors/pipeline.py`
(reference two_stage_3d_2scales.py:180-327 forward_train, :335-434
simple_test; rpn_3d.py for the RPN-only detector), for one, two or three
pathways, shared or per-scale heads, with or without the refinement,
mask and parcellation heads (`models/detector.py`).  Padded shapes are
kept, so the outputs compare directly with the JAX ones: dets (B,
max_per_img, 7), labels (B, max_per_img), valid (B, max_per_img),
mask_logits (B*max_per_img, num_classes, Dm, Hm, Wm) and parcellations
(B, max_per_img, P).

Every RoIAlign goes through the K2 wrapper (`ops/roi_align3d.py`) and
every NMS through the K1 wrapper (`ops/nms3d.py`).  Per inference step:
one K1 launch per scale for the proposals of all levels and images and
one for the class-wise NMS; one K2 launch per scale's bbox align, one for
the refinement and one for the mask stage (the flagship: K1 3, K2 4).
Per train step: one K1 launch per scale's proposals and one K2 launch
(with one of K2's backward) per scale's bbox align, the refinement, the
mask and the refinement mask (the flagship: K1 2, K2 5).  The RPN-only
detector runs one K1 launch at inference and none in training.

The single-stage and cascade families (`mrcnn3d/detectors/pipeline.py`
single_stage_*, cascade_*): RetinaNet3D decodes every level's top
anchors and runs one class-wise K1 launch (none in training, which has
no proposals); a cascade runs the RPN's K1 launch, one K2 launch per
stage's bbox align and the class-wise K1 launch, and HTC adds one K2
launch per stage on the semantic map (one level) and, for the masks, one
on the FPN and one on the semantic map (inference: K1 2, K2 8; training:
K1 1, K2 and its backward 12).

Stable sorts stand in for JAX's argsort and lax.top_k, which break ties
toward the lower index.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..core.anchors import AnchorGenerator3D, anchor_inside_flags
from ..core.post import multiclass_nms_3d
from ..core.targets import (
    anchor_target_focal_single,
    anchor_target_single,
    cat_samples,
    mask_target_single,
    sample_rcnn_single,
    stack_samples,
)
from ..ops.box3d import delta2bbox3d
from ..ops.losses import (
    accuracy,
    expand_binary_labels,
    mask_cross_entropy,
    weighted_binary_cross_entropy,
    weighted_cross_entropy,
    weighted_sigmoid_focal_loss,
    weighted_smoothl1,
)
from ..ops.nms3d import nms_3d_mask_segments, sort_desc, top_kept
from ..ops.resize3d import jax_resize
from ..ops.roi_align3d import multi_level_roi_align_3d
from ..core.reduce import global_sum

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


def anchor_sets_for(model, scale_anchor_cfgs, shapes, device="cpu",
                    allowed_border=0):
    """One AnchorSet per scale, for the (D, H, W) input of each scale.
    Training passes train_cfg.rpn.allowed_border, as
    `mrcnn3d/apis/train_api.py:compute_anchor_sets` does."""
    return [
        build_anchor_set(model.featmap_sizes((d, h, w)), (h, w, 3, d), ac,
                         device, allowed_border)
        for (d, h, w), ac in zip(shapes, scale_anchor_cfgs)
    ]


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


SUFFIXES = ("", "_2", "_3")


def scale_shapes(model, batch):
    """The (D, H, W) input of each of the model's scales in `batch`."""
    return [tuple(batch["imgs" + SUFFIXES[s]].shape[2:])
            for s in range(model.num_scales)]


def simple_test(model, batch, cfg, anchor_sets, rescale=True, mark=None):
    """Inference (reference two_stage_3d_2scales.py:335-434 and its
    variants; `mrcnn3d/detectors/pipeline.py` simple_test).

    batch: imgs (B, 3, D, H, W) and, per further scale s, imgs_{s+1}
    (upscale_factor ** s larger); optionally proposals{,_2,_3} (B, M, 6)
    with proposals_valid{,_2,_3} (B, M), which replace the RPN.  mark:
    optional callable, called with a stage name after each stage (the
    timing hook of chip_smoke.py).  Returns dict(dets, labels, valid[,
    mask_logits][, parcellations]) in the 1.0x frame.  Without a bbox
    head (RPN3D) the 1.0x proposals are the detections, label 0.
    """
    mark = mark or _no_mark
    if model.single_stage:
        return single_stage_test(model, batch, cfg, anchor_sets, mark)
    if model.cascade_stages > 0:
        return cascade_simple_test(model, batch, cfg, anchor_sets, mark)
    test_cfg = cfg.test_cfg
    rcnn_test = test_cfg["rcnn"]
    roi_cfg = cfg.model["bbox_roi_extractor"]
    upscale = cfg.get("upscale_factor", 1.5)
    rpn_means, rpn_stds = rpn_codec(cfg)
    means = tuple(cfg.model["bbox_head"]["target_means"])
    stds = tuple(cfg.model["bbox_head"]["target_stds"])
    mark("start")

    if not model.with_bbox:
        # RPN-only: the proposals are the detections (reference
        # rpn_3d.py simple_test; `pipeline.py:1120-1141`)
        imgs = batch["imgs"]
        feats = model.extract_feat(imgs)
        mark("backbone_fpn_0")
        rpn_outs = model.rpn(feats, 0)
        pboxes, pscores, pvalid = gen_proposals(
            [o[0] for o in rpn_outs], [o[1] for o in rpn_outs],
            anchor_sets[0], _img_shape(imgs), test_cfg["rpn"],
            means=rpn_means, stds=rpn_stds,
        )
        mark("proposals_0")
        return dict(dets=torch.cat([pboxes, pscores[..., None]], -1),
                    labels=torch.zeros(pboxes.shape[:2], dtype=torch.long,
                                       device=pboxes.device),
                    valid=pvalid)

    feats_s, boxes_s, scores_s, valid_s, parcel_s = [], [], [], [], []
    for s in range(model.num_scales):
        sfx = SUFFIXES[s]
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
        head_out = model.bbox_forward(
            roi_align(feats, rois, roi_cfg, rvalid), s
        )
        m = pboxes.shape[1]
        if model.num_parcellations > 0:
            parcel_s.append(torch.softmax(head_out[2].float(), dim=-1)
                            .reshape(b, m, -1))
        scores = torch.softmax(head_out[0].float(), dim=-1)
        boxes = delta2bbox3d(rois[:, 1:], head_out[1].float(), means, stds,
                             img_shape)
        scale_factor = 1.0 if s == 0 else upscale ** s
        if rescale and scale_factor != 1.0:
            boxes = boxes / scale_factor
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
    if parcel_s:
        # the parcellation scores ride through NMS by source row
        # (reference multiclass_nms_3d_parcel, bbox_nms.py:108-159)
        parcel = torch.cat(parcel_s, 1)
        out["parcellations"] = torch.gather(
            parcel, 1, src_idx[..., None].expand(-1, -1, parcel.shape[2]))
    if model.with_mask and not test_cfg.get("return_bbox_only", False):
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
    out = torch.zeros((rois.shape[0], model.num_classes)
                      + model.mask_size(od, o), dtype=mfeat.dtype,
                      device=mfeat.device)
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def rpn_loss(cls_outs, reg_outs, anchor_set, gt_boxes, gt_valid, draws,
             site, cfg_rpn, suffix="", means=RPN_MEANS, stds=RPN_STDS,
             offset=0):
    """RPN cls and reg loss over the flat multi-level anchors (reference
    anchor_head_3d.py:127-230; per-level sums with one avg_factor are one
    flat sum).  cls_outs[l] (B, A, d, h, w); reg_outs[l] (B, A*6, d, h,
    w); image i samples at site + (offset + i,), its global index."""
    b = cls_outs[0].shape[0]
    cls_flat = torch.cat(
        [c.permute(0, 2, 3, 4, 1).reshape(b, -1) for c in cls_outs], 1)
    reg_flat = torch.cat(
        [r.permute(0, 2, 3, 4, 1).reshape(b, -1, 6) for r in reg_outs], 1)
    anchors = torch.cat(list(anchor_set.anchors))
    inside = torch.cat(list(anchor_set.inside))
    per_image = [
        anchor_target_single(draws, site + (offset + i,), anchors, inside,
                             gt_boxes[i], gt_valid[i], cfg_rpn, means, stds)
        for i in range(b)
    ]
    tgt = {k: torch.stack([t[k] for t in per_image]) for k in per_image[0]}
    num_total = global_sum(
        (tgt["num_pos"].sum() + tgt["num_neg"].sum()).float())
    loss_cls = weighted_binary_cross_entropy(
        cls_flat.reshape(-1), tgt["labels"].reshape(-1),
        tgt["label_weights"].reshape(-1), num_total)
    loss_reg = weighted_smoothl1(
        reg_flat.reshape(-1, 6), tgt["bbox_targets"].reshape(-1, 6),
        tgt["bbox_weights"].reshape(-1, 6),
        cfg_rpn.get("smoothl1_beta", 1.0 / 9.0), num_total)
    return {f"loss_rpn_cls{suffix}": loss_cls,
            f"loss_rpn_reg{suffix}": loss_reg}


def _class_deltas(pred, labels, num_classes):
    """(N, 6*C) class-specific deltas -> the labelled class's (N, 6)."""
    per_class = pred.float().reshape(pred.shape[0], num_classes, 6)
    idx = labels.long()[:, None, None].expand(-1, 1, 6)
    return torch.gather(per_class, 1, idx)[:, 0]


def bbox_stage_loss(cls_score, bbox_pred, samples, num_classes, pos_weight,
                    suffix=""):
    """R-CNN bbox head loss (reference bbox_head_3d.py:86-135) over the
    flattened samples of a batch (an RcnnSample with a leading batch
    dim)."""
    labels = samples.labels.reshape(-1)
    roi_valid = samples.roi_valid.reshape(-1)
    is_pos = samples.is_pos.reshape(-1)
    pw = 1.0 if pos_weight <= 0 else float(pos_weight)
    label_weights = torch.where(
        roi_valid, torch.where(is_pos, pw, 1.0), 0.0)
    avg_cls = torch.clamp(global_sum((label_weights > 0).sum()),
                          min=1).float()
    avg_reg = global_sum(
        (samples.pos_count.sum() + samples.neg_count.sum()).float())
    return {
        f"loss_cls{suffix}": weighted_cross_entropy(
            cls_score, labels, label_weights, avg_cls),
        f"acc{suffix}": accuracy(cls_score.float(), labels, roi_valid),
        f"loss_reg{suffix}": weighted_smoothl1(
            _class_deltas(bbox_pred, labels, num_classes),
            samples.bbox_targets.reshape(-1, 6), is_pos[:, None].float(),
            1.0, avg_reg),
    }


def _mask_branch_loss(feats, samples, gt_masks, mask_roi_cfg, rcnn_cfg, fwd,
                      fuse=None):
    """The positive rois' mask branch (reference two_stage_3d_2scales.py
    :301-327, htc.py:72-111): the positive quota's slots -> RoIAlign (+
    `fuse(rois, valid)`, HTC's semantic features) -> `fwd` logits -> mask
    targets -> mask BCE."""
    sampler = rcnn_cfg["sampler"]
    quota = int(round(sampler["num"] * sampler["pos_fraction"]))
    pos_rois = samples.rois[:, :quota]
    pos_mask = samples.is_pos[:, :quota]
    pos_gt = samples.gt_idx[:, :quota]
    rois, rvalid = flat_rois(pos_rois, pos_mask)
    mfeats = roi_align(feats, rois, mask_roi_cfg, rvalid)
    if fuse is not None:
        mfeats = mfeats + fuse(rois, rvalid)
    mpred = fwd(mfeats)
    size, size_d = rcnn_cfg["mask_size"], rcnn_cfg["mask_size_depth"]
    targets = torch.stack([
        mask_target_single(pos_rois[i], pos_mask[i], pos_gt[i], gt_masks[i],
                           size, size_d)
        for i in range(pos_rois.shape[0])
    ])
    return mask_cross_entropy(mpred, targets.reshape(-1, size_d, size, size),
                              samples.labels[:, :quota].reshape(-1),
                              valid=rvalid)


def _sample_batch(draws, site, boxes, valid, gt_boxes, gt_valid, gt_labels,
                  rcnn_cfg, means, stds, offset=0, scores=None):
    """sample_rcnn_single per image, stacked; image i samples at
    site + (offset + i,), its index in the global batch; `scores` (B, N),
    the proposals' scores, rank the negatives under an OHEM sampler."""
    return stack_samples([
        sample_rcnn_single(draws, site + (offset + i,), boxes[i], valid[i],
                           gt_boxes[i], gt_valid[i], gt_labels[i], rcnn_cfg,
                           means, stds, proposal_scores=(
                               None if scores is None else scores[i]))
        for i in range(boxes.shape[0])
    ])


def _parcellation_loss(parcel_all, samples_s, batch, pos_weight):
    """The brain-region branch's loss and accuracy over every scale's
    samples (reference bbox_head_3d_parcel.py:123-126; targets
    bbox_target.py:152-181: a positive takes its gt's region at
    pos_weight, a negative region 0 at weight 1)."""
    pw = 1.0 if pos_weight <= 0 else float(pos_weight)
    regions, weights = [], []
    for s, smp in enumerate(samples_s):
        gt = batch.get("gt_bregions" + SUFFIXES[s], batch["gt_bregions"])
        reg = torch.gather(gt.long(), 1, smp.gt_idx.long())
        regions.append(torch.where(smp.is_pos, reg, 0).reshape(-1))
        weights.append(torch.where(
            smp.roi_valid, torch.where(smp.is_pos, pw, 1.0), 0.0
        ).reshape(-1))
    logits = torch.cat(parcel_all)
    regions, weights = torch.cat(regions), torch.cat(weights)
    avg = torch.clamp(global_sum((weights > 0).sum()), min=1).float()
    return {
        "loss_parcellation_cls": weighted_cross_entropy(
            logits, regions, weights, avg),
        "acc_parcellation": accuracy(logits.float(), regions, weights > 0),
    }


def forward_train(model, batch, cfg, anchor_sets, draws, mark=None,
                  offset=0):
    """The training forward (`mrcnn3d/detectors/pipeline.py`
    forward_train, its 3-D two-stage branch, :528-820): each scale's RPN
    losses (suffixed _2, _3); without a bbox head, nothing more.  Else
    proposals (K1, from detached RPN outputs) sampled per scale for the
    bbox head(s): one loss over every scale when the head is shared,
    one per scale (suffixed) when not; the parcellation loss; the
    refinement head on the 1.5x pathway's decoded class-1 boxes,
    detached and brought to the 1.0x frame; the mask head (head 0) and
    the refinement mask head on their positives, on the 1.0x features.

    batch: imgs (B, 3, D, H, W), gt_boxes (B, G, 6), gt_labels (B, G),
    gt_valid (B, G), the same with suffix _2 (_3) for each further
    scale, gt_masks (B, G, D, H, W) at 1.0x with a mask head and
    gt_bregions (B, G) with a parcellation head.  draws: the samplers'
    integer source (`core.targets`); sites are ("rpn" | "rcnn", scale,
    image) and ("refine", 1, image), image the global index: `offset`
    (the rows of the ranks before this one) plus the local one.  Under
    a process group of more than one rank the caller enters
    `core.reduce.loss_group` (`train.step.train_step` does): under the
    data group every normalizer counts over the global batch, under
    `loss_group(None)` over this rank's rows; outside one it raises.
    mark: optional callable, called with a stage name after each
    stage.  Returns (total, loss dict): total is the sum of the entries
    whose key contains "loss".
    """
    mark = mark or _no_mark
    if model.single_stage:
        return single_stage_forward_train(model, batch, cfg, anchor_sets,
                                          mark)
    if model.cascade_stages > 0:
        return cascade_forward_train(model, batch, cfg, anchor_sets, draws,
                                     mark, offset)
    train_cfg = cfg.train_cfg
    rcnn_cfg = train_cfg["rcnn"]
    nc = model.num_classes
    rpn_means, rpn_stds = rpn_codec(cfg)
    means = tuple(cfg.model["bbox_head"]["target_means"])
    stds = tuple(cfg.model["bbox_head"]["target_stds"])
    pos_weight = rcnn_cfg.get("pos_weight", -1)
    roi_cfg = cfg.model["bbox_roi_extractor"]

    losses = {}
    feats_s, samples_s = [], []
    for s in range(model.num_scales):
        sfx = SUFFIXES[s]
        imgs = batch["imgs" + sfx]
        gtb, gtv = batch["gt_boxes" + sfx], batch["gt_valid" + sfx]
        feats = model.extract_feat(imgs)
        feats_s.append(feats)
        mark(f"backbone_fpn_{s}")
        rpn_outs = model.rpn(feats, s)
        cls_outs = [o[0] for o in rpn_outs]
        reg_outs = [o[1] for o in rpn_outs]
        losses.update(rpn_loss(cls_outs, reg_outs, anchor_sets[s], gtb, gtv,
                               draws, ("rpn", s), train_cfg["rpn"], sfx,
                               rpn_means, rpn_stds, offset))
        if not model.with_bbox:
            # RPN-only (reference rpn_3d.py): no proposals, no R-CNN
            mark(f"rpn_targets_{s}")
            continue
        with torch.no_grad():
            # proposals carry no gradient (the reference's get_bboxes
            # runs on detached outputs)
            pboxes, pscores, pvalid = gen_proposals(
                [c.detach() for c in cls_outs], [r.detach() for r in reg_outs],
                anchor_sets[s], _img_shape(imgs), train_cfg["rpn_proposal"],
                means=rpn_means, stds=rpn_stds)
        # the proposals' scores rank the negatives under an OHEM sampler
        # (`mrcnn3d/detectors/pipeline.py:650`)
        samples_s.append(_sample_batch(
            draws, ("rcnn", s), pboxes, pvalid, gtb, gtv,
            batch["gt_labels" + sfx], rcnn_cfg, means, stds, offset,
            pscores))
        mark(f"rpn_targets_{s}")
    if not model.with_bbox:
        return _total(losses), losses

    # the bbox head(s) over every scale (reference :239-257)
    cls_all, pred_all, parcel_all = [], [], []
    for s in range(model.num_scales):
        rois, rvalid = flat_rois(samples_s[s].rois, samples_s[s].roi_valid)
        out = model.bbox_forward(
            roi_align(feats_s[s], rois, roi_cfg, rvalid), s)
        cls_all.append(out[0])
        pred_all.append(out[1])
        if model.num_parcellations > 0:
            parcel_all.append(out[2])
    if model.share_heads:
        losses.update(bbox_stage_loss(
            torch.cat(cls_all), torch.cat(pred_all), cat_samples(samples_s),
            nc, pos_weight))
    else:
        for s in range(model.num_scales):
            losses.update(bbox_stage_loss(
                cls_all[s], pred_all[s], samples_s[s], nc, pos_weight,
                suffix=SUFFIXES[s]))
    if parcel_all and "gt_bregions" in batch:
        losses.update(_parcellation_loss(parcel_all, samples_s, batch,
                                         pos_weight))
    mark("bbox_heads")

    ref_samples = None
    if model.with_refinement:
        # the refinement head (reference :259-298): the 1.5x pathway's
        # class-1 boxes, decoded from detached deltas, in the 1.0x frame
        b, r = samples_s[1].rois.shape[:2]
        rois2, _ = flat_rois(samples_s[1].rois, samples_s[1].roi_valid)
        decoded = delta2bbox3d(rois2[:, 1:], pred_all[1].detach().float(),
                               means, stds, _img_shape(batch["imgs_2"]))
        upscale = cfg.get("upscale_factor", 1.5)
        pred_boxes = decoded.reshape(b, r, nc * 6)[..., 6:12] / upscale
        ref_samples = _sample_batch(
            draws, ("refine", 1), pred_boxes, samples_s[1].roi_valid,
            batch["gt_boxes"], batch["gt_valid"], batch["gt_labels"],
            rcnn_cfg, means, stds, offset)
        rrois, rvalid = flat_rois(ref_samples.rois, ref_samples.roi_valid)
        ref_pred = model.refinement_forward(
            roi_align(feats_s[0], rrois, roi_cfg, rvalid))
        avg = global_sum((ref_samples.pos_count.sum()
                          + ref_samples.neg_count.sum()).float())
        losses["loss_refinement_reg"] = weighted_smoothl1(
            _class_deltas(ref_pred, ref_samples.labels.reshape(-1), nc),
            ref_samples.bbox_targets.reshape(-1, 6),
            ref_samples.is_pos.reshape(-1)[:, None].float(), 1.0, avg)
        mark("refinement")

    if model.with_mask:
        # the mask heads (reference :301-327), on the 1.0x features; with
        # per-scale heads the mask stage still runs head 0
        mask_cfg = cfg.model["mask_roi_extractor"]
        losses["loss_mask"] = _mask_branch_loss(
            feats_s[0], samples_s[0], batch["gt_masks"], mask_cfg, rcnn_cfg,
            model.mask_forward)
        if model.with_refinement_mask and ref_samples is not None:
            losses["loss_mask_refinement"] = _mask_branch_loss(
                feats_s[0], ref_samples, batch["gt_masks"], mask_cfg,
                rcnn_cfg, model.refinement_mask_forward)
        mark("mask_heads")
    return _total(losses), losses


def _total(losses):
    """The sum of the entries whose key contains "loss" (reference
    apis/train.py:17-34 parse_losses)."""
    return sum(v for k, v in losses.items() if "loss" in k)


# ---------------------------------------------------------------------------
# the single-stage family (RetinaNet3D)
# ---------------------------------------------------------------------------


def _level_rows(t, b, width):
    """(B, A*width, d, h, w) -> (B, d*h*w*A, width): the anchors' (z, y,
    x, a) order."""
    return t.permute(0, 2, 3, 4, 1).reshape(b, -1, width)


def single_stage_test(model, batch, cfg, anchor_sets, mark=_no_mark):
    """RetinaNet-style inference (`mrcnn3d/detectors/pipeline.py`
    single_stage_test_single, vmapped there): per level the top nms_pre
    anchors by their best sigmoid class score, decoded; then the
    class-wise NMS of every level's rows at once (one K1 launch).
    Returns dict(dets, labels, valid)."""
    test_cfg = cfg.test_cfg
    rcnn = test_cfg["rcnn"]
    nms_pre = test_cfg["rpn"]["nms_pre"] if "rpn" in test_cfg else 1000
    means, stds = rpn_codec(cfg)
    c_out = model.num_classes - 1
    imgs = batch["imgs"]
    b = imgs.shape[0]
    feats = model.extract_feat(imgs)
    mark("backbone_fpn_0")
    outs = model.rpn(feats, 0)
    boxes, scores = [], []
    for (cls, reg), anchors in zip(outs, anchor_sets[0].anchors):
        sc = torch.sigmoid(_level_rows(cls.float(), b, c_out))
        deltas = _level_rows(reg.float(), b, 6)
        n = sc.shape[1]
        if n > nms_pre:
            top_i = sort_desc(sc.max(-1).values)[1][:, :nms_pre]
            anchors = anchors[top_i]
            deltas = torch.gather(deltas, 1,
                                  top_i[..., None].expand(-1, -1, 6))
            sc = torch.gather(sc, 1, top_i[..., None].expand(-1, -1, c_out))
        else:
            anchors = anchors.expand(b, n, 6)
        boxes.append(delta2bbox3d(anchors, deltas, means, stds,
                                  _img_shape(imgs)))
        scores.append(sc)
    scores = torch.cat(scores, 1)
    # background column 0, then the per-class sigmoid scores
    multi = torch.cat([scores.new_zeros(scores.shape[:2] + (1,)), scores],
                      -1)
    valid = torch.ones(scores.shape[:2], dtype=torch.bool,
                       device=scores.device)
    mark("decode")
    dets, labels, dvalid, _ = multiclass_nms_3d(
        torch.cat(boxes, 1), multi, valid, rcnn["score_thr"],
        rcnn["nms"]["iou_thr"], rcnn["max_per_img"])
    mark("nms")
    return dict(dets=dets, labels=labels, valid=dvalid)


def single_stage_loss(cls_outs, reg_outs, anchor_set, gt_boxes, gt_valid,
                      gt_labels, cfg_ss, num_classes, means=RPN_MEANS,
                      stds=RPN_STDS):
    """The focal-loss head's loss (`mrcnn3d/detectors/pipeline.py`
    single_stage_loss; reference anchor_head.py focal path): no
    sampling, every assigned anchor counts, both losses averaged over
    the batch's positives.  cls_outs[l] (B, A*(C-1), d, h, w); reg_outs[l]
    (B, A*6, d, h, w)."""
    b = cls_outs[0].shape[0]
    c_out = num_classes - 1
    cls_flat = torch.cat([_level_rows(c, b, c_out) for c in cls_outs], 1)
    reg_flat = torch.cat([_level_rows(r, b, 6) for r in reg_outs], 1)
    anchors = torch.cat(list(anchor_set.anchors))
    inside = torch.cat(list(anchor_set.inside))
    per_image = [
        anchor_target_focal_single(anchors, inside, gt_boxes[i],
                                   gt_valid[i], gt_labels[i], cfg_ss, means,
                                   stds)
        for i in range(b)
    ]
    tgt = {k: torch.stack([t[k] for t in per_image]) for k in per_image[0]}
    num_pos = global_sum(tgt["num_pos"].sum().float())
    weights = tgt["label_weights"].reshape(-1)
    bin_labels, _ = expand_binary_labels(tgt["labels"].reshape(-1), weights,
                                         c_out)
    return {
        "loss_cls": weighted_sigmoid_focal_loss(
            cls_flat.reshape(-1, c_out), bin_labels, weights[:, None],
            num_pos, gamma=cfg_ss.get("gamma", 2.0),
            alpha=cfg_ss.get("alpha", 0.25)),
        "loss_reg": weighted_smoothl1(
            reg_flat.reshape(-1, 6), tgt["bbox_targets"].reshape(-1, 6),
            tgt["bbox_weights"].reshape(-1, 6),
            cfg_ss.get("smoothl1_beta", 1.0 / 9.0), num_pos),
    }


def single_stage_forward_train(model, batch, cfg, anchor_sets,
                               mark=_no_mark):
    """RetinaNet3D's training forward: the focal head's losses (no
    proposals, no draws)."""
    means, stds = rpn_codec(cfg)
    feats = model.extract_feat(batch["imgs"])
    mark("backbone_fpn_0")
    outs = model.rpn(feats, 0)
    losses = single_stage_loss(
        [o[0] for o in outs], [o[1] for o in outs], anchor_sets[0],
        batch["gt_boxes"], batch["gt_valid"], batch["gt_labels"],
        cfg.train_cfg["rpn"], model.num_classes, means, stds)
    mark("targets")
    return _total(losses), losses


# ---------------------------------------------------------------------------
# the cascade family (CascadeRCNN3D, HybridTaskCascade3D)
# ---------------------------------------------------------------------------


def _semantic_roi_feats(sem_feat, rois, rvalid, cfg, out, out_d):
    """HTC's semantic features of the rois (`mrcnn3d/detectors/pipeline.py`
    _semantic_roi_feats; reference htc.py:57-63): one K2 launch on the
    semantic map alone (its one level: every roi maps to it), then an
    adaptive mean to the (out_d, out, out) grid when the extractor's
    grid differs.  JAX's bins, [floor(o*I/O), ceil((o+1)*I/O)), are
    `adaptive_avg_pool3d`'s."""
    scfg = cfg.model.get("semantic_roi_extractor", {})
    layer = scfg.get("roi_layer", {})
    s_out = layer.get("out_size", out)
    s_out_d = layer.get("out_size_depth", out_d)
    x = multi_level_roi_align_3d(
        [sem_feat], rois, s_out, s_out_d, scfg.get("featmap_strides", [8]),
        scfg.get("featmap_strides_depth", [4]), layer.get("sample_num", 2),
        valid=rvalid)
    if s_out != out or s_out_d != out_d:
        x = F.adaptive_avg_pool3d(x, (out_d, out, out))
    return x


def _fusion(cfg):
    return tuple(cfg.model.get("semantic_fusion", ("bbox", "mask")))


def _cascade_codec(cfg):
    head = cfg.model["bbox_head"]
    return tuple(head["target_means"]), tuple(head["target_stds"])


def _cascade_proposals(model, imgs, feats, cfg, anchor_set, stage_cfg):
    """The RPN of a cascade: (rpn outputs, proposal boxes, valid), the
    proposals from detached outputs."""
    rpn_means, rpn_stds = rpn_codec(cfg)
    outs = model.rpn(feats, 0)
    with torch.no_grad():
        pboxes, _, pvalid = gen_proposals(
            [o[0].detach() for o in outs], [o[1].detach() for o in outs],
            anchor_set, _img_shape(imgs), stage_cfg, means=rpn_means,
            stds=rpn_stds)
    return outs, pboxes, pvalid


def _stage_roi_feats(feats, sem_feat, rois, rvalid, cfg):
    """A stage's bbox RoI features: the FPN align, plus the semantic
    features under HTC's bbox fusion."""
    roi_cfg = cfg.model["bbox_roi_extractor"]
    x = roi_align(feats, rois, roi_cfg, rvalid)
    if sem_feat is not None and "bbox" in _fusion(cfg):
        layer = roi_cfg["roi_layer"]
        x = x + _semantic_roi_feats(sem_feat, rois, rvalid, cfg,
                                    layer["out_size"],
                                    layer["out_size_depth"])
    return x


def _mask_fuse(sem_feat, cfg):
    """HTC's mask-stage fusion `fuse(rois, valid)`, or None."""
    if sem_feat is None or "mask" not in _fusion(cfg):
        return None
    layer = cfg.model["mask_roi_extractor"]["roi_layer"]
    return lambda rois, rvalid: _semantic_roi_feats(
        sem_feat, rois, rvalid, cfg, layer["out_size"],
        layer["out_size_depth"])


def cascade_simple_test(model, batch, cfg, anchor_sets, mark=_no_mark):
    """Cascade / HTC inference (`mrcnn3d/detectors/pipeline.py`
    cascade_simple_test; reference htc.py:266-389): the stages in turn,
    each decoding its boxes from the previous stage's, their softmax
    scores averaged; the class-wise NMS on the last boxes.  HTC adds the
    semantic features to every roi pass and, for the masks, runs every
    stage's mask head with information flow on the detections and
    averages their sigmoid probabilities, clipped to [1e-6, 1 - 1e-6] and
    returned as logits (zeros on invalid rows).  Honours
    test_cfg.return_bbox_only."""
    test_cfg = cfg.test_cfg
    rcnn_test = test_cfg["rcnn"]
    means, stds = _cascade_codec(cfg)
    imgs = batch["imgs"]
    b = imgs.shape[0]
    img_shape = _img_shape(imgs)
    feats = model.extract_feat(imgs)
    mark("backbone_fpn_0")
    _, boxes, pvalid = _cascade_proposals(model, imgs, feats, cfg,
                                          anchor_sets[0], test_cfg["rpn"])
    mark("proposals_0")
    sem_feat = model.semantic_forward(feats)[1] if model.with_semantic \
        else None
    if sem_feat is not None:
        mark("semantic")
    score_sum = None
    for t in range(model.cascade_stages):
        rois, rvalid = flat_rois(boxes, pvalid)
        cls_score, bbox_pred = model.bbox_forward(
            _stage_roi_feats(feats, sem_feat, rois, rvalid, cfg), t)
        sc = torch.softmax(cls_score.float(), dim=-1)
        score_sum = sc if score_sum is None else score_sum + sc
        boxes = delta2bbox3d(rois[:, 1:], bbox_pred.float(), means, stds,
                             img_shape).reshape(b, -1, 6)
        mark(f"stage_{t}")
    scores = (score_sum / model.cascade_stages).reshape(b, boxes.shape[1],
                                                        -1)
    dets, labels, dvalid, _ = multiclass_nms_3d(
        boxes, scores, pvalid, rcnn_test["score_thr"],
        rcnn_test["nms"]["iou_thr"], rcnn_test["max_per_img"])
    mark("nms")
    out = dict(dets=dets, labels=labels, valid=dvalid)
    if model.with_mask and model.htc and \
            not test_cfg.get("return_bbox_only", False):
        out["mask_logits"] = htc_mask_stage(model, feats, sem_feat, dets,
                                            dvalid, cfg)
        mark("mask")
    return out


def htc_mask_stage(model, feats, sem_feat, dets, dvalid, cfg):
    """HTC's mask ensemble over the valid detection slots: one FPN align
    (+ the semantic align), every stage's head with information flow, at
    most MASK_HEAD_CHUNK rows a call; the mean sigmoid probability as a
    logit."""
    mask_cfg = cfg.model["mask_roi_extractor"]
    rois, rvalid = flat_rois(dets[..., :6], dvalid)
    rows = torch.nonzero(rvalid).flatten()
    mfeat = roi_align(feats, rois[rows], mask_cfg, rvalid[rows])
    fuse = _mask_fuse(sem_feat, cfg)
    if fuse is not None:
        mfeat = mfeat + fuse(rois[rows], rvalid[rows])
    layer = mask_cfg["roi_layer"]
    od, o = layer["out_size_depth"], layer["out_size"]
    out = torch.zeros((rois.shape[0], model.num_classes)
                      + model.mask_size(od, o), dtype=torch.float32,
                      device=mfeat.device)
    info_flow = cfg.model.get("mask_info_flow", True)
    stages = model.cascade_stages
    for chunk in torch.split(torch.arange(rows.shape[0],
                                          device=rows.device),
                             MASK_HEAD_CHUNK):
        x = mfeat[chunk]
        last, prob_sum = None, None
        for t in range(stages):
            logits, feat = model.htc_mask_forward(x, last, t)
            if info_flow:
                last = feat
            p = torch.sigmoid(logits.float())
            prob_sum = p if prob_sum is None else prob_sum + p
        mean_p = torch.clamp(prob_sum / stages, 1e-6, 1.0 - 1e-6)
        out[rows[chunk]] = torch.log(mean_p) - torch.log1p(-mean_p)
    return out


def _semantic_loss(sem_logits, gt_seg, sem_cfg):
    """The semantic head's CE over the fusion level's grid, the target
    (B, D, H, W) resized there nearest as `jax.image.resize` does; the
    ignore label and negative labels weigh 0 (reference htc.py:183-190)."""
    gt = gt_seg.long()
    if tuple(gt.shape[1:]) != tuple(sem_logits.shape[2:]):
        gt = jax_resize(gt, sem_logits.shape[2:], "nearest")
    ignore = int(sem_cfg.get("ignore_label", 255))
    logp = torch.log_softmax(sem_logits.float(), dim=1)
    keep = (gt != ignore) & (gt >= 0)
    safe = torch.where(keep, gt, 0)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    denom = torch.clamp(global_sum(keep.sum()), min=1).float()
    return float(sem_cfg.get("loss_weight", 0.2)) * \
        torch.where(keep, nll, 0.0).sum() / denom


def _htc_mask_stage_loss(model, feats, sem_feat, samples, stage, batch,
                         cfg, rcnn_cfg):
    """One HTC mask stage's loss (`mrcnn3d/detectors/pipeline.py`
    _htc_mask_stage_loss; reference htc.py:72-111): the mask branch with
    the semantic fusion, information flow through heads 0..stage-1 (with
    their gradients, as the reference runs them in the graph)."""
    info_flow = cfg.model.get("mask_info_flow", True)

    def fwd(mfeats):
        last = None
        if info_flow:
            for i in range(stage):
                _, last = model.htc_mask_forward(mfeats, last, i, False)
        return model.htc_mask_forward(mfeats, last, stage)[0]

    return _mask_branch_loss(feats, samples, batch["gt_masks"],
                             cfg.model["mask_roi_extractor"], rcnn_cfg, fwd,
                             fuse=_mask_fuse(sem_feat, cfg))


def cascade_forward_train(model, batch, cfg, anchor_sets, draws,
                          mark=_no_mark, offset=0):
    """Cascade / HTC training losses (`mrcnn3d/detectors/pipeline.py`
    cascade_forward_train; reference htc.py:156-264): the RPN; per stage
    t, sampling against the previous stage's decoded (detached) boxes
    under train_cfg.rcnn[t], the class-agnostic bbox loss weighted by
    the stage's weight (top-level cfg.stage_loss_weights, default [1,
    0.5, 0.25], read where the JAX package reads it); HTC adds the
    semantic CE (when the batch has gt_semantic_seg) and an interleaved
    mask stage that re-samples on this stage's boxes.

    Draw sites: ("rpn", 0, image), ("cascade", t, image) and, for the
    interleaved re-sample, ("htc_mask", t, image) -- JAX's keys 0, 2 + t
    and 2 + stages + t of split(rng, 2 + 2 * stages); image is the
    global index, `offset` plus the local one."""
    train_cfg = cfg.train_cfg
    stages = model.cascade_stages
    rcnn_cfgs = train_cfg["rcnn"]
    if not isinstance(rcnn_cfgs, (list, tuple)):
        rcnn_cfgs = [rcnn_cfgs] * stages
    weights = cfg.get("stage_loss_weights", [1.0, 0.5, 0.25][:stages])
    means, stds = _cascade_codec(cfg)
    rpn_means, rpn_stds = rpn_codec(cfg)
    imgs = batch["imgs"]
    b = imgs.shape[0]
    img_shape = _img_shape(imgs)
    gtb, gtv, gtl = batch["gt_boxes"], batch["gt_valid"], batch["gt_labels"]

    feats = model.extract_feat(imgs)
    mark("backbone_fpn_0")
    outs, pboxes, pvalid = _cascade_proposals(
        model, imgs, feats, cfg, anchor_sets[0], train_cfg["rpn_proposal"])
    losses = rpn_loss([o[0] for o in outs], [o[1] for o in outs],
                      anchor_sets[0], gtb, gtv, draws, ("rpn", 0),
                      train_cfg["rpn"], means=rpn_means, stds=rpn_stds,
                      offset=offset)
    mark("rpn_targets_0")

    sem_feat = None
    if model.with_semantic:
        sem_logits, sem_feat = model.semantic_forward(feats)
        if "gt_semantic_seg" in batch:
            losses["loss_semantic_seg"] = _semantic_loss(
                sem_logits, batch["gt_semantic_seg"],
                cfg.model.get("semantic_head", {}))
        mark("semantic")

    for t, rc in enumerate(rcnn_cfgs[:stages]):
        samples = _sample_batch(draws, ("cascade", t), pboxes, pvalid, gtb,
                                gtv, gtl, rc, means, stds, offset)
        rois, rvalid = flat_rois(samples.rois, samples.roi_valid)
        cls_score, bbox_pred = model.bbox_forward(
            _stage_roi_feats(feats, sem_feat, rois, rvalid, cfg), t)
        labels = samples.labels.reshape(-1)
        is_pos = samples.is_pos.reshape(-1)
        pw = float(rc.get("pos_weight", -1))
        pw = 1.0 if pw <= 0 else pw
        lw = torch.where(samples.roi_valid.reshape(-1),
                         torch.where(is_pos, pw, 1.0), 0.0)
        avg_cls = torch.clamp(global_sum((lw > 0).sum()), min=1).float()
        avg_reg = global_sum((samples.pos_count.sum()
                              + samples.neg_count.sum()).float())
        w = float(weights[t])
        losses[f"s{t}.loss_cls"] = w * weighted_cross_entropy(
            cls_score, labels, lw, avg_cls)
        losses[f"s{t}.loss_reg"] = w * weighted_smoothl1(
            bbox_pred, samples.bbox_targets.reshape(-1, 6),
            is_pos[:, None].float(), 1.0, avg_reg)
        # the next stage's proposals: this stage's decoded boxes
        pboxes = delta2bbox3d(rois[:, 1:], bbox_pred.detach().float(),
                              means, stds, img_shape).reshape(b, -1, 6)
        pvalid = samples.roi_valid
        mark(f"stage_{t}")

        if model.with_mask and model.htc:
            msamples = samples
            if cfg.model.get("interleaved", True):
                msamples = _sample_batch(draws, ("htc_mask", t), pboxes,
                                         pvalid, gtb, gtv, gtl, rc, means,
                                         stds, offset)
            losses[f"s{t}.loss_mask"] = w * _htc_mask_stage_loss(
                model, feats, sem_feat, msamples, t, batch, cfg, rc)
            mark(f"mask_{t}")
    return _total(losses), losses
