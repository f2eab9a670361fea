"""Flagship two-scale inference and training losses (torch): proposals,
the bbox and refinement stages, multi-class NMS, the mask stage, and
`forward_train`.

Port of the flagship branch of `mrcnn3d/detectors/pipeline.py`
(reference two_stage_3d_2scales.py:180-327 forward_train, :335-434
simple_test).  Padded shapes are kept, so the outputs compare directly
with the JAX ones: dets (B, max_per_img, 7), labels (B, max_per_img),
valid (B, max_per_img) and mask_logits (B*max_per_img, num_classes, Dm,
Hm, Wm).

Every RoIAlign goes through the K2 wrapper (`ops/roi_align3d.py`) and
every NMS through the K1 wrapper (`ops/nms3d.py`): per inference step
one K1 launch per scale for the proposals of all levels and images, one
for the class-wise NMS, and four K2 launches (bbox 1.0x, bbox 1.5x,
refinement, mask).  Per train step: two K1 launches (the proposals of
each scale) and five K2 launches (bbox 1.0x, bbox 1.5x, refinement,
mask, refinement mask), each with one launch of K2's backward.

Stable sorts stand in for JAX's argsort and lax.top_k, which break ties
toward the lower index.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.anchors import AnchorGenerator3D, anchor_inside_flags
from ..core.post import multiclass_nms_3d
from ..core.targets import (
    anchor_target_single,
    cat_samples,
    mask_target_single,
    sample_rcnn_single,
    stack_samples,
)
from ..ops.box3d import delta2bbox3d
from ..ops.losses import (
    accuracy,
    mask_cross_entropy,
    weighted_binary_cross_entropy,
    weighted_cross_entropy,
    weighted_smoothl1,
)
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


def anchor_sets_for(model, scale_anchor_cfgs, shapes, device="cpu"):
    """One AnchorSet per scale, for the (D, H, W) input of each scale."""
    return [
        build_anchor_set(model.featmap_sizes((d, h, w)), (h, w, 3, d), ac,
                         device)
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def rpn_loss(cls_outs, reg_outs, anchor_set, gt_boxes, gt_valid, draws,
             site, cfg_rpn, suffix="", means=RPN_MEANS, stds=RPN_STDS):
    """RPN cls and reg loss over the flat multi-level anchors (reference
    anchor_head_3d.py:127-230; per-level sums with one avg_factor are one
    flat sum).  cls_outs[l] (B, A, d, h, w); reg_outs[l] (B, A*6, d, h,
    w); each image samples at site + (image,)."""
    b = cls_outs[0].shape[0]
    cls_flat = torch.cat(
        [c.permute(0, 2, 3, 4, 1).reshape(b, -1) for c in cls_outs], 1)
    reg_flat = torch.cat(
        [r.permute(0, 2, 3, 4, 1).reshape(b, -1, 6) for r in reg_outs], 1)
    anchors = torch.cat(list(anchor_set.anchors))
    inside = torch.cat(list(anchor_set.inside))
    per_image = [
        anchor_target_single(draws, site + (i,), anchors, inside,
                             gt_boxes[i], gt_valid[i], cfg_rpn, means, stds)
        for i in range(b)
    ]
    tgt = {k: torch.stack([t[k] for t in per_image]) for k in per_image[0]}
    num_total = (tgt["num_pos"].sum() + tgt["num_neg"].sum()).float()
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
    avg_cls = torch.clamp((label_weights > 0).sum(), min=1).float()
    avg_reg = (samples.pos_count.sum() + samples.neg_count.sum()).float()
    return {
        f"loss_cls{suffix}": weighted_cross_entropy(
            cls_score, labels, label_weights, avg_cls),
        f"acc{suffix}": accuracy(cls_score.float(), labels, roi_valid),
        f"loss_reg{suffix}": weighted_smoothl1(
            _class_deltas(bbox_pred, labels, num_classes),
            samples.bbox_targets.reshape(-1, 6), is_pos[:, None].float(),
            1.0, avg_reg),
    }


def _mask_branch_loss(feats, samples, gt_masks, mask_roi_cfg, rcnn_cfg, fwd):
    """The positive rois' mask branch (reference two_stage_3d_2scales.py
    :301-327): the positive quota's slots -> RoIAlign -> `fwd` logits ->
    mask targets -> mask BCE."""
    sampler = rcnn_cfg["sampler"]
    quota = int(round(sampler["num"] * sampler["pos_fraction"]))
    pos_rois = samples.rois[:, :quota]
    pos_mask = samples.is_pos[:, :quota]
    pos_gt = samples.gt_idx[:, :quota]
    rois, rvalid = flat_rois(pos_rois, pos_mask)
    mpred = fwd(roi_align(feats, rois, mask_roi_cfg, rvalid))
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
                  rcnn_cfg, means, stds):
    """sample_rcnn_single per image, stacked; image i samples at
    site + (i,)."""
    return stack_samples([
        sample_rcnn_single(draws, site + (i,), boxes[i], valid[i],
                           gt_boxes[i], gt_valid[i], gt_labels[i], rcnn_cfg,
                           means, stds)
        for i in range(boxes.shape[0])
    ])


def forward_train(model, batch, cfg, anchor_sets, draws, mark=None):
    """The flagship's training forward (`mrcnn3d/detectors/pipeline.py`
    forward_train, its two-scale shared-head branch): the RPN losses of
    both scales; proposals (K1, from detached RPN outputs) sampled for
    the shared bbox head over both scales; the refinement head on the
    1.5x pathway's decoded class-1 boxes, detached and brought to the
    1.0x frame; the mask and refinement mask heads on their positives.

    batch: imgs (B, 3, D, H, W), gt_boxes (B, G, 6), gt_labels (B, G),
    gt_valid (B, G), the same with suffix _2 for the 1.5x twin, and
    gt_masks (B, G, D, H, W) at 1.0x.  draws: the samplers' integer
    source (`core.targets`); sites are ("rpn" | "rcnn", scale, image)
    and ("refine", 1, image).  mark: optional callable, called with a
    stage name after each stage.  Returns (total, loss dict): total is
    the sum of the entries whose key contains "loss".
    """
    if not (model.num_scales == 2 and model.share_heads
            and model.with_refinement and model.with_refinement_mask):
        raise NotImplementedError(
            "forward_train ports the flagship (two scales, shared heads, "
            "refinement and refinement mask heads); the variants are "
            "ROADMAP Queue A item 11")
    mark = mark or _no_mark
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
    for s in range(2):
        sfx = "" if s == 0 else "_2"
        imgs = batch["imgs" + sfx]
        gtb, gtv = batch["gt_boxes" + sfx], batch["gt_valid" + sfx]
        feats = model.extract_feat(imgs)
        mark(f"backbone_fpn_{s}")
        rpn_outs = model.rpn(feats, s)
        cls_outs = [o[0] for o in rpn_outs]
        reg_outs = [o[1] for o in rpn_outs]
        losses.update(rpn_loss(cls_outs, reg_outs, anchor_sets[s], gtb, gtv,
                               draws, ("rpn", s), train_cfg["rpn"], sfx,
                               rpn_means, rpn_stds))
        with torch.no_grad():
            # proposals carry no gradient (the reference's get_bboxes
            # runs on detached outputs)
            pboxes, _, pvalid = gen_proposals(
                [c.detach() for c in cls_outs], [r.detach() for r in reg_outs],
                anchor_sets[s], _img_shape(imgs), train_cfg["rpn_proposal"],
                means=rpn_means, stds=rpn_stds)
        samples_s.append(_sample_batch(
            draws, ("rcnn", s), pboxes, pvalid, gtb, gtv,
            batch["gt_labels" + sfx], rcnn_cfg, means, stds))
        feats_s.append(feats)
        mark(f"rpn_targets_{s}")

    # the shared bbox head over both scales (reference :239-257)
    cls_all, pred_all = [], []
    for s in range(2):
        rois, rvalid = flat_rois(samples_s[s].rois, samples_s[s].roi_valid)
        cls_score, bbox_pred = model.bbox_forward(
            roi_align(feats_s[s], rois, roi_cfg, rvalid), s)
        cls_all.append(cls_score)
        pred_all.append(bbox_pred)
    losses.update(bbox_stage_loss(torch.cat(cls_all), torch.cat(pred_all),
                                  cat_samples(samples_s), nc, pos_weight))
    mark("bbox_heads")

    # the refinement head (reference :259-298): the 1.5x pathway's
    # class-1 boxes, decoded from detached deltas, in the 1.0x frame
    imgs = batch["imgs"]
    b, r = samples_s[1].rois.shape[:2]
    rois2, _ = flat_rois(samples_s[1].rois, samples_s[1].roi_valid)
    decoded = delta2bbox3d(rois2[:, 1:], pred_all[1].detach().float(), means,
                           stds, _img_shape(batch["imgs_2"]))
    upscale = cfg.get("upscale_factor", 1.5)
    pred_boxes = decoded.reshape(b, r, nc * 6)[..., 6:12] / upscale
    ref_samples = _sample_batch(
        draws, ("refine", 1), pred_boxes, samples_s[1].roi_valid,
        batch["gt_boxes"], batch["gt_valid"], batch["gt_labels"], rcnn_cfg,
        means, stds)
    rrois, rvalid = flat_rois(ref_samples.rois, ref_samples.roi_valid)
    ref_pred = model.refinement_forward(
        roi_align(feats_s[0], rrois, roi_cfg, rvalid))
    avg = (ref_samples.pos_count.sum() + ref_samples.neg_count.sum()).float()
    losses["loss_refinement_reg"] = weighted_smoothl1(
        _class_deltas(ref_pred, ref_samples.labels.reshape(-1), nc),
        ref_samples.bbox_targets.reshape(-1, 6),
        ref_samples.is_pos.reshape(-1)[:, None].float(), 1.0, avg)
    mark("refinement")

    # the mask heads (reference :301-327), both on the 1.0x features
    mask_cfg = cfg.model["mask_roi_extractor"]
    losses["loss_mask"] = _mask_branch_loss(
        feats_s[0], samples_s[0], batch["gt_masks"], mask_cfg, rcnn_cfg,
        model.mask_forward)
    losses["loss_mask_refinement"] = _mask_branch_loss(
        feats_s[0], ref_samples, batch["gt_masks"], mask_cfg, rcnn_cfg,
        model.refinement_mask_forward)
    mark("mask_heads")
    total = sum(v for k, v in losses.items() if "loss" in k)
    return total, losses
