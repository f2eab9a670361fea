"""Plain reference of the two-scale Mask R-CNN (MaskRCNN3D2Scales:
reference two_stage_3d_2scales.py simple_test): per scale the backbone
and FPN, the RPN and its proposals, the bbox head on the shared head;
the refinement head on the 1.5x class-1 boxes over the 1.0x features;
the class-wise NMS; the mask heads on the detections, the refinement
mask head for the rows from the 1.5x pathway.

`infer` runs it whole (the control, in the program's place); `check`
follows the program's run: at each stage it compares the program's
output with the reference's on the same rows, and takes the next
stage's rows from the program's own outputs.
"""
from __future__ import annotations

import torch
from torch import nn

from . import compare as cmp
from . import ops
from .nn import BBoxHead, FPN3D, MaskHead, ResNet3D, RPNHead

SCALE_KEYS = ("imgs", "imgs_2")
RPN_HEADS = ("rpn_head", "rpn_head_2")


class Detector(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        m = cfg["model"]
        c = m["neck"]["out_channels"]
        self.backbone = ResNet3D(m["backbone"].get("depth", 50),
                                 m["backbone"].get("base_width", 16))
        self.neck = FPN3D(self.backbone.out_channels, c,
                          m["neck"]["num_outs"])
        anchors = (len(m["rpn_head"]["anchor_scales"])
                   * len(m["rpn_head"]["anchor_ratios"]))
        self.rpn_head = RPNHead(c, anchors)
        self.rpn_head_2 = RPNHead(c, anchors)
        layer = m["bbox_roi_extractor"]["roi_layer"]
        feat = c * layer["out_size_depth"] * layer["out_size"] ** 2
        ncls = m["bbox_head"]["num_classes"]
        self.bbox_head = BBoxHead(feat, m["bbox_head"]["fc_out_channels"],
                                  ncls)
        self.refinement_head = BBoxHead(
            feat, m["refinement_head"]["fc_out_channels"], ncls,
            with_cls=False)
        self.mask_head = MaskHead(c, ncls, m["mask_head"]["num_convs"])
        self.refinement_mask_head = MaskHead(
            c, ncls, m["refinement_mask_head"]["num_convs"])

    def features(self, x):
        return self.neck(self.backbone(x.float()))

    def featmap_sizes(self, dhw):
        return self.neck.featmap_sizes(self.backbone.featmap_sizes(dhw))


def capture(cfg):
    """The program's modules whose outputs the check reads, each with the
    number of calls a request makes, in the order `check` reads them:
    each RPN head once a level, the bbox head once a scale, the
    refinement head once."""
    levels = cfg["model"]["neck"]["num_outs"]
    return {"rpn_head": levels, "rpn_head_2": levels, "bbox_head": 2,
            "refinement_head": 1}


def anchors(model, cfg, batch, device):
    return [ops.anchor_set(model.featmap_sizes(batch[k].shape[2:]),
                           tuple(batch[k].shape[2:]), cfg["model"][h],
                           device)
            for k, h in zip(SCALE_KEYS, RPN_HEADS)]


def _settings(cfg):
    m = cfg["model"]
    return dict(rpn_codec=cmp.codec(m["rpn_head"]),
                codec=cmp.codec(m["bbox_head"]),
                roi=m["bbox_roi_extractor"], mask_roi=m["mask_roi_extractor"],
                upscale=cfg.get("upscale_factor", 1.5),
                rpn=cfg["test_cfg"]["rpn"], rcnn=cfg["test_cfg"]["rcnn"])


def _decode(rois, deltas, st, dhw, s):
    boxes = ops.delta2bbox(rois[:, 1:], deltas.float(), *st["codec"], dhw)
    return boxes / st["upscale"] ** s if s else boxes


def mask_stage(model, feats, dets, valid, refined, mask_roi):
    """Mask logits of every valid slot: the mask head, or the refinement
    mask head for the rows from the 1.5x pathway; zeros elsewhere."""
    rois, rvalid = ops.flat_rois(dets[..., :6], valid)
    rows = torch.nonzero(rvalid).flatten()
    x = cmp.align(feats, rois[rows], rvalid[rows], mask_roi)
    out = x.new_zeros((rois.shape[0], model.mask_head.conv_logits.out_channels)
                      + tuple(2 * n for n in x.shape[2:]))
    for sel, head in ((~refined[rows], model.mask_head),
                      (refined[rows], model.refinement_mask_head)):
        idx = torch.nonzero(sel).flatten()
        if idx.numel():
            out[rows[idx]] = cmp.in_chunks(head, x[idx])
    return out


def flop_plan(model, cfg, shapes, meta):
    """The multiplying layers of one request on meta tensors: both
    scales' backbone, FPN and RPN, the bbox head on max_num proposals a
    scale, the refinement head on max_num rows, one mask head on
    max_per_img detections."""
    m, test = cfg["model"], cfg["test_cfg"]
    c = m["neck"]["out_channels"]
    rows, dets = test["rpn"]["max_num"], test["rcnn"]["max_per_img"]
    bl = m["bbox_roi_extractor"]["roi_layer"]
    ml = m["mask_roi_extractor"]["roi_layer"]
    for key, head in zip(SCALE_KEYS, RPN_HEADS):
        for f in model.features(meta(1, 3, *shapes[key])):
            getattr(model, head)(f)
        model.bbox_head(meta(rows, c, bl["out_size_depth"], bl["out_size"],
                             bl["out_size"]))
    model.refinement_head(meta(rows, c, bl["out_size_depth"],
                               bl["out_size"], bl["out_size"]))
    model.mask_head(meta(dets, c, ml["out_size_depth"], ml["out_size"],
                         ml["out_size"]))


@torch.no_grad()
def infer(model, batch, cfg, anchor_sets):
    """The whole inference by the reference: (outputs, the outputs of the
    captured modules in the program's layout)."""
    st = _settings(cfg)
    cap = {k: [] for k in capture(cfg)}
    feats_s, boxes_s, scores_s, valid_s = [], [], [], []
    for s, (key, head) in enumerate(zip(SCALE_KEYS, RPN_HEADS)):
        dhw = tuple(batch[key].shape[2:])
        feats = model.features(batch[key])
        outs = [getattr(model, head)(f) for f in feats]
        cap[head].extend(outs)
        pboxes, pvalid = ops.proposals([o[0] for o in outs],
                                       [o[1] for o in outs], anchor_sets[s],
                                       dhw, st["rpn"], *st["rpn_codec"])
        rois, rvalid = ops.flat_rois(pboxes, pvalid)
        cls, reg = model.bbox_head(cmp.align(feats, rois, rvalid, st["roi"]))
        cap["bbox_head"].append((cls, reg))
        feats_s.append(feats)
        scores_s.append(torch.softmax(cls.float(), -1)[None])
        boxes_s.append(_decode(rois, reg, st, dhw, s)[None])
        valid_s.append(pvalid)
    dhw = tuple(batch["imgs"].shape[2:])
    rois, rvalid = ops.flat_rois(boxes_s[1][..., 6:12], valid_s[1])
    pred = model.refinement_head(cmp.align(feats_s[0], rois, rvalid,
                                           st["roi"]))
    cap["refinement_head"].append(pred)
    boxes_s[1] = _decode(rois, pred, st, dhw, 0)[None]
    rc = st["rcnn"]
    dets, labels, dvalid, src = ops.classwise_nms(
        torch.cat(boxes_s, 1), torch.cat(scores_s, 1),
        torch.cat(valid_s, 1), rc["score_thr"], rc["nms"]["iou_thr"],
        rc["max_per_img"])
    refined = (src >= boxes_s[0].shape[1]).reshape(-1)
    masks = mask_stage(model, feats_s[0], dets, dvalid, refined,
                       st["mask_roi"])
    return dict(dets=dets, labels=labels, valid=dvalid,
                mask_logits=masks), cap


@torch.no_grad()
def check(ref, batch, cfg, anchor_sets, out, cap):
    """The numbers of one request: `out` the program's outputs, `cap`
    the captured modules' outputs, both on the reference's device.

    rpn: per level, the RPN's logits and deltas against the reference's
    (relative, the worst level).  bbox, refinement: the heads' outputs
    on the proposals the program's RPN outputs give (the proposal stage
    replayed: sort, K1's NMS, top-k), and on the 1.5x boxes its bbox head
    gives, against the reference's heads on the reference's features at
    the same rois (the worst row).  dets: each detection against the
    reference's box and score of its source row, the rows chosen by
    replaying the class-wise NMS over the program's own scores.  masks:
    each detection's mask logits against the reference's at the same box
    and head (the worst row)."""
    st = _settings(cfg)
    nums = dict(rpn=0.0, bbox=0.0, refinement=0.0)
    feats_s, boxes_p, boxes_r, scores_p, scores_r, valid_s, rois_s = \
        [], [], [], [], [], [], []
    for s, (key, head) in enumerate(zip(SCALE_KEYS, RPN_HEADS)):
        dhw = tuple(batch[key].shape[2:])
        feats = ref.features(batch[key])
        mine = cap[head]
        for (pc, pr), (rc, rr) in zip(mine, [getattr(ref, head)(f)
                                             for f in feats]):
            nums["rpn"] = max(nums["rpn"], cmp.rel(pc, rc), cmp.rel(pr, rr))
        pboxes, pvalid = ops.proposals([o[0] for o in mine],
                                       [o[1] for o in mine], anchor_sets[s],
                                       dhw, st["rpn"], *st["rpn_codec"])
        rois, rvalid = ops.flat_rois(pboxes, pvalid)
        pc, pr = cap["bbox_head"][s]
        rc, rr = ref.bbox_head(cmp.align(feats, rois, rvalid, st["roi"]))
        nums["bbox"] = max(nums["bbox"], cmp.rowrel(
            cmp.head_rows((pc, pr))[rvalid], cmp.head_rows((rc, rr))[rvalid]))
        feats_s.append(feats)
        rois_s.append(rois[:, 1:])
        scores_p.append(torch.softmax(pc.float(), -1)[None])
        scores_r.append(torch.softmax(rc, -1)[None])
        boxes_p.append(_decode(rois, pr, st, dhw, s)[None])
        boxes_r.append(_decode(rois, rr, st, dhw, s)[None])
        valid_s.append(pvalid)
    dhw = tuple(batch["imgs"].shape[2:])
    rois, rvalid = ops.flat_rois(boxes_p[1][..., 6:12], valid_s[1])
    pp = cap["refinement_head"][0]
    rp = ref.refinement_head(cmp.align(feats_s[0], rois, rvalid, st["roi"]))
    nums["refinement"] = cmp.rowrel(pp[rvalid], rp[rvalid])
    boxes_p[1] = _decode(rois, pp, st, dhw, 0)[None]
    boxes_r[1] = _decode(rois, rp, st, dhw, 0)[None]
    # each candidate row's roi: the proposal (1.0x) or the refined box's
    # input (1.5x)
    cand_rois = torch.cat([rois_s[0], rois[:, 1:]])
    rc = st["rcnn"]
    dets, labels, dvalid, src = ops.classwise_nms(
        torch.cat(boxes_p, 1), torch.cat(scores_p, 1),
        torch.cat(valid_s, 1), rc["score_thr"], rc["nms"]["iou_thr"],
        rc["max_per_img"])
    cls = labels[0] + 1
    rows = src[0]
    cols = 6 * cls[:, None] + torch.arange(6, device=cls.device)
    ref_boxes = torch.gather(torch.cat(boxes_r, 1)[0][rows], 1, cols)
    ref_scores = torch.cat(scores_r, 1)[0][rows, cls]
    prog = (out["dets"][0].float(), out["labels"][0], out["valid"][0])
    replay = (dets[0], labels[0], dvalid[0])
    nums["dets"], box, score = cmp.det_error(prog, replay, ref_boxes,
                                             ref_scores, cand_rois[rows])
    refined = (src >= boxes_p[0].shape[1]).reshape(-1)
    want = mask_stage(ref, feats_s[0], out["dets"].float(), out["valid"],
                      refined, st["mask_roi"])
    rows = out["valid"].reshape(-1)
    nums["masks"] = cmp.rowrel(out["mask_logits"][rows], want[rows])
    return nums, dict(replay_mismatch=cmp.replay_mismatch(prog, replay),
                      det_box=box, det_score=score, detections=int(rows.sum()))
