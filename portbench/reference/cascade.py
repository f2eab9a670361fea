"""Plain reference of the Hybrid Task Cascade (HybridTaskCascade3D:
reference htc.py simple_test, lifted to 6-DoF volumes): the backbone and
FPN, the RPN and its proposals, the fused semantic head, three
class-agnostic bbox stages (each on the FPN align plus the semantic
align pooled to the bbox grid, each decoding from the previous stage's
boxes, their softmax scores averaged), the class-wise NMS on the last
boxes, and the three mask heads with information flow on the
detections (the mean sigmoid probability, as a logit).

`infer` runs it whole (the control, in the program's place); `check`
follows the program's run as `two_stage.check` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import compare as cmp
from . import ops
from .nn import BBoxHead, FPN3D, MaskHead, ResNet3D, RPNHead, SemanticHead

STAGES = 3


class Detector(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        m = cfg["model"]
        c = m["neck"]["out_channels"]
        self.backbone = ResNet3D(m["backbone"].get("depth", 50),
                                 m["backbone"].get("base_width", 16))
        self.neck = FPN3D(self.backbone.out_channels, c,
                          m["neck"]["num_outs"])
        self.rpn_head = RPNHead(c, len(m["rpn_head"]["anchor_scales"])
                                * len(m["rpn_head"]["anchor_ratios"]))
        layer = m["bbox_roi_extractor"]["roi_layer"]
        feat = c * layer["out_size_depth"] * layer["out_size"] ** 2
        ncls = m["bbox_head"]["num_classes"]
        self.bbox_head = nn.ModuleList(
            [BBoxHead(feat, m["bbox_head"]["fc_out_channels"], ncls,
                      class_agnostic=True) for _ in range(STAGES)])
        self.mask_head = nn.ModuleList(
            [MaskHead(c, ncls, m["mask_head"]["num_convs"], htc=True,
                      with_conv_res=t > 0) for t in range(STAGES)])
        sem = m["semantic_head"]
        # the port builds four convs whatever the config says
        self.semantic_head = SemanticHead(
            c, sem.get("num_ins", m["neck"]["num_outs"]),
            sem.get("fusion_level", 1), 4, sem.get("num_classes", 2),
            ops.resize_trilinear)

    def features(self, x):
        return self.neck(self.backbone(x.float()))

    def featmap_sizes(self, dhw):
        return self.neck.featmap_sizes(self.backbone.featmap_sizes(dhw))


def capture(cfg):
    """The program's modules whose outputs the check reads, each with the
    number of calls a request makes, in the order `check` reads them:
    the RPN head once a level, the semantic head once, each stage's bbox
    head once."""
    return {"rpn_head": cfg["model"]["neck"]["num_outs"],
            "semantic_head": 1,
            **{f"bbox_head.{t}": 1 for t in range(STAGES)}}


def anchors(model, cfg, batch, device):
    dhw = tuple(batch["imgs"].shape[2:])
    return [ops.anchor_set(model.featmap_sizes(dhw), dhw,
                           cfg["model"]["rpn_head"], device)]


def _semantic(sem_feat, rois, valid, cfg, out, out_d):
    """The rois' align on the semantic map (its one level), pooled to
    (out_d, out, out) where the extractor's grid differs."""
    scfg = cfg["model"]["semantic_roi_extractor"]
    layer = scfg["roi_layer"]
    x = ops.roi_align([sem_feat], rois, valid, layer["out_size"],
                      layer["out_size_depth"], scfg["featmap_strides"],
                      scfg["featmap_strides_depth"], layer["sample_num"])
    if (layer["out_size"], layer["out_size_depth"]) != (out, out_d):
        x = F.adaptive_avg_pool3d(x, (out_d, out, out))
    return x


def _fusion(cfg):
    return tuple(cfg["model"].get("semantic_fusion", ("bbox", "mask")))


def stage_feats(feats, sem_feat, rois, valid, cfg):
    roi = cfg["model"]["bbox_roi_extractor"]
    x = cmp.align(feats, rois, valid, roi)
    if "bbox" in _fusion(cfg):
        layer = roi["roi_layer"]
        x = x + _semantic(sem_feat, rois, valid, cfg, layer["out_size"],
                          layer["out_size_depth"])
    return x


def mask_stage(model, feats, sem_feat, dets, valid, cfg):
    """Every valid slot's mean probability over the three mask heads
    (information flow from stage to stage), clipped to [1e-6, 1 - 1e-6],
    as a logit; zeros elsewhere."""
    mcfg = cfg["model"]["mask_roi_extractor"]
    rois, rvalid = ops.flat_rois(dets[..., :6], valid)
    rows = torch.nonzero(rvalid).flatten()
    x = cmp.align(feats, rois[rows], rvalid[rows], mcfg)
    if "mask" in _fusion(cfg):
        layer = mcfg["roi_layer"]
        x = x + _semantic(sem_feat, rois[rows], rvalid[rows], cfg,
                          layer["out_size"], layer["out_size_depth"])
    info_flow = cfg["model"].get("mask_info_flow", True)

    def heads(x):
        last, prob = None, None
        for head in model.mask_head:
            logits, feat = head(x, last)
            if info_flow:
                last = feat
            p = torch.sigmoid(logits.float())
            prob = p if prob is None else prob + p
        p = torch.clamp(prob / len(model.mask_head), 1e-6, 1.0 - 1e-6)
        return torch.log(p) - torch.log1p(-p)

    ncls = model.mask_head[0].conv_logits.out_channels
    out = x.new_zeros((rois.shape[0], ncls)
                      + tuple(2 * n for n in x.shape[2:]))
    if rows.numel():
        out[rows] = cmp.in_chunks(heads, x)
    return out


def _settings(cfg):
    return dict(rpn_codec=cmp.codec(cfg["model"]["rpn_head"]),
                codec=cmp.codec(cfg["model"]["bbox_head"]),
                rpn=cfg["test_cfg"]["rpn"], rcnn=cfg["test_cfg"]["rcnn"])


def _nms(boxes, score_sum, valid, st):
    rc = st["rcnn"]
    scores = (score_sum / STAGES).reshape(1, boxes.shape[1], -1)
    return ops.classwise_nms(boxes, scores, valid, rc["score_thr"],
                             rc["nms"]["iou_thr"], rc["max_per_img"])


def flop_plan(model, cfg, shapes, meta):
    """The multiplying layers of one request on meta tensors: the
    backbone, FPN, RPN and semantic head, each stage's bbox head on
    max_num proposals, the three mask heads (with their information
    flow) on max_per_img detections."""
    m, test = cfg["model"], cfg["test_cfg"]
    c = m["neck"]["out_channels"]
    rows, dets = test["rpn"]["max_num"], test["rcnn"]["max_per_img"]
    bl = m["bbox_roi_extractor"]["roi_layer"]
    ml = m["mask_roi_extractor"]["roi_layer"]
    feats = model.features(meta(1, 3, *shapes["imgs"]))
    for f in feats:
        model.rpn_head(f)
    model.semantic_head(feats)
    for head in model.bbox_head:
        head(meta(rows, c, bl["out_size_depth"], bl["out_size"],
                  bl["out_size"]))
    x, last = meta(dets, c, ml["out_size_depth"], ml["out_size"],
                   ml["out_size"]), None
    for head in model.mask_head:
        _, last = head(x, last)


@torch.no_grad()
def infer(model, batch, cfg, anchor_sets):
    """The whole inference by the reference: (outputs, the outputs of the
    captured modules in the program's layout)."""
    st = _settings(cfg)
    cap = {k: [] for k in capture(cfg)}
    dhw = tuple(batch["imgs"].shape[2:])
    feats = model.features(batch["imgs"])
    outs = [model.rpn_head(f) for f in feats]
    cap["rpn_head"].extend(outs)
    boxes, pvalid = ops.proposals([o[0] for o in outs], [o[1] for o in outs],
                                  anchor_sets[0], dhw, st["rpn"],
                                  *st["rpn_codec"])
    sem = model.semantic_head(feats)
    cap["semantic_head"].append(sem)
    score_sum = None
    for t in range(STAGES):
        rois, rvalid = ops.flat_rois(boxes, pvalid)
        cls, reg = model.bbox_head[t](stage_feats(feats, sem[1], rois,
                                                  rvalid, cfg))
        cap[f"bbox_head.{t}"].append((cls, reg))
        sc = torch.softmax(cls.float(), -1)
        score_sum = sc if score_sum is None else score_sum + sc
        boxes = ops.delta2bbox(rois[:, 1:], reg.float(), *st["codec"],
                               dhw)[None]
    dets, labels, dvalid, _ = _nms(boxes, score_sum, pvalid, st)
    masks = mask_stage(model, feats, sem[1], dets, dvalid, cfg)
    return dict(dets=dets, labels=labels, valid=dvalid,
                mask_logits=masks), cap


@torch.no_grad()
def check(ref, batch, cfg, anchor_sets, out, cap):
    """The numbers of one request, as `two_stage.check` reads them: rpn;
    semantic (the semantic head's logits and embedding, relative); bbox
    (each stage's head on the rois the program's previous stage gives,
    the worst row of the three); dets; masks."""
    st = _settings(cfg)
    dhw = tuple(batch["imgs"].shape[2:])
    feats = ref.features(batch["imgs"])
    mine = cap["rpn_head"]
    nums = dict(rpn=0.0, semantic=0.0, bbox=0.0)
    for (pc, pr), (rc, rr) in zip(mine, [ref.rpn_head(f) for f in feats]):
        nums["rpn"] = max(nums["rpn"], cmp.rel(pc, rc), cmp.rel(pr, rr))
    boxes_p, pvalid = ops.proposals([o[0] for o in mine],
                                    [o[1] for o in mine], anchor_sets[0],
                                    dhw, st["rpn"], *st["rpn_codec"])
    sem = ref.semantic_head(feats)
    for p, r in zip(cap["semantic_head"][0], sem):
        nums["semantic"] = max(nums["semantic"], cmp.rel(p, r))
    sum_p = sum_r = None
    for t in range(STAGES):
        rois, rvalid = ops.flat_rois(boxes_p, pvalid)
        pc, pr = cap[f"bbox_head.{t}"][0]
        rc, rr = ref.bbox_head[t](stage_feats(feats, sem[1], rois, rvalid,
                                              cfg))
        nums["bbox"] = max(nums["bbox"], cmp.rowrel(
            cmp.head_rows((pc, pr))[rvalid], cmp.head_rows((rc, rr))[rvalid]))
        sp, sr = torch.softmax(pc.float(), -1), torch.softmax(rc, -1)
        sum_p = sp if sum_p is None else sum_p + sp
        sum_r = sr if sum_r is None else sum_r + sr
        boxes_p = ops.delta2bbox(rois[:, 1:], pr.float(), *st["codec"],
                                 dhw)[None]
        boxes_r = ops.delta2bbox(rois[:, 1:], rr, *st["codec"], dhw)
    dets, labels, dvalid, src = _nms(boxes_p, sum_p, pvalid, st)
    rows = src[0]
    ref_boxes = boxes_r[rows]
    ref_scores = (sum_r / STAGES)[rows, labels[0] + 1]
    prog = (out["dets"][0].float(), out["labels"][0], out["valid"][0])
    replay = (dets[0], labels[0], dvalid[0])
    nums["dets"], box, score = cmp.det_error(prog, replay, ref_boxes,
                                             ref_scores, rois[rows, 1:])
    want = mask_stage(ref, feats, sem[1], out["dets"].float(), out["valid"],
                      cfg)
    valid = out["valid"].reshape(-1)
    nums["masks"] = cmp.rowrel(out["mask_logits"][valid], want[valid])
    return nums, dict(replay_mismatch=cmp.replay_mismatch(prog, replay),
                      det_box=box, det_score=score, detections=int(valid.sum()))
