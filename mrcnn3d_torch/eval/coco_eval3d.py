"""3-D COCO evaluation (numpy, self-contained): the port's copy of
`mrcnn3d/eval/coco_eval3d.py`.

Implements the reference's evaluation protocol
(pycocotools_local/cocoeval.py fork) on 6-DoF boxes:
  * iouThrs = 0.05 : 0.05 : 0.95 — 19 thresholds (cocoeval.py:870)
  * maxDets = [1, 10, 10000] (cocoeval.py:93)
  * areaRng 'all/small/medium/large' with the stock pixel-area bounds
    applied to the 3-D `area` field (w*h*depth)
  * bbox IoU on xywhzd with +1-extent intersection and w*h*d volumes
    (cocoeval.py:252-274)
  * segm voxel IoU on full-volume masks (cocoeval.py:306-354)
  * 29-stat summary: mAP, AP@each of 0.05..0.95, AP s/m/l,
    AR@1/10/10000 (+ s/m/l) (cocoeval.py:790-846)
  * per-gt best-overlap bookkeeping (cocoeval.py:276-295)

This is a clean-room implementation of the (public, well-known) COCO
matching algorithm with the fork's parameters — not a copy of the fork.
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from .masks import paste_mask_3d

IOU_THRS = np.linspace(0.05, 0.95, 19)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = [1, 10, 10000]
AREA_RNG = [
    [0, 1e10],
    [0, 32**2],
    [32**2, 96**2],
    [96**2, 1e10],
]
AREA_LBL = ["all", "small", "medium", "large"]


def iou3d_xywhzd(dts, gts):
    """(D, 6) x (G, 6) xywhzd -> (D, G) IoU (reference cocoeval.py:252-274)."""
    dts = np.asarray(dts, np.float64).reshape(-1, 6)
    gts = np.asarray(gts, np.float64).reshape(-1, 6)
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx2 = dts[:, 0] + dts[:, 2] - 1
    dy2 = dts[:, 1] + dts[:, 3] - 1
    dz2 = dts[:, 4] + dts[:, 5] - 1
    gx2 = gts[:, 0] + gts[:, 2] - 1
    gy2 = gts[:, 1] + gts[:, 3] - 1
    gz2 = gts[:, 4] + gts[:, 5] - 1
    xa = np.maximum(dts[:, None, 0], gts[None, :, 0])
    ya = np.maximum(dts[:, None, 1], gts[None, :, 1])
    za = np.maximum(dts[:, None, 4], gts[None, :, 4])
    xb = np.minimum(dx2[:, None], gx2[None, :])
    yb = np.minimum(dy2[:, None], gy2[None, :])
    zb = np.minimum(dz2[:, None], gz2[None, :])
    inter = (
        np.clip(xb - xa + 1, 0, None)
        * np.clip(yb - ya + 1, 0, None)
        * np.clip(zb - za + 1, 0, None)
    )
    dvol = dts[:, 2] * dts[:, 3] * dts[:, 5]
    gvol = gts[:, 2] * gts[:, 3] * gts[:, 5]
    return inter / (dvol[:, None] + gvol[None, :] - inter)


def voxel_iou(dt_masks, gt_masks):
    """Lists of binary volumes -> (D, G) voxel IoU.

    Cost is proportional to the masks' voxel counts, not the volume size:
    each mask is reduced to its sorted nonzero linear indices and pairwise
    intersections use `np.intersect1d` (microbleed masks are tiny relative
    to a 512^2 x D volume, so this is orders of magnitude cheaper than
    whole-volume logical ops).
    """
    d, g = len(dt_masks), len(gt_masks)
    ious = np.zeros((d, g))
    if d == 0 or g == 0:
        return ious
    d_idx = [np.flatnonzero(np.asarray(m).reshape(-1)) for m in dt_masks]
    g_idx = [np.flatnonzero(np.asarray(m).reshape(-1)) for m in gt_masks]
    for i, di in enumerate(d_idx):
        for j, gj in enumerate(g_idx):
            inter = np.intersect1d(di, gj, assume_unique=True).size
            union = di.size + gj.size - inter
            ious[i, j] = inter / union if union > 0 else 0.0
    return ious


class CocoEval3D:
    """COCO-protocol evaluation over 6-DoF detections.

    gt: COCO dict (images/annotations/categories) or path to json.
    dt: list of {image_id, category_id, bbox [x,y,w,h,z,d], score,
        segmentation (optional (D,H,W) binary volume)}.
    """

    def __init__(self, gt, dt, iou_type="bbox"):
        if isinstance(gt, str):
            with open(gt) as f:
                gt = json.load(f)
        self.gt = gt
        self.dt = dt
        self.iou_type = iou_type
        self.img_ids = [i["id"] for i in gt["images"]]
        self.cat_ids = [c["id"] for c in gt.get("categories", [{"id": 1}])]
        self._gts = defaultdict(list)
        for ann in gt["annotations"]:
            a = dict(ann)
            if "area" not in a:
                b = a["bbox"]
                a["area"] = b[2] * b[3] * b[5]
            self._gts[(a["image_id"], a["category_id"])].append(a)
        self._dts = defaultdict(list)
        for i, d in enumerate(dt):
            d = dict(d)
            b = d["bbox"]
            d.setdefault("area", b[2] * b[3] * b[5])
            d.setdefault("id", i + 1)
            self._dts[(d["image_id"], d["category_id"])].append(d)
        # pre-sort dts by score (desc, stable) and cap at the largest
        # maxDets — greedy matching is sequential in score order, so every
        # smaller maxDet is a prefix slice of this
        for key in self._dts:
            self._dts[key] = sorted(
                self._dts[key], key=lambda d: -d["score"]
            )[: MAX_DETS[-1]]
        self.best_overlaps = {}
        self.parcellation_confusion = {}  # (gt_region, pred_region) -> n
        self._mask_cache = {}  # .npy path -> loaded volume (per-image)
        self.eval = None
        self.stats = None

    # -- mask materialisation -------------------------------------------

    @staticmethod
    def _dt_mask(d):
        seg = d["segmentation"]
        if isinstance(seg, dict):
            # compact box-mask carrier from the tiled driver: paste into
            # the full frame lazily (reference keeps patch masks +
            # segm_pos_* placement the same way, coco_utils.py:416-477)
            return paste_mask_3d(seg["box"], seg["mask"], seg["shape"])
        return np.asarray(seg)

    def _gt_mask(self, g):
        """gt `segmentation` is either an in-memory volume or a reference-
        style .npy path + segmentation_label (lazy load, reference
        cocoeval.py:101-119 _toMask). Loaded volumes are cached per image
        so the N gts of one volume trigger one np.load, not N."""
        seg = g["segmentation"]
        if isinstance(seg, str):
            vol = self._mask_cache.get(seg)
            if vol is None:
                vol = np.load(seg, allow_pickle=True)
                self._mask_cache[seg] = vol
            label = g.get("segmentation_label", 1)
            mask = (vol == label).astype(np.uint8)
            # disk layout is (H, W, D); evaluation uses (D, H, W)
            return np.transpose(mask, (2, 0, 1))
        return np.asarray(seg)

    # -- matching --------------------------------------------------------

    def _compute_ious(self, img_id, cat_id):
        """IoU matrix for one (image, category) — computed exactly once.

        Also does the per-gt best-overlap and parcellation-confusion
        bookkeeping (fork cocoeval.py:276-304), which belongs here: it is
        independent of the (area, maxDet) sweep.
        """
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if self.iou_type == "segm":
            ious = voxel_iou(
                [self._dt_mask(d) for d in dts],
                [self._gt_mask(g) for g in gts],
            )
        else:
            ious = iou3d_xywhzd(
                [d["bbox"] for d in dts], [g["bbox"] for g in gts]
            )

        for j, g in enumerate(gts):
            key = f"{img_id}_{cat_id}_{j}"
            self.best_overlaps[key] = dict(
                image_id=img_id,
                cat_id=cat_id,
                g_index=j,
                iou=float(ious[:, j].max()) if len(dts) else 0.0,
                width=g["bbox"][2],
                height=g["bbox"][3],
                depth=g["bbox"][5],
            )
            # parcellation confusion: most-overlapping prediction's
            # brain-region vs gt (fork cocoeval.py:297-304)
            if len(dts) and "brain_region" in g:
                best_d = dts[int(np.argmax(ious[:, j]))]
                if "parcellation" in best_d:
                    pair = (
                        int(g["brain_region"]),
                        int(best_d["parcellation"]),
                    )
                    self.parcellation_confusion[pair] = (
                        self.parcellation_confusion.get(pair, 0) + 1
                    )
        return ious

    def _evaluate_img(self, img_id, cat_id, area_rng, ious):
        """Greedy matching at every IoU threshold for one (img, cat, area).

        Matches at the LARGEST maxDet; smaller maxDets are prefix slices
        taken in `evaluate` (greedy matching is sequential in score order,
        so truncation is exact — same trick as pycocotools).
        """
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]  # pre-sorted by score, capped
        if len(gts) == 0 and len(dts) == 0:
            return None

        gt_ignore = np.array(
            [
                g.get("iscrowd", 0)
                or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            bool,
        )
        # sort gts: unignored first (COCO protocol); reindex IoU columns
        order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in order]
        gt_ignore = gt_ignore[order]
        if ious.size:
            ious = ious[:, order]

        t = len(IOU_THRS)
        dt_matches = np.zeros((t, len(dts)), np.int64)
        gt_matches = np.zeros((t, len(gts)), np.int64)
        dt_ignore = np.zeros((t, len(dts)), bool)
        for ti, thr in enumerate(IOU_THRS):
            taken = np.zeros(len(gts), bool)
            for di in range(len(dts)):
                best, best_j = min(thr, 1 - 1e-10), -1
                for j in range(len(gts)):
                    if taken[j] and not gt_ignore[j]:
                        continue
                    # stop at ignored gts once a real match exists
                    if best_j > -1 and not gt_ignore[best_j] and gt_ignore[j]:
                        break
                    if ious[di, j] < best:
                        continue
                    best = ious[di, j]
                    best_j = j
                if best_j == -1:
                    continue
                taken[best_j] = True
                dt_matches[ti, di] = gts[best_j]["id"]
                gt_matches[ti, best_j] = dts[di]["id"]
                dt_ignore[ti, di] = gt_ignore[best_j]
        # unmatched dts outside the area range are ignored
        dt_out = np.array(
            [
                d["area"] < area_rng[0] or d["area"] > area_rng[1]
                for d in dts
            ],
            bool,
        )
        dt_ignore = dt_ignore | ((dt_matches == 0) & dt_out[None, :])
        return dict(
            dt_scores=np.array([d["score"] for d in dts]),
            dt_matches=dt_matches,
            dt_ignore=dt_ignore,
            gt_ignore=gt_ignore,
            num_gt=int((~gt_ignore).sum()),
        )

    # -- accumulate ------------------------------------------------------

    def evaluate(self):
        """Compute once, slice many (fork cocoeval.py:306-354,658):

        1. IoUs once per (img, cat) — for segm this is the expensive part
           (gt-mask load + voxel IoU), so it must not repeat per cell.
        2. Greedy matching once per (img, cat, area) at the largest maxDet.
        3. Every (thr x area x maxDet) cell derives from cached matches by
           prefix-slicing the per-image dt columns.
        """
        t = len(IOU_THRS)
        r = len(REC_THRS)
        k = len(self.cat_ids)
        a = len(AREA_RNG)
        m = len(MAX_DETS)
        precision = -np.ones((t, r, k, a, m))
        recall = -np.ones((t, k, a, m))

        # 1) IoUs once per (img, cat); mask cache lives for one image
        ious_cache = {}
        for img_id in self.img_ids:
            for cat_id in self.cat_ids:
                ious_cache[(img_id, cat_id)] = self._compute_ious(
                    img_id, cat_id
                )
            self._mask_cache.clear()

        for ki, cat_id in enumerate(self.cat_ids):
            for ai, area_rng in enumerate(AREA_RNG):
                # 2) matching once per (img, cat, area) at max maxDet
                results = [
                    self._evaluate_img(
                        img_id, cat_id, area_rng,
                        ious_cache[(img_id, cat_id)],
                    )
                    for img_id in self.img_ids
                ]
                results = [x for x in results if x is not None]
                if not results:
                    continue
                num_gt = sum(x["num_gt"] for x in results)
                if num_gt == 0:
                    continue
                # 3) per-maxDet cells by prefix-slicing each image's dts
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [x["dt_scores"][:max_det] for x in results]
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    matches = np.concatenate(
                        [x["dt_matches"][:, :max_det] for x in results],
                        axis=1,
                    )[:, order]
                    ignore = np.concatenate(
                        [x["dt_ignore"][:, :max_det] for x in results],
                        axis=1,
                    )[:, order]
                    tps = (matches > 0) & ~ignore
                    fps = (matches == 0) & ~ignore
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(t):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope
                        q = np.zeros(r)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = dict(precision=precision, recall=recall)
        return self.eval

    # -- summarize -------------------------------------------------------

    def _summary(self, ap, iou_thr=None, area="all", max_det=10000):
        ai = AREA_LBL.index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                ti = np.where(np.abs(iou_thr - IOU_THRS) < 0.01)[0]
                s = s[ti]
            s = s[..., ai, mi]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                ti = np.where(np.abs(iou_thr - IOU_THRS) < 0.01)[0]
                s = s[ti]
            s = s[..., ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self):
        """29-stat vector in the fork's order (cocoeval.py:790-846)."""
        if self.eval is None:
            self.evaluate()
        stats = np.zeros(29)
        stats[0] = self._summary(1)
        for i, thr in enumerate(IOU_THRS):
            stats[1 + i] = self._summary(1, iou_thr=float(thr))
        stats[20] = self._summary(1, area="small")
        stats[21] = self._summary(1, area="medium")
        stats[22] = self._summary(1, area="large")
        stats[23] = self._summary(0, max_det=1)
        stats[24] = self._summary(0, max_det=10)
        stats[25] = self._summary(0, max_det=10000)
        stats[26] = self._summary(0, area="small")
        stats[27] = self._summary(0, area="medium")
        stats[28] = self._summary(0, area="large")
        self.stats = stats
        return stats

    def named_stats(self, prefix="bbox"):
        """Metric-name dict matching eval_hooks.py:238-305 log keys."""
        if self.stats is None:
            self.summarize()
        s = self.stats
        out = {f"{prefix}_mAP": s[0]}
        for i, thr in enumerate(IOU_THRS):
            out[f"{prefix}_mAP_{thr:.2f}".rstrip("0").rstrip(".")] = s[1 + i]
        out.update(
            {
                f"{prefix}_mAP_s": s[20],
                f"{prefix}_mAP_m": s[21],
                f"{prefix}_mAP_l": s[22],
                f"{prefix}_AR_1": s[23],
                f"{prefix}_AR_10": s[24],
                f"{prefix}_AR_100": s[25],
                f"{prefix}_AR_s": s[26],
                f"{prefix}_AR_m": s[27],
                f"{prefix}_AR_l": s[28],
            }
        )
        return out
