"""Where a trained detector's masks sit against their gt: the placement
diagnostic of the mask-quality oracle, which `learning_bench` records
from pass 1 of the protocol.

For each gt, the predicted mask of best voxel IoU (the one
`CocoEval3D.best_overlaps` scores) and:

  * its voxel count over the gt's (`vol_ratio`);
  * its centroid minus the gt's, in voxels along z, y and x (`dz`,
    `dy`, `dx`);
  * its extent (last minus first set voxel, plus 1) over the gt's along
    z, y and x (`ez`, `ey`, `ex`);
  * the IoU of its detection box with the gt box (`box_iou`, the
    evaluator's +1-extent rule), and the share of its box's voxels the
    mask sets (`fill`; `gt_fill` the gt's share of its own box).

A consistent bias (masks too small or too large, or shifted along one
axis) points to placement; no bias but a wide spread points to training.
"""
from __future__ import annotations

import numpy as np


def _centroid_extent(mask):
    """(centroid (z, y, x), extent (z, y, x), voxel count) of a binary
    (D, H, W) volume."""
    idx = np.nonzero(mask)
    if not idx[0].size:
        return np.full(3, np.nan), np.zeros(3), 0
    pts = np.stack(idx, 1).astype(np.float64)
    ext = pts.max(0) - pts.min(0) + 1
    return pts.mean(0), ext, int(idx[0].size)


def placement_rows(ev):
    """One row per gt of `ev` (a segm `CocoEval3D`) against its
    predictions on the same image: the best-IoU prediction's placement,
    as the module says."""
    from ..eval.coco_eval3d import iou3d_xywhzd, voxel_iou

    rows = []
    for key, gts in sorted(ev._gts.items()):
        dts = ev._dts.get(key, [])
        gmasks = [ev._gt_mask(g) for g in gts]
        dmasks = [ev._dt_mask(d) for d in dts]
        ious = voxel_iou(dmasks, gmasks)
        box_ious = iou3d_xywhzd([d["bbox"] for d in dts],
                                [g["bbox"] for g in gts])
        for j, (g, gm) in enumerate(zip(gts, gmasks)):
            gc, ge, gn = _centroid_extent(gm)
            gb = g["bbox"]
            row = dict(image_id=key[0], g_index=j, gt_voxels=gn,
                       gt_fill=gn / float(gb[2] * gb[3] * gb[5]))
            if not dts:
                rows.append(dict(row, iou=0.0))
                continue
            i = int(np.argmax(ious[:, j]))
            dc, de, dn = _centroid_extent(dmasks[i])
            db = dts[i]["bbox"]
            off = dc - gc
            rows.append(dict(
                row, iou=float(ious[i, j]), box_iou=float(box_ious[i, j]),
                score=float(dts[i]["score"]), dt_voxels=dn,
                vol_ratio=dn / gn if gn else float("nan"),
                dz=float(off[0]), dy=float(off[1]), dx=float(off[2]),
                ez=float(de[0] / ge[0]), ey=float(de[1] / ge[1]),
                ex=float(de[2] / ge[2]),
                fill=dn / float(db[2] * db[3] * db[5])))
    return rows


def summarize(rows):
    """Means, medians and spreads of the rows' placement measures."""
    out = dict(n_gt=len(rows))
    for k in ("iou", "box_iou", "vol_ratio", "dz", "dy", "dx", "ez", "ey",
              "ex", "fill", "gt_fill"):
        v = np.array([r[k] for r in rows if k in r], np.float64)
        v = v[np.isfinite(v)]
        if v.size:
            out[k] = dict(mean=float(v.mean()), median=float(np.median(v)),
                          std=float(v.std()))
    v = np.array([r["vol_ratio"] for r in rows if r.get("vol_ratio")])
    if v.size:
        out["vol_ratio_geomean"] = float(np.exp(np.log(v).mean()))
    return out
