"""Single-volume inference API (reference mmdet/apis/inference.py).

Counterpart of `mrcnn3d/apis/inference.py`: `inference_detector_3d`
(single-scale detectors) and `inference_detector_3d_2scales` take raw
(H, W, D) volumes (.npy paths or arrays), the latter with their 1.5x
twins, normalise and pad them, and yield per-volume detection results;
`show_result_3d` renders per-slice overlays (matplotlib, imported when
called: without it the call raises).
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ..data.transforms import normalize_volume, pad_to_divisor
from ..detectors.pipeline import bbox2result3d

DEFAULT_NORM = dict(
    mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True
)


def _prep(vol, norm_cfg, size_divisor=32):
    if isinstance(vol, str):
        vol = np.load(vol, allow_pickle=True)
    img = normalize_volume(vol, norm_cfg["mean"], norm_cfg["std"])
    img, ori = pad_to_divisor(img, size_divisor)
    return img, ori


def _to_model(img, det):
    """(D, H, W, 3) numpy -> (1, 3, D, H, W) in the model's dtype on its
    device."""
    dtype = next(det.model.parameters()).dtype
    x = torch.from_numpy(img).to(det.device)
    return x.permute(3, 0, 1, 2)[None].to(dtype)


def inference_detector_3d(det, volume_paths, norm_cfg=None):
    """Generator over volumes (`mrcnn3d/apis/inference.py:30-38`):
    per-class (n, 7) detection arrays for each.  det: an `entry.Flagship`
    of a single-scale type."""
    norm_cfg = norm_cfg or det.cfg.data["test"].get("img_norm_cfg",
                                                    DEFAULT_NORM)
    for path in volume_paths:
        img, _ = _prep(path, norm_cfg)
        dets, labels, valid, _ = det.run(_to_model(img, det))
        yield bbox2result3d(dets[0], labels[0], valid[0],
                            det.model.num_classes)


def inference_detector_3d_2scales(det, volume_paths, volume_paths_2,
                                  norm_cfg=None):
    """Generator over paired 1.0x/1.5x volumes (reference :132-184):
    per-class (n, 7) detection arrays for each pair.  det: an
    `entry.Flagship`."""
    norm_cfg = norm_cfg or det.cfg.data["test"].get("img_norm_cfg",
                                                    DEFAULT_NORM)
    for p1, p2 in zip(volume_paths, volume_paths_2):
        img, _ = _prep(p1, norm_cfg)
        img2, _ = _prep(p2, norm_cfg)
        dets, labels, valid, _ = det.run(_to_model(img, det),
                                         _to_model(img2, det))
        yield bbox2result3d(dets[0], labels[0], valid[0],
                            det.model.num_classes)


def show_result_3d(volume, per_class_dets, out_dir, score_thr=0.2,
                   gt_boxes=None, prefix="slice"):
    """Per-slice PNG rendering of detections (reference :222-280).

    volume: (H, W, D) raw array or path; detections drawn on every slice
    their z-extent covers; optional gt boxes drawn dashed-green.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "show_result_3d renders with matplotlib, which this Python "
            "environment lacks") from e

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    if isinstance(volume, str):
        volume = np.load(volume, allow_pickle=True)
    h, w, d = volume.shape
    dets = np.concatenate(
        [np.asarray(x).reshape(-1, 7) for x in per_class_dets], axis=0
    )
    dets = dets[dets[:, 6] >= score_thr]
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for z in range(d):
        on_slice = dets[(dets[:, 4] <= z) & (z <= dets[:, 5])]
        gts = None
        if gt_boxes is not None:
            g = np.asarray(gt_boxes).reshape(-1, 6)
            gts = g[(g[:, 4] <= z) & (z <= g[:, 5])]
        if len(on_slice) == 0 and (gts is None or len(gts) == 0):
            continue
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(volume[:, :, z], cmap="gray")
        for b in on_slice:
            ax.add_patch(
                patches.Rectangle(
                    (b[0], b[1]),
                    b[2] - b[0],
                    b[3] - b[1],
                    fill=False,
                    edgecolor="red",
                    linewidth=1.2,
                )
            )
            ax.text(b[0], b[1] - 2, f"{b[6]:.2f}", color="red", fontsize=7)
        if gts is not None:
            for g in gts:
                ax.add_patch(
                    patches.Rectangle(
                        (g[0], g[1]),
                        g[2] - g[0],
                        g[3] - g[1],
                        fill=False,
                        edgecolor="lime",
                        linestyle="--",
                        linewidth=1.0,
                    )
                )
        ax.set_axis_off()
        path = osp.join(out_dir, f"{prefix}_{z:03d}.png")
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        written.append(path)
    return written
