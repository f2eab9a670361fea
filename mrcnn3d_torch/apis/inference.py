"""Single-volume inference API (reference mmdet/apis/inference.py).

Counterpart of `mrcnn3d/apis/inference.py`: `inference_detector_3d_2scales`
takes raw (H, W, D) volumes (.npy paths or arrays) and their 1.5x twins,
normalises and pads them, and yields per-volume detection results.  The
single-scale `inference_detector_3d` comes with the single-scale
detectors, `show_result_3d` with the command-line tools.
"""
from __future__ import annotations

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
