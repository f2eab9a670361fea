"""Host-side volume transforms (numpy), the port's copy of
`mrcnn3d/data/transforms.py` (`pad_gt` comes with the data pipeline).

Reference pipeline (mmdet/datasets/transforms.py + coco_3d*.py): per-slice
grayscale->RGB repeat, mmcv imnormalize (RGB mean/std), pad to
size_divisor.  Here the whole volume is normalised in one vectorised
pass and emitted channel-last (D, H, W, 3), the layout `tiled_inference`
takes.
"""
from __future__ import annotations

import numpy as np


def normalize_volume(vol_hwd, mean, std, to_rgb=True):
    """(H, W, D) grayscale -> (D, H, W, 3) float32 normalised.

    Matches reference per-slice ImageTransform (transforms.py:13-51):
    grayscale repeated to 3 channels then (x - mean) / std per channel.
    """
    vol = np.asarray(vol_hwd, np.float32)
    dhw = np.transpose(vol, (2, 0, 1))  # (D, H, W)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = (dhw[..., None] - mean) / std
    return np.ascontiguousarray(out, np.float32)


def pad_to_divisor(vol_dhwc, divisor=32, depth_divisor=None):
    """Zero-pad H/W (and optionally D) up to a multiple of `divisor`.
    Returns (padded, (D, H, W) before padding).

    Reference pads each slice to size_divisor=32 (transforms.py:40-44).
    """
    d, h, w, c = vol_dhwc.shape
    ph = (-h) % divisor
    pw = (-w) % divisor
    pd = (-d) % depth_divisor if depth_divisor else 0
    if ph == 0 and pw == 0 and pd == 0:
        return vol_dhwc, (d, h, w)
    out = np.pad(vol_dhwc, ((0, pd), (0, ph), (0, pw), (0, 0)))
    return out, (d, h, w)
