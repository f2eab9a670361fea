"""6-DoF anchor lattice generation (numpy).

A copy of `mrcnn3d/core/anchors.py` (reference
mmdet/core/anchor/anchor_generator_3d.py:6-92) for the anchor heads the
port runs.  Anchors are flattened in (z, y, x, base) order, which is the
order of an RPN output permuted to (B, d, h, w, A) and reshaped.
"""
from __future__ import annotations

import numpy as np


class AnchorGenerator3D:
    """Reference-parity anchor generator."""

    def __init__(self, base_size, scales, depth_scales, ratios,
                 anchor_depth_base, ctr=None):
        self.base_size = base_size
        self.anchor_depth_base = anchor_depth_base
        self.scales = np.asarray(scales, np.float32)
        self.depth_scales = np.asarray(depth_scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.ctr = ctr
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_base_anchors(self):
        return self.base_anchors.shape[0]

    def gen_base_anchors(self):
        w = self.base_size
        h = self.base_size
        z = self.anchor_depth_base
        if self.ctr is None:
            x_ctr = 0.5 * (w - 1)
            y_ctr = 0.5 * (h - 1)
            z_ctr = 0.5 * (z - 1)
        else:
            x_ctr, y_ctr, z_ctr = self.ctr

        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        z_ratios = h_ratios  # z-ratio tied to h-ratio (reference :35)
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        zs = (z * z_ratios[:, None] * self.depth_scales[None, :]).reshape(-1)

        base = np.stack(
            [
                x_ctr - 0.5 * (ws - 1),
                y_ctr - 0.5 * (hs - 1),
                x_ctr + 0.5 * (ws - 1),
                y_ctr + 0.5 * (hs - 1),
                z_ctr - 0.5 * (zs - 1),
                z_ctr + 0.5 * (zs - 1),
            ],
            axis=-1,
        )
        # torch .round() rounds half-to-even; numpy matches.
        return np.round(base).astype(np.float32)

    def grid_anchors(self, featmap_size, stride=16, depth_stride=2):
        """featmap_size = (z, h, w); returns (z*h*w*A, 6) float32."""
        feat_z, feat_h, feat_w = featmap_size
        shift_x = np.arange(0, feat_w, dtype=np.float32) * stride
        shift_y = np.arange(0, feat_h, dtype=np.float32) * stride
        shift_z = np.arange(0, feat_z, dtype=np.float32) * depth_stride
        szz, syy, sxx = np.meshgrid(shift_z, shift_y, shift_x, indexing="ij")
        sxx, syy, szz = sxx.ravel(), syy.ravel(), szz.ravel()
        shifts = np.stack([sxx, syy, sxx, syy, szz, szz], axis=-1)
        all_anchors = self.base_anchors[None, :, :] + shifts[:, None, :]
        return np.ascontiguousarray(all_anchors.reshape(-1, 6))

    def valid_flags(self, featmap_size, valid_size):
        """Mask anchors whose cell lies in the padded region (ref :76-99)."""
        feat_z, feat_h, feat_w = featmap_size
        valid_d, valid_h, valid_w = valid_size
        vx = np.zeros(feat_w, bool)
        vy = np.zeros(feat_h, bool)
        vz = np.zeros(feat_z, bool)
        vx[:valid_w] = True
        vy[:valid_h] = True
        vz[:valid_d] = True
        vzz, vyy, vxx = np.meshgrid(vz, vy, vx, indexing="ij")
        valid = (vxx & vyy & vzz).ravel()
        return np.repeat(valid, self.num_base_anchors)


def anchor_inside_flags(anchors, valid_flags, img_shape, allowed_border=0):
    """Inside-volume filter (reference anchor_target.py:203-228).

    img_shape = (H, W, C, D) reference layout.
    """
    img_h, img_w, img_d = img_shape[0], img_shape[1], img_shape[3]
    if allowed_border >= 0:
        return (
            valid_flags
            & (anchors[:, 0] >= -allowed_border)
            & (anchors[:, 1] >= -allowed_border)
            & (anchors[:, 4] >= -allowed_border)
            & (anchors[:, 2] < img_w + allowed_border)
            & (anchors[:, 3] < img_h + allowed_border)
            & (anchors[:, 5] < img_d + allowed_border)
        )
    return valid_flags
