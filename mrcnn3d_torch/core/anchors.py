"""6-DoF anchor lattice generation (numpy).

A copy of `mrcnn3d/core/anchors.py` (reference
mmdet/core/anchor/anchor_generator_3d.py:6-92) for the anchor heads the
port runs, SSD's per-level generators (`ssd_anchor_generators`) among
them.  Anchors are flattened in (z, y, x, base) order, which is the
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


def ssd_anchor_generators(anchor_cfg):
    """Per-level SSD anchor generators (`mrcnn3d/core/anchors.py:114-170`;
    reference ssd_head.py:49-88).

    Per level k: base_size = min_sizes[k], scales [1, sqrt(max/min)],
    ratios [1] + [1/r, r for r in the level's ratios], the centre at
    ((stride - 1) / 2, (stride - 1) / 2, 0); the reference's base-anchor
    selection (torch's scale-outer rows [0, R, 1, ..., R-1]) is, in this
    generator's ratio-outer order, rows [0, 1, 2, 4, ..., 2(R-1)], so each
    level has 2 * len(ratios_k) + 2 anchors.  Depth is degenerate (the
    2-D family): z extents [0, 0].
    """
    input_size = int(anchor_cfg.get("input_size", 300))
    strides = anchor_cfg["anchor_strides"]
    ratios_per_level = anchor_cfg["anchor_ratios"]
    lo, hi = anchor_cfg["basesize_ratio_range"]
    min_ratio, max_ratio = int(lo * 100), int(hi * 100)
    step = int(np.floor(max_ratio - min_ratio) / (len(strides) - 2))
    min_sizes, max_sizes = [], []
    for r in range(min_ratio, max_ratio + 1, step):
        min_sizes.append(int(input_size * r / 100))
        max_sizes.append(int(input_size * (r + step) / 100))
    # first-level inserts (reference ssd_head.py:58-71)
    first = {
        (300, 0.15): (7, 15), (300, 0.2): (10, 20),
        (512, 0.1): (4, 10), (512, 0.15): (7, 15),
    }.get((input_size, lo))
    if first is not None:
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))
    gens = []
    for k, stride in enumerate(strides):
        ratios = [1.0]
        for r in ratios_per_level[k]:
            ratios += [1.0 / r, r]
        scales = [1.0, np.sqrt(max_sizes[k] / min_sizes[k])]
        gen = AnchorGenerator3D(
            base_size=min_sizes[k],
            scales=scales,
            depth_scales=[1.0] * len(scales),
            ratios=ratios,
            anchor_depth_base=1,
            ctr=((stride - 1) / 2.0, (stride - 1) / 2.0, 0.0),
        )
        indices = [0, 1] + [2 * i for i in range(1, len(ratios))]
        base = gen.base_anchors[indices]
        base[:, 4:6] = 0.0
        gen.base_anchors = base
        gens.append(gen)
    return gens


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
