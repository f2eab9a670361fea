"""RandomCrop3D training augmentation (numpy): the port's copy of
`mrcnn3d/data/random_crop3d.py`.  Every draw comes from the explicit
`np.random.RandomState` it is given, so one seed crops as the JAX
package does.

Semantic port of reference mmdet/datasets/extra_aug.py:146-211:
  * fixed crop of (H/4, W/4, full depth)
  * corner rejection-sampled so at least one gt box is fully inside
  * min-IoU mode sampled from (1, *min_ious, 0) against the patch
  * surviving boxes must be strictly inside the patch; boxes and masks
    are shifted/cropped to patch coordinates
"""
from __future__ import annotations

import numpy as np


def _bbox_overlaps_np(a, b):
    """numpy twin of the 3-D IoU (reference evaluation/bbox_overlaps.py:51-98)."""
    xa = np.maximum(a[:, None, 0], b[None, :, 0])
    ya = np.maximum(a[:, None, 1], b[None, :, 1])
    xb = np.minimum(a[:, None, 2], b[None, :, 2])
    yb = np.minimum(a[:, None, 3], b[None, :, 3])
    za = np.maximum(a[:, None, 4], b[None, :, 4])
    zb = np.minimum(a[:, None, 5], b[None, :, 5])
    inter = (
        np.clip(xb - xa + 1, 0, None)
        * np.clip(yb - ya + 1, 0, None)
        * np.clip(zb - za + 1, 0, None)
    )
    va = (
        (a[:, 2] - a[:, 0] + 1)
        * (a[:, 3] - a[:, 1] + 1)
        * (a[:, 5] - a[:, 4] + 1)
    )
    vb = (
        (b[:, 2] - b[:, 0] + 1)
        * (b[:, 3] - b[:, 1] + 1)
        * (b[:, 5] - b[:, 4] + 1)
    )
    return inter / (va[:, None] + vb[None, :] - inter)


class RandomCrop3D:
    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3,
                 rng=None):
        self.sample_mode = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.rng = rng or np.random.RandomState()

    def _valid_corner(self, img_dim, patch_dim, lo, hi):
        # rejection-sample until >= 1 box fully inside along this axis.
        # Feasibility precheck (distribution-preserving): a corner c
        # works for box i iff c <= lo_i and c > hi_i - patch_dim, with
        # c in [0, ub).  If no box admits any integer corner, the
        # rejection loop can never succeed — without this, impossible
        # data burns 10k draws per axis per outer attempt (~160 s per
        # sample) before the bounded giveup.
        ub = max(img_dim - patch_dim, 1)
        c_min = np.maximum(np.floor(hi - patch_dim) + 1, 0)
        c_max = np.minimum(np.floor(lo), ub - 1)
        if not (c_min <= c_max).any():
            return None
        for _ in range(10000):
            corner = self.rng.randint(ub)
            mask = (lo >= corner) & (hi < corner + patch_dim)
            if mask.any():
                return corner
        return 0

    def __call__(self, img_hwd, boxes, labels, masks_hwd=None):
        """img (H, W, D); boxes (N, 6) [x1,y1,x2,y2,z1,z2]; masks list of
        (H, W, D).  Returns cropped img, shifted boxes, labels, masks."""
        h, w, d = img_hwd.shape
        new_w, new_h, new_d = int(w / 4), int(h / 4), d
        boxes = np.asarray(boxes, np.float32)

        # the reference loops unbounded (extra_aug.py:163 while True);
        # on data where no gt box fits the quarter-crop that is an
        # infinite hang inside a loader worker.  Bound the attempts and
        # signal failure with None — CustomDataset.__getitem__ retries
        # a different index (the reference-parity retry loop).
        for _ in range(1000):
            min_iou = self.rng.choice(self.sample_mode)
            left = self._valid_corner(w, new_w, boxes[:, 0], boxes[:, 2])
            top = self._valid_corner(h, new_h, boxes[:, 1], boxes[:, 3])
            if left is None or top is None:
                # no box can ever be contained along that axis: every
                # attempt would fail the `inside.any()` check below
                return None
            front = 0
            patch = np.array(
                [left, top, left + new_w, top + new_h, front, front + new_d],
                np.float32,
            )
            overlaps = _bbox_overlaps_np(patch[None], boxes).reshape(-1)
            if overlaps.min() < min_iou:
                continue
            inside = (
                (boxes[:, 0] >= patch[0])
                & (boxes[:, 1] >= patch[1])
                & (boxes[:, 4] >= patch[4])
                & (boxes[:, 2] < patch[2])
                & (boxes[:, 3] < patch[3])
                & (boxes[:, 5] < patch[5])
            )
            if not inside.any():
                continue

            final_boxes = boxes[inside].copy()
            final_labels = np.asarray(labels)[inside]
            x1, y1, x2, y2, z1, z2 = patch.astype(int)
            img_out = img_hwd[y1:y2, x1:x2, z1:z2]
            final_boxes -= np.array([x1, y1, x1, y1, z1, z1], np.float32)
            masks_out = None
            if masks_hwd is not None:
                masks_out = [
                    m[y1:y2, x1:x2, z1:z2]
                    for m, keep in zip(masks_hwd, inside)
                    if keep
                ]
            return img_out, final_boxes, final_labels, masks_out
        return None


class PhotoMetricDistortion3D:
    """Brightness/contrast jitter for volumes (reference extra_aug.py
    PhotoMetricDistortion, reduced to the intensity ops that are
    meaningful for single-channel medical volumes — saturation/hue assume
    natural-image color)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 rng=None):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.rng = rng or np.random.RandomState()

    def __call__(self, img, boxes, labels, masks=None):
        img = img.astype(np.float32)
        if self.rng.randint(2):
            img = img + self.rng.uniform(
                -self.brightness_delta, self.brightness_delta
            )
        if self.rng.randint(2):
            img = img * self.rng.uniform(
                self.contrast_lower, self.contrast_upper
            )
        return img, boxes, labels, masks


class ExtraAugmentation3D:
    """Compose extra augmentations (reference extra_aug.py:216-237)."""

    def __init__(self, photo_metric_distortion=None, random_crop_3d=None,
                 rng=None):
        self.transforms = []
        if photo_metric_distortion is not None:
            self.transforms.append(
                PhotoMetricDistortion3D(**photo_metric_distortion, rng=rng)
            )
        if random_crop_3d is not None:
            kwargs = {
                k: v
                for k, v in random_crop_3d.items()
                if k in ("min_ious", "min_crop_size")
            }
            self.transforms.append(RandomCrop3D(**kwargs, rng=rng))

    def __call__(self, img, boxes, labels, masks=None):
        for t in self.transforms:
            out = t(img, boxes, labels, masks)
            if out is None:  # crop exhausted its attempts -> retry idx
                return None
            img, boxes, labels, masks = out
        return img, boxes, labels, masks
