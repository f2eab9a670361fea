"""COCO-3D datasets (.npy volumes + 6-element bboxes): the port's copy of
`mrcnn3d/data/coco3d.py` (its single-, two- and three-scale, parcel and
2-D datasets).  Samples are numpy, channel-last (D, H, W, 3); the loader
(`data/loader.py`) turns a batch into the model's NCDHW on the card.

Host-side replacements for the reference dataset stack
(mmdet/datasets/coco_3d.py, coco_3d_2scales.py, custom.py):

  * annotations: COCO-format json with bbox [x, y, w, h, z, depth] and
    per-instance `segmentation` .npy path + `segmentation_label`
    (reference README annotation format; parse is plain json — no
    pycocotools dependency needed for loading)
  * volumes: (H, W, D) .npy files
  * train: RandomCrop3D -> normalize -> channel-last (D, H, W, 3) +
    padded gt arrays (static shapes for jit)
  * 2-scale train: crop at 1.0x, skimage-style trilinear upscale of the
    crop to the 1.5x twin, gt_bboxes_2 = gt_bboxes * factor
    (reference coco_3d_2scales.py:209-234; masks_2 disabled there too)
  * test: full padded volumes at both resolutions, filename-matched
  * 3-scale: a 2.25x twin besides the 1.5x one (reference
    coco_3d_3scales.py); parcel: each instance's `brain_region` as
    gt_bregions (reference coco_3d_parcel.py:63-107)
  * 2-D: images as depth-1 volumes for the 2-D detector family, COCO's
    4-element boxes with z [0, 0] (`Coco2DDataset`)

Patch-tiled evaluation sets carry `pos_top/pos_left/pos_front` offsets in
img_info, consumed by the eval json writers (`eval/results.py`).
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from .random_crop3d import ExtraAugmentation3D
from .transforms import normalize_volume, pad_gt, pad_to_divisor


def _xywhzd_to_xyxyzz(b):
    x, y, w, h, z, d = b
    return [x, y, x + w - 1, y + h - 1, z, z + d - 1]


class Coco3DDataset:
    """Single-resolution COCO-3D dataset."""

    def __init__(
        self,
        ann_file,
        img_prefix,
        img_norm_cfg,
        size_divisor=32,
        with_mask=True,
        test_mode=False,
        max_gt=16,
        extra_aug=None,
        seed=None,
        cache_masks=False,
    ):
        self.img_prefix = img_prefix
        self.img_norm_cfg = img_norm_cfg
        self.size_divisor = size_divisor
        self.with_mask = with_mask
        self.test_mode = test_mode
        self.max_gt = max_gt
        # optional whole-run in-memory segmentation cache (reference
        # CustomDataset.load_mask_from_memory, custom.py:164-176)
        self.cache_masks = cache_masks
        self._mask_cache = {}
        self.rng = np.random.RandomState(seed)
        self.crop = None
        if extra_aug:
            self.crop = ExtraAugmentation3D(
                photo_metric_distortion=extra_aug.get(
                    "photo_metric_distortion"
                ),
                random_crop_3d=extra_aug.get("random_crop_3d"),
                rng=self.rng,
            )
        self._load(ann_file)

    def _load(self, ann_file):
        with open(ann_file) as f:
            coco = json.load(f)
        self.coco = coco  # raw gt dict (for evaluation)
        self.img_infos = coco["images"]
        self.anns_by_img = {}
        for ann in coco["annotations"]:
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        if not self.test_mode:
            # reference skips images without gt (coco_3d_2scales.py:205)
            self.img_infos = [
                i for i in self.img_infos if self.anns_by_img.get(i["id"])
            ]

    def __len__(self):
        return len(self.img_infos)

    def _ann_arrays(self, img_id):
        anns = self.anns_by_img.get(img_id, [])
        boxes = np.array(
            [_xywhzd_to_xyxyzz(a["bbox"]) for a in anns], np.float32
        ).reshape(-1, 6)
        labels = np.array(
            [a.get("category_id", 1) for a in anns], np.int32
        )
        return anns, boxes, labels

    def _load_masks(self, anns):
        masks = []
        for a in anns:
            path = a["segmentation"]
            if self.cache_masks and path in self._mask_cache:
                seg = self._mask_cache[path]
            else:
                seg = np.load(path, allow_pickle=True)
                if self.cache_masks:
                    self._mask_cache[path] = seg
            masks.append((seg == a.get("segmentation_label", 1)).astype(np.uint8))
        return masks  # list of (H, W, D)

    def load_volume(self, img_info):
        return np.load(
            osp.join(self.img_prefix, img_info["file_name"]),
            allow_pickle=True,
        )

    def prepare_train(self, idx):
        info = self.img_infos[idx]
        vol = self.load_volume(info)  # (H, W, D)
        anns, boxes, labels = self._ann_arrays(info["id"])
        masks = self._load_masks(anns) if self.with_mask else None

        if self.crop is not None:
            out = self.crop(vol, boxes, labels, masks)
            if out is None:  # no crop satisfies containment: retry idx
                return None
            vol, boxes, labels, masks = out

        img = normalize_volume(
            vol, self.img_norm_cfg["mean"], self.img_norm_cfg["std"]
        )
        img, _ = pad_to_divisor(img, self.size_divisor)
        d, h, w, _ = img.shape
        masks_dhw = None
        if masks is not None:
            masks_dhw = [np.transpose(m, (2, 0, 1)) for m in masks]
            masks_dhw = [
                np.pad(
                    m,
                    (
                        (0, d - m.shape[0]),
                        (0, h - m.shape[1]),
                        (0, w - m.shape[2]),
                    ),
                )
                for m in masks_dhw
            ]
        sample = dict(imgs=img)
        sample.update(
            pad_gt(
                boxes,
                labels,
                self.max_gt,
                masks=masks_dhw,
                mask_shape=(d, h, w) if masks_dhw is not None else None,
            )
        )
        return sample

    def prepare_test(self, idx):
        info = self.img_infos[idx]
        vol = self.load_volume(info)
        img = normalize_volume(
            vol, self.img_norm_cfg["mean"], self.img_norm_cfg["std"]
        )
        img, ori = pad_to_divisor(img, self.size_divisor)
        return dict(imgs=img, img_info=info, ori_shape=ori)

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test(idx)
        for _ in range(50):
            sample = self.prepare_train(idx)
            if sample is not None:
                return sample
            idx = self.rng.randint(len(self))
        raise RuntimeError("no valid training sample found")


def _trilinear_resize(vol, out_shape):
    """Trilinear resize with skimage grid-center coords, (A, B, C) float.

    Delegates to the port's C++ host runtime (`native.resize_trilinear`,
    threaded) — the fused replacement for the reference's per-step
    skimage.transform.resize of the 1.5x twin (coco_3d_2scales.py:219).
    """
    from .. import native

    out = native.resize_trilinear(
        np.ascontiguousarray(vol, np.float32)[..., None], *out_shape
    )
    return out[..., 0]


class Coco3D2ScalesDataset(Coco3DDataset):
    """Paired 1.0x / 1.5x dataset.

    Train: crop the 1.0x volume, synthesise the 1.5x twin by trilinear
    upscale of the crop (reference coco_3d_2scales.py:209-234).
    Test: load the filename-matched 1.5x volume from `img_prefix_2`.
    """

    def __init__(self, *args, ann_file_2=None, img_prefix_2=None,
                 upscale_factor=1.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.upscale_factor = upscale_factor
        self.img_prefix_2 = img_prefix_2
        self.img_infos_2 = None
        if ann_file_2:
            with open(ann_file_2) as f:
                coco2 = json.load(f)
            by_name = {i["file_name"]: i for i in coco2["images"]}
            self.img_infos_2 = [
                by_name.get(i["file_name"]) for i in self.img_infos
            ]

    def prepare_train(self, idx):
        sample = super().prepare_train(idx)
        if sample is None:  # crop rejected the sample: retry idx
            return None
        up = self.upscale_factor
        img = sample["imgs"]  # (D, H, W, 3) normalised
        d, h, w, _ = img.shape
        out = (int(d * up), int(h * up), int(w * up))
        img2 = np.stack(
            [_trilinear_resize(img[..., c], out) for c in range(3)],
            axis=-1,
        )
        img2, _ = pad_to_divisor(img2, self.size_divisor)
        sample["imgs_2"] = img2
        sample["gt_boxes_2"] = sample["gt_boxes"] * up
        sample["gt_labels_2"] = sample["gt_labels"]
        sample["gt_valid_2"] = sample["gt_valid"]
        return sample

    def prepare_test(self, idx):
        sample = super().prepare_test(idx)
        if self.img_infos_2 is not None and self.img_prefix_2:
            info2 = self.img_infos_2[idx]
            vol2 = np.load(
                osp.join(self.img_prefix_2, info2["file_name"]),
                allow_pickle=True,
            )
        else:
            vol = self.load_volume(sample["img_info"])
            up = self.upscale_factor
            vol2 = _trilinear_resize(
                vol,
                (
                    int(vol.shape[0] * up),
                    int(vol.shape[1] * up),
                    int(vol.shape[2] * up),
                ),
            )
        img2 = normalize_volume(
            vol2, self.img_norm_cfg["mean"], self.img_norm_cfg["std"]
        )
        img2, ori2 = pad_to_divisor(img2, self.size_divisor)
        sample["imgs_2"] = img2
        sample["ori_shape_2"] = ori2
        return sample


class Coco3DParcelDataset(Coco3DDataset):
    """COCO-3D with per-instance `brain_region` labels (reference
    coco_3d_parcel.py:63-107): each annotation carries a 15-way brain
    parcellation class consumed by the parcellation head."""

    def _ann_arrays(self, img_id):
        anns, boxes, labels = super()._ann_arrays(img_id)
        bregions = np.array(
            [a.get("brain_region", 0) for a in anns], np.int32
        )
        # ride along through RandomCrop3D's label filtering as a 2-column
        # label array, split again in __getitem__
        stacked = np.stack([labels, bregions], axis=1)
        return anns, boxes, stacked

    def __getitem__(self, idx):
        sample = super().__getitem__(idx)
        if not self.test_mode and sample["gt_labels"].ndim == 2:
            stacked = sample["gt_labels"]
            sample["gt_labels"] = stacked[:, 0]
            sample["gt_bregions"] = stacked[:, 1]
        return sample


class Coco3D3ScalesDataset(Coco3D2ScalesDataset):
    """Triple-resolution dataset (reference coco_3d_3scales.py).

    Train: crop at 1.0x, synthesise the 1.5x and 2.25x (factor^2) twins
    by trilinear upscale; gt boxes scaled accordingly.  Test: the
    2.25x twin resized from the raw volume.
    """

    def prepare_train(self, idx):
        sample = super().prepare_train(idx)
        if sample is None:  # crop rejected the sample: retry idx
            return None
        from .. import native

        up = self.upscale_factor**2
        img = sample["imgs"]
        d, h, w, _ = img.shape
        img3 = native.resize_trilinear(img, int(d * up), int(h * up),
                                       int(w * up))
        img3, _ = pad_to_divisor(img3, self.size_divisor)
        sample["imgs_3"] = img3
        sample["gt_boxes_3"] = sample["gt_boxes"] * up
        sample["gt_labels_3"] = sample["gt_labels"]
        sample["gt_valid_3"] = sample["gt_valid"]
        return sample

    def prepare_test(self, idx):
        sample = super().prepare_test(idx)
        up = self.upscale_factor**2
        vol = self.load_volume(sample["img_info"])
        vol3 = _trilinear_resize(
            vol, tuple(int(n * up) for n in vol.shape)
        )
        img3 = normalize_volume(
            vol3, self.img_norm_cfg["mean"], self.img_norm_cfg["std"]
        )
        img3, ori3 = pad_to_divisor(img3, self.size_divisor)
        sample["imgs_3"] = img3
        sample["ori_shape_3"] = ori3
        return sample


class Coco2DDataset(Coco3DDataset):
    """2-D images as depth-1 volumes (the 2-D legacy family;
    `mrcnn3d/data/coco3d.py:336-368`).

    Accepts standard COCO 4-element bboxes ([x, y, w, h] -> z extent
    [0, 0]); image files are (H, W) or (H, W, 3) .npy arrays, an RGB one
    averaged over its channels.
    """

    def _ann_arrays(self, img_id):
        anns = self.anns_by_img.get(img_id, [])
        boxes = []
        for a in anns:
            b = a["bbox"]
            if len(b) == 4:
                boxes.append([b[0], b[1], b[0] + b[2] - 1,
                              b[1] + b[3] - 1, 0, 0])
            else:
                boxes.append(_xywhzd_to_xyxyzz(b))
        boxes = np.array(boxes, np.float32).reshape(-1, 6)
        labels = np.array(
            [a.get("category_id", 1) for a in anns], np.int32
        )
        return anns, boxes, labels

    def load_volume(self, img_info):
        img = np.load(
            osp.join(self.img_prefix, img_info["file_name"]),
            allow_pickle=True,
        )
        if img.ndim == 3:  # (H, W, 3) RGB -> its channels' mean
            img = img.mean(axis=-1)
        return img[..., None]  # (H, W, 1): a depth-1 volume
