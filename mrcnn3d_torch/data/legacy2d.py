"""Legacy 2-D datasets: RGB 2.5-D, VOC/XML and the Concat/Repeat
wrappers (the port's copy of `mrcnn3d/data/legacy2d.py`).

  * CocoRGBDataset (reference coco_rgb.py): one RGB image whose channels
    are adjacent volume slices; each annotation's `slice_label` (r, g or
    b) names the slice whose head set trains on it, so a sample carries
    gt_boxes / gt_valid / gt_labels under the suffixes _r, _g, _b, which
    the loader collates as they are.
  * XMLDataset / VOCDataset (reference xml_style.py, voc.py): VOC-style
    XML annotations (JPEGImages/ + Annotations/), difficult boxes kept
    apart as ignored ones.
  * ConcatDataset / RepeatDataset (reference concat_dataset.py,
    repeat_dataset.py): composition wrappers.

Samples are depth-1 channel-last volumes (1, H, W, 3) with z extents
[0, 0], the 2-D detector family's batch schema (the loader permutes the
images to NCDHW).  Images are .npy arrays or files PIL reads; PIL is
imported only when such a file is read.
"""
from __future__ import annotations

import json
import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from .transforms import pad_gt

# `mrcnn3d/data/legacy2d.py:24-29`
VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_image(path):
    """(H, W, 3) image from .npy or a PIL-readable file (a grey image is
    repeated to three channels)."""
    if path.endswith(".npy"):
        img = np.load(path, allow_pickle=True)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def boxes_2d_to_6dof(boxes):
    """(N, 4) xyxy -> (N, 6) with z [0, 0]."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    return np.concatenate(
        [boxes, np.zeros((boxes.shape[0], 2), np.float32)], axis=1)


class Legacy2DBase:
    """Shared 2-D sample prep: normalize, pad, depth-1 volume + padded gt."""

    def __init__(self, img_norm_cfg, size_divisor=32, max_gt=16,
                 test_mode=False):
        self.img_norm_cfg = img_norm_cfg
        self.size_divisor = size_divisor
        self.max_gt = max_gt
        self.test_mode = test_mode

    def prep_img(self, img):
        """(H, W, 3) -> the normalised depth-1 volume (1, H', W', 3),
        H and W zero-padded up to size_divisor."""
        mean = np.asarray(self.img_norm_cfg["mean"], np.float32)
        std = np.asarray(self.img_norm_cfg["std"], np.float32)
        out = ((img.astype(np.float32) - mean) / std)[None]
        pad_h = (-out.shape[1]) % self.size_divisor
        pad_w = (-out.shape[2]) % self.size_divisor
        if pad_h or pad_w:
            out = np.pad(out, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
        return np.ascontiguousarray(out)

    def __getitem__(self, idx):
        return (self.prepare_test(idx) if self.test_mode
                else self.prepare_train(idx))


class CocoRGBDataset(Legacy2DBase):
    """COCO-json RGB 2.5-D dataset (`mrcnn3d/data/legacy2d.py:78-146`;
    reference coco_rgb.py:11-132).  Outside test_mode, images without any
    annotation are dropped."""

    SLICES = ("r", "g", "b")

    def __init__(self, ann_file, img_prefix, img_norm_cfg, **kwargs):
        super().__init__(img_norm_cfg, **kwargs)
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.img_infos = self.coco["images"]
        self.anns_by_img = {}
        for ann in self.coco["annotations"]:
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        if not self.test_mode:
            self.img_infos = [i for i in self.img_infos
                              if self.anns_by_img.get(i["id"])]

    def __len__(self):
        return len(self.img_infos)

    def slice_gt(self, img_id):
        """{slice: (boxes (n, 6), labels (n,))} grouped by slice_label
        (default r), COCO [x, y, w, h] as [x, y, x + w - 1, y + h - 1]
        (reference :62-79)."""
        out = {}
        for key in self.SLICES:
            anns = [a for a in self.anns_by_img.get(img_id, [])
                    if a.get("slice_label", "r") == key]
            boxes = [[a["bbox"][0], a["bbox"][1],
                      a["bbox"][0] + a["bbox"][2] - 1,
                      a["bbox"][1] + a["bbox"][3] - 1] for a in anns]
            labels = np.array([a.get("category_id", 1) for a in anns],
                              np.int32)
            out[key] = (boxes_2d_to_6dof(boxes), labels)
        return out

    def _image(self, idx):
        return load_image(osp.join(self.img_prefix,
                                   self.img_infos[idx]["file_name"]))

    def prepare_train(self, idx):
        info = self.img_infos[idx]
        sample = dict(imgs=self.prep_img(self._image(idx)))
        for key, (boxes, labels) in self.slice_gt(info["id"]).items():
            g = pad_gt(boxes, labels, self.max_gt)
            for name in ("gt_boxes", "gt_valid", "gt_labels"):
                sample[f"{name}_{key}"] = g[name]
        return sample

    def prepare_test(self, idx):
        img = self._image(idx)
        return dict(imgs=self.prep_img(img), img_info=self.img_infos[idx],
                    ori_shape=(1, img.shape[0], img.shape[1]))


class XMLDataset(Legacy2DBase):
    """VOC-style XML dataset (reference xml_style.py:10-76): ann_file
    lists image ids; JPEGImages/<id>.jpg + Annotations/<id>.xml."""

    CLASSES: tuple = ()

    def __init__(self, ann_file, img_prefix, img_norm_cfg, **kwargs):
        super().__init__(img_norm_cfg, **kwargs)
        self.img_prefix = img_prefix
        self.cat2label = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            img_ids = [ln.strip() for ln in f if ln.strip()]
        self.img_infos = []
        for img_id in img_ids:
            size = self._xml(img_id).find("size")
            self.img_infos.append(dict(
                id=img_id, file_name=f"JPEGImages/{img_id}.jpg",
                width=int(size.find("width").text),
                height=int(size.find("height").text)))

    def _xml(self, img_id):
        return ET.parse(osp.join(self.img_prefix, "Annotations",
                                 f"{img_id}.xml")).getroot()

    def __len__(self):
        return len(self.img_infos)

    def get_ann_info(self, idx):
        """bboxes/labels, the difficult ones as bboxes_ignore/
        labels_ignore (reference xml_style.py:32-76); 0-based corners."""
        root = self._xml(self.img_infos[idx]["id"])
        boxes, labels, boxes_ig, labels_ig = [], [], [], []
        for obj in root.findall("object"):
            label = self.cat2label.get(obj.find("name").text, 0)
            bb = obj.find("bndbox")
            box = [int(bb.find(k).text)
                   for k in ("xmin", "ymin", "xmax", "ymax")]
            if int(obj.find("difficult").text):
                boxes_ig.append(box)
                labels_ig.append(label)
            else:
                boxes.append(box)
                labels.append(label)
        return dict(
            bboxes=np.array(boxes, np.float32).reshape(-1, 4) - 1,
            labels=np.array(labels, np.int32),
            bboxes_ignore=np.array(boxes_ig, np.float32).reshape(-1, 4) - 1,
            labels_ignore=np.array(labels_ig, np.int32),
        )

    def _image(self, idx):
        return load_image(osp.join(self.img_prefix,
                                   self.img_infos[idx]["file_name"]))

    def prepare_train(self, idx):
        ann = self.get_ann_info(idx)
        sample = dict(imgs=self.prep_img(self._image(idx)))
        sample.update(pad_gt(boxes_2d_to_6dof(ann["bboxes"]), ann["labels"],
                             self.max_gt))
        return sample

    def prepare_test(self, idx):
        img = self._image(idx)
        return dict(imgs=self.prep_img(img), img_info=self.img_infos[idx],
                    ori_shape=(1, img.shape[0], img.shape[1]))


class VOCDataset(XMLDataset):
    """Pascal VOC (reference voc.py:4-18)."""

    CLASSES = VOC_CLASSES


class ConcatDataset:
    """Concatenation wrapper (reference concat_dataset.py)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1]) if len(self.datasets) else 0

    def _locate(self, idx):
        ds_idx = int(np.searchsorted(self._offsets, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self._offsets[ds_idx - 1])
        return self.datasets[ds_idx], idx - prev

    def __getitem__(self, idx):
        ds, i = self._locate(idx)
        return ds[i]

    def prepare_test(self, idx):
        ds, i = self._locate(idx)
        return ds.prepare_test(i)


class RepeatDataset:
    """Epoch-multiplier wrapper (reference repeat_dataset.py)."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def prepare_test(self, idx):
        return self.dataset.prepare_test(idx % len(self.dataset))
