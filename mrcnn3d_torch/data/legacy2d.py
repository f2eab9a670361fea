"""Legacy 2-D datasets: VOC/XML and the Concat/Repeat wrappers (the
port's copy of `mrcnn3d/data/legacy2d.py:32-76, :150-287`).

  * XMLDataset / VOCDataset (reference xml_style.py, voc.py): VOC-style
    XML annotations (JPEGImages/ + Annotations/), difficult boxes kept
    apart as ignored ones.
  * ConcatDataset / RepeatDataset (reference concat_dataset.py,
    repeat_dataset.py): composition wrappers.

Samples are depth-1 channel-last volumes (1, H, W, 3) with z extents
[0, 0], the 2-D detector family's batch schema.  Images are .npy arrays
or files PIL reads; PIL is imported only when such a file is read.  The
RGB 2.5-D dataset (CocoRGBDataset) comes with its detectors, ROADMAP
Queue A item 11.8 (c).
"""
from __future__ import annotations

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
