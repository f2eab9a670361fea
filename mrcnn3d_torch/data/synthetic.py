"""Synthetic COCO-3D dataset generator: the port's copy of
`mrcnn3d/data/synthetic.py`, byte for byte the same output (the pinned
learning protocol hashes it).

The reference's SWI microbleed cohort is private (BASELINE.md), so tests,
benchmarks and end-to-end training demos use synthetic volumes: dark
brain-like background with small bright ellipsoid lesions, written in the
exact COCO-3D layout the reference documents (README annotation format):
(H, W, D) .npy volumes, json annotations with [x, y, w, h, z, d] bboxes
and per-instance segmentation .npy paths + labels.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np


def make_synthetic_coco3d(
    root,
    num_volumes=4,
    hw=128,
    depth=32,
    lesions_per_volume=(2, 5),
    seed=0,
):
    """Write volumes + annotations; returns (ann_file, img_dir)."""
    rng = np.random.RandomState(seed)
    img_dir = osp.join(root, "volumes")
    seg_dir = osp.join(root, "annotations_full")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    for vid in range(1, num_volumes + 1):
        vol = rng.normal(70, 12, (hw, hw, depth)).astype(np.float32)
        # soft brain-ish envelope
        yy, xx = np.mgrid[0:hw, 0:hw]
        r = np.sqrt((yy - hw / 2) ** 2 + (xx - hw / 2) ** 2) / (hw / 2)
        vol *= np.clip(1.2 - r, 0, 1)[..., None]

        seg_label_vol = np.zeros((hw, hw, depth), np.uint8)
        n_lesions = rng.randint(*lesions_per_volume)
        name = f"synthetic_{vid:04d}.npy"
        for li in range(1, n_lesions + 1):
            rw = rng.randint(3, 9)
            rh = rng.randint(3, 9)
            rd = rng.randint(2, 5)
            cx = rng.randint(rw + 8, hw - rw - 8)
            cy = rng.randint(rh + 8, hw - rh - 8)
            cz = rng.randint(rd + 1, depth - rd - 1)
            # the ellipsoid test on its bounding box only, which lies
            # inside the volume: the same voxels as the JAX package's
            # test over the whole volume, at a fraction of the work
            z0, y0, x0 = cz - rd, cy - rh, cx - rw
            zz, yy2, xx2 = np.mgrid[z0:cz + rd + 1, y0:cy + rh + 1,
                                    x0:cx + rw + 1]
            ell = (
                ((xx2 - cx) / rw) ** 2
                + ((yy2 - cy) / rh) ** 2
                + ((zz - cz) / rd) ** 2
            ) <= 1.0
            ell = np.transpose(ell, (1, 2, 0))  # (h, w, d) of the box
            box = (slice(y0, cy + rh + 1), slice(x0, cx + rw + 1),
                   slice(z0, cz + rd + 1))
            vol[box][ell] = rng.normal(220, 10)
            seg_label_vol[box][ell] = li

            ys, xs, zs = np.where(ell)
            x1, x2 = x0 + xs.min(), x0 + xs.max()
            y1, y2 = y0 + ys.min(), y0 + ys.max()
            z1, z2 = z0 + zs.min(), z0 + zs.max()
            seg_path = osp.join(
                seg_dir, f"synthetic_{vid:04d}_instance_{li}.npy"
            )
            annotations.append(
                dict(
                    id=ann_id,
                    image_id=vid,
                    category_id=1,
                    iscrowd=0,
                    area=int(ell.sum()),
                    bbox=[
                        int(x1),
                        int(y1),
                        int(x2 - x1 + 1),
                        int(y2 - y1 + 1),
                        int(z1),
                        int(z2 - z1 + 1),
                    ],
                    segmentation=seg_path,
                    segmentation_label=li,
                    width=hw,
                    height=hw,
                )
            )
            ann_id += 1
        # one shared instance-label volume per image (reference layout
        # stores one .npy per instance; sharing one labelled volume per
        # image is equivalent through segmentation_label selection)
        for a in annotations:
            if a["image_id"] == vid:
                np.save(a["segmentation"], seg_label_vol)
        np.save(osp.join(img_dir, name), vol)
        images.append(
            dict(
                id=vid,
                file_name=name,
                width=hw,
                height=hw,
            )
        )

    coco = dict(
        images=images,
        annotations=annotations,
        categories=[dict(id=1, name="microbleed", supercategory="COCO")],
    )
    ann_file = osp.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump(coco, f)
    return ann_file, img_dir


def make_synthetic_coco3d_scaled(src_ann, src_img_dir, dst_root, factor=1.5):
    """Resolution-scaled twin of a synthetic set (the `data2` layout).

    Mirrors the reference's pre-materialized 1.5x dataset root
    (configs/3d-multi-resolution-rcnn.py data_root_2 'COCO-full-vol-1dot5x'):
    volumes are trilinearly upscaled by `factor` in all three dims (the
    port's C++ `native.resize_trilinear`),
    instance-label volumes nearest-neighbour upscaled, and annotation
    boxes scaled into the new frame.  Image ids are preserved so merged
    double_test detections resolve to the same full-volume gt ids.
    """
    from .. import native

    img_dir = osp.join(dst_root, "volumes")
    seg_dir = osp.join(dst_root, "annotations_full")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)

    with open(src_ann) as f:
        coco = json.load(f)
    images, annotations = [], []
    seg_written = {}
    for im in coco["images"]:
        vol = np.load(osp.join(src_img_dir, im["file_name"]))  # (H, W, D)
        h, w, d = vol.shape
        oh, ow, od = (
            int(round(h * factor)),
            int(round(w * factor)),
            int(round(d * factor)),
        )
        dhwc = np.ascontiguousarray(
            np.transpose(vol, (2, 0, 1))[..., None].astype(np.float32)
        )
        out = native.resize_trilinear(dhwc, od, oh, ow)[..., 0]
        np.save(
            osp.join(img_dir, im["file_name"]),
            np.transpose(out, (1, 2, 0)).astype(np.float32),
        )
        images.append(
            dict(im, width=ow, height=oh)
        )
    for a in coco["annotations"]:
        x, y, bw, bh, z, bd = a["bbox"]
        b2 = [
            x * factor,
            y * factor,
            bw * factor,
            bh * factor,
            z * factor,
            bd * factor,
        ]
        a2 = dict(a, bbox=b2, area=int(a["area"] * factor**3))
        src_seg = a.get("segmentation")
        if isinstance(src_seg, str) and src_seg and osp.exists(src_seg):
            dst_seg = osp.join(seg_dir, osp.basename(src_seg))
            if src_seg not in seg_written:
                lab = np.load(src_seg)  # (H, W, D) instance labels
                hh, ww, dd = lab.shape
                yi = np.clip(
                    (np.arange(int(round(hh * factor))) / factor).astype(int),
                    0, hh - 1,
                )
                xi = np.clip(
                    (np.arange(int(round(ww * factor))) / factor).astype(int),
                    0, ww - 1,
                )
                zi = np.clip(
                    (np.arange(int(round(dd * factor))) / factor).astype(int),
                    0, dd - 1,
                )
                np.save(dst_seg, lab[np.ix_(yi, xi, zi)])
                seg_written[src_seg] = dst_seg
            a2["segmentation"] = seg_written[src_seg]
        annotations.append(a2)

    out_coco = dict(
        images=images,
        annotations=annotations,
        categories=coco["categories"],
    )
    ann_file = osp.join(dst_root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump(out_coco, f)
    return ann_file, img_dir
