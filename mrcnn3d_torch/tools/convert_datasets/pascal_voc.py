"""A Pascal-VOC tree's split lists for the port's VOCDataset (reference
tools/convert_datasets/pascal_voc.py; the JAX package's counterpart).

    python -m mrcnn3d_torch.tools.convert_datasets.pascal_voc VOCdevkit/VOC2007 out/

VOCDataset parses the XML annotations itself, so the conversion writes
only the list files its constructor reads: for each of train, val,
trainval and test that ImageSets/Main holds, one image id a line.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Write VOC split id lists")
    p.add_argument("voc_root", help="e.g. VOCdevkit/VOC2007")
    p.add_argument("out_dir")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    split_dir = osp.join(args.voc_root, "ImageSets", "Main")
    written = {}
    for split in ("train", "val", "trainval", "test"):
        src = osp.join(split_dir, f"{split}.txt")
        if not osp.exists(src):
            continue
        with open(src) as f:
            ids = [ln.split()[0] for ln in f if ln.strip()]
        dst = osp.join(args.out_dir, f"{split}.txt")
        with open(dst, "w") as f:
            f.write("\n".join(ids) + "\n")
        print(f"{split}: {len(ids)} ids -> {dst}")
        written[split] = dst
    return written


if __name__ == "__main__":
    main()
