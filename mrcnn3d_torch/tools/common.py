"""What the command-line tools share: the device flag, the synthetic sets'
root and the test-mode dataset of a config."""
from __future__ import annotations

import os
import tempfile


def add_device_flag(parser):
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (the default; raises without a card) or cpu")


def resolve(device_flag):
    from ..utils.device import resolve_device

    return resolve_device(None if device_flag == "cuda" else device_flag)


def synthetic_root(name):
    """Where a tool's --synthetic set is written: the temp dir, under
    names of the port's own (the JAX package's tools use their own)."""
    return os.path.join(tempfile.gettempdir(), f"mrcnn3d_torch_synth_{name}")


def train_dataset_class(cfg):
    """The training dataset of cfg.model's type, by its scale count (the
    JAX tools choose by it, `tools/train.py:89-96`)."""
    from ..data import coco3d
    from ..detectors.build import num_scales

    return {1: coco3d.Coco3DDataset, 2: coco3d.Coco3D2ScalesDataset,
            3: coco3d.Coco3D3ScalesDataset}[num_scales(cfg)]


def test_dataset(block, ann_file, img_dir, scales=2):
    """The test-mode dataset of a config's data block (test, val or the
    data2 twin's test): single-scale for a single-scale type, else
    two-scale (`tools/test.py:77`; the test API feeds imgs_2 at most)."""
    from ..data.coco3d import Coco3D2ScalesDataset, Coco3DDataset

    cls = Coco3DDataset if scales == 1 else Coco3D2ScalesDataset
    return cls(
        ann_file,
        img_dir,
        img_norm_cfg=block["img_norm_cfg"],
        size_divisor=block.get("size_divisor", 32),
        with_mask=False,
        test_mode=True,
    )
