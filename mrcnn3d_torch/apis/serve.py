"""Persistent serving loop around the InferenceRunner.

Counterpart of `mrcnn3d/apis/serve.py`: a long-lived process keeps the
built detector and its anchor sets resident (cached per volume shape)
and overlaps host IO with the card's compute via a prefetch thread
(double buffering).

Two drive modes:
  * `serve_paths(runner, paths)` -- stream a list of volume files.
  * `watch(runner, in_dir, out_dir)` -- poll a directory; each new
    `<name>.npy` volume produces `<name>.json` detections.

Volumes are normalised with the config's img_norm_cfg and padded to the
size divisor, mirroring Coco3DDataset.prepare_test; the 1.5x twin is
synthesised with the C++ trilinear resizer exactly as the JAX package's
serving loop does.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import queue
import threading
import time

import numpy as np

from ..data.coco3d import _trilinear_resize
from ..data.transforms import normalize_volume, pad_to_divisor


def _prepare(path, norm, size_divisor, upscale):
    vol = np.load(path, allow_pickle=True)  # (H, W, D)
    img = normalize_volume(vol, norm["mean"], norm["std"])
    img, ori = pad_to_divisor(img, size_divisor)
    sample = dict(imgs=img, ori_shape=ori, path=path)
    d, h, w, _ = img.shape
    out = (int(d * upscale), int(h * upscale), int(w * upscale))
    img2 = np.stack(
        [_trilinear_resize(img[..., c], out) for c in range(3)],
        axis=-1,
    )
    img2, _ = pad_to_divisor(img2, size_divisor)
    sample["imgs_2"] = img2
    sample["img_info"] = dict(file_name=osp.basename(path))
    return sample


def serve_paths(runner, paths, norm, size_divisor=32, num_classes=2,
                score_thr=0.0, prefetch=2):
    """Yield (path, per-class results) for each volume file, with IO
    prefetch overlapping the card's compute.  runner: an
    `apis.test_api.InferenceRunner`."""
    upscale = runner.cfg.get("upscale_factor", 1.5)
    q: queue.Queue = queue.Queue(maxsize=prefetch)

    def produce():
        try:
            for p in paths:
                q.put(_prepare(p, norm, size_divisor, upscale))
        except BaseException as e:
            q.put(e)
        else:
            q.put(None)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        sample = q.get()
        if sample is None:
            return
        if isinstance(sample, BaseException):
            raise sample
        dets, labels, valid = runner(sample)[:3]
        keep = valid & (dets[:, 6] >= score_thr)
        per_class = [dets[keep & (labels == c)]
                     for c in range(num_classes - 1)]
        yield sample["path"], per_class


def results_json(per_class):
    """Serializable detection record: per class, [x1..z2, score] rows."""
    return {
        f"class_{c + 1}": d.tolist()
        for c, d in enumerate(per_class)
    }


def watch(runner, in_dir, out_dir, norm, size_divisor=32, num_classes=2,
          poll_s=1.0, stop_after=None, score_thr=0.0, timers=None):
    """Poll `in_dir` for volumes; write `<name>.json` to `out_dir`.

    `stop_after` bounds processed volumes (None = run forever).  timers:
    optional dict; each volume's seconds from the start of its batch of
    files to its json written are appended to timers["volume_s"]."""
    os.makedirs(out_dir, exist_ok=True)
    seen: set = set()
    processed = 0
    while stop_after is None or processed < stop_after:
        fresh = sorted(
            f for f in os.listdir(in_dir)
            if f.endswith(".npy") and f not in seen
        )
        if not fresh:
            time.sleep(poll_s)
            continue
        paths = [osp.join(in_dir, f) for f in fresh]
        seen.update(fresh)
        t = time.perf_counter()
        for path, per_class in serve_paths(
            runner, paths, norm, size_divisor, num_classes,
            score_thr=score_thr,
        ):
            name = osp.splitext(osp.basename(path))[0]
            with open(osp.join(out_dir, name + ".json"), "w") as f:
                json.dump(results_json(per_class), f)
            processed += 1
            if timers is not None:
                now = time.perf_counter()
                timers.setdefault("volume_s", []).append(now - t)
                t = now
            if stop_after is not None and processed >= stop_after:
                break
