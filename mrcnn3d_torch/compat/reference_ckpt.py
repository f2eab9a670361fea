"""Reference (mmdet, PyTorch) checkpoints -> the port's detector.

Counterpart of `mrcnn3d/compat/torch_convert.py:load_torch_checkpoint`
and `merge_into_variables`.  The port's state_dict keeps the reference's
names and layouts (NCDHW kernels, (out, in) linear weights in C*D*H*W
order, ConvTranspose3d (in, out, kd, kh, kw)), so a reference tensor is
loaded as it is: no transform, only the name handling of the JAX
loader.

  * a Runner-style file is unwrapped (`state_dict`, then
    `model_state_dict`, else the file itself);
  * a `module.` prefix (DataParallel) is stripped;
  * the reference backbone's self-supervised projection keys (`EXCLUDE`,
    reference resnet3d.py:422-438) are skipped, and so are BatchNorm's
    `num_batches_tracked` counters, which the frozen BN does not keep;
  * a key of the model that the file lacks keeps its value (a
    backbone-only pretrain loads into the backbone alone);
  * a key the model lacks raises KeyError, a shape that differs
    ValueError, before any tensor is written.
"""
from __future__ import annotations

import numpy as np
import torch

# reference resnet3d.py's projection heads, which no detector loads
# (`mrcnn3d/compat/torch_convert.py:34`)
EXCLUDE = (
    "projection_original_features",
    "connect_patches_feature",
)
# BatchNorm3d's step counter: the frozen BN keeps no such buffer
SKIP_SUFFIXES = ("num_batches_tracked",)


def reference_state_dict(path):
    """The reference checkpoint at `path` as {name: tensor} under the
    port's names: unwrapped, `module.` stripped, EXCLUDE and the BN
    counters dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model_state_dict", ckpt))
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if any(e in k for e in EXCLUDE) or k.endswith(SKIP_SUFFIXES):
            continue
        out[k] = v if torch.is_tensor(v) else torch.from_numpy(
            np.asarray(v))
    return out


def merge(model, state_dict):
    """Writes `state_dict`'s tensors into `model`'s parameters and
    buffers, in place, cast to each one's dtype and device; the model's
    other keys keep their values.  Raises KeyError for a name the model
    lacks and ValueError for a shape that differs, before writing
    anything.  Returns the names of the model's keys left as they were."""
    own = model.state_dict()
    for k, v in state_dict.items():
        if k not in own:
            raise KeyError(f"unknown checkpoint key {k!r}")
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k!r}: model "
                             f"{tuple(own[k].shape)}, checkpoint "
                             f"{tuple(v.shape)}")
    with torch.no_grad():
        for k, v in state_dict.items():
            own[k].copy_(v)
    return sorted(set(own) - set(state_dict))


def load_reference_checkpoint(model, path):
    """Loads the reference checkpoint at `path` into `model` (`merge`);
    returns the names of the model's keys the file did not hold."""
    return merge(model, reference_state_dict(path))
