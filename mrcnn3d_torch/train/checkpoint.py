"""Checkpoints keyed by step, as `mrcnn3d/train/checkpoint.py` keeps
them, with torch.save in place of orbax.

`work_dir/checkpoints/<step>/state.pt` holds the whole train state: the
model's state_dict (parameters and frozen-BN statistics), the
optimizer's (momentum buffers) and the step, which also fixes the
schedule.  `max_to_keep` bounds the directories kept; `restore` puts a
state back in full, `restore_params` reads the model's tensors alone,
for serving.
"""
from __future__ import annotations

import os
import shutil

import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, work_dir, max_to_keep=5):
        self.path = os.path.abspath(os.path.join(work_dir, "checkpoints"))
        self.max_to_keep = max_to_keep
        os.makedirs(self.path, exist_ok=True)

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.path)
                      if d.isdigit()
                      and os.path.exists(os.path.join(self.path, d, _FILE)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step):
        return os.path.join(self.path, str(int(step)))

    def save(self, step, tree):
        """Writes `tree` for `step` (into a temporary file first, so a cut
        run leaves no half-written checkpoint), then drops the oldest
        steps beyond max_to_keep."""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, _FILE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(d, _FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(old))

    def load(self, step, map_location="cpu"):
        return torch.load(os.path.join(self.step_dir(step), _FILE),
                          map_location=map_location, weights_only=True)


def save(manager, state, step=None):
    """Saves a train state (`train.step.TrainState`) at `step` (its own
    step by default)."""
    step = state.step if step is None else step
    manager.save(step, dict(model=state.model.state_dict(),
                            optimizer=state.optimizer.state_dict(),
                            step=int(state.step)))


def restore(manager, state, step=None):
    """Loads the checkpoint of `step` (the latest by default) into
    `state` in place: model, optimizer and step.  Returns the state, or
    None when there is no checkpoint."""
    step = manager.latest_step() if step is None else step
    if step is None:
        return None
    dev = next(state.model.parameters()).device
    raw = manager.load(step, map_location=dev)
    state.model.load_state_dict(raw["model"])
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state


def restore_params(manager, step=None):
    """The model's tensors of a checkpoint, for serving:
    {"params": state_dict, "step": int}, or None."""
    step = manager.latest_step() if step is None else step
    if step is None:
        return None
    raw = manager.load(step)
    return dict(params=raw["model"], step=int(raw["step"]))
