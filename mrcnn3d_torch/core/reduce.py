"""The batch statistics of a multi-process train step, summed over the
ranks that share its global batch.

The JAX step differentiates one loss over the global batch, so its loss
normalizers (and the logged accuracies' counts) are sums over every
image.  Here each rank holds a share of that batch: the train step
(`train/step.py`) names the ranks that share it with `loss_group`, and
each normalizer goes through `global_sum`.

Under a process group of more than one rank, `global_sum` raises
outside a `loss_group`: a caller of `forward_train` there says whether
its normalizers count over a group or over its own rows alone
(`loss_group(None)`), rather than getting per-rank normalizers unasked.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch.distributed as dist

_UNSET = object()
_LOSS_GROUP = contextvars.ContextVar("mrcnn3d_torch_loss_group",
                                     default=_UNSET)


@contextlib.contextmanager
def loss_group(group):
    """Within it, `global_sum` sums over `group`: the data group whose
    ranks each hold a share of the global batch (None: no sum, this
    rank's batch is the whole)."""
    token = _LOSS_GROUP.set(group)
    try:
        yield
    finally:
        _LOSS_GROUP.reset(token)


def _active_group():
    """The active loss group, None for this rank's rows alone; raises
    outside a loss group under a process group of more than one rank."""
    group = _LOSS_GROUP.get()
    if group is _UNSET:
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise RuntimeError(
                "a loss normalizer under a process group of "
                f"{dist.get_world_size()} ranks outside a loss group: enter "
                "core.reduce.loss_group(the data group), or "
                "loss_group(None) for this rank's rows alone")
        return None
    return group


def global_sum(x):
    """A batch statistic (a loss normalizer, an accuracy's counts) summed
    over the active `loss_group`, detached; `x` itself within
    `loss_group(None)`, or outside a loss group when no process group of
    more than one rank is active."""
    group = _active_group()
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def global_all(x):
    """Whether a batch condition (a bool tensor) holds for every row of
    the active `loss_group`'s global batch, as a float32 0-d tensor (1 or
    0): `x.all()` here, then the minimum over the group; the groups as
    for `global_sum`."""
    x = x.all().float()
    group = _active_group()
    if group is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x
