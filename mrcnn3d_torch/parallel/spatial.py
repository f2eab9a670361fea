"""Depth sharding of the backbone over a process group.

Counterpart of `mrcnn3d/parallel/spatial.py`.  There XLA's SPMD
partitioner splits the volume's depth over the mesh and inserts each
conv's halo exchange; here they are written out (`DepthSlabs`, which
`models/resnet3d.py` calls when its `depth_slabs` is set):

  * each rank of the group holds one equal depth slab of every
    activation, slab r being planes [r L, (r + 1) L);
  * a conv or pool whose depth window reaches past its slab first takes
    the planes it needs from the other ranks (`_Halo`): p below and
    k - s - p above for kernel k, stride s, padding p.  At the volume's
    ends the planes are zeros, or -inf for the max-pool (its padding);
    the op then runs unpadded in depth;
  * an op with a depth stride needs slab starts on its stride grid, so
    the activations stay sharded while the op's input depth divides
    group size x stride (JAX's rule, `mrcnn3d/models/resnet3d.py:
    306-340`) and are gathered whole (`_Gather`) once it does not; from
    there the backbone runs replicated;
  * the stage outputs are gathered whole before the FPN, so the neck,
    proposals and heads, and the kernels K1 and K2, run replicated on
    whole features.

Only ResNet3D has this (`depth_sharded` raises for another backbone, as
`spatial.py:62-69` does).  The JAX module's switch to the einsum align
(`spatial.py:85-95`) works round GSPMD and has no counterpart: K2 runs
on the gathered features.

Gradients.  Every rank of a depth group computes the same loss on the
gathered features.  The train step (`train/step.py`) differentiates
that loss divided by the group size, and `_Gather`'s backward sums over
the group (as torch.distributed.nn's all_gather does): a replicated
parameter then gets 1/n of its gradient on each rank, a sharded one its
slab's share of the whole gradient, and one sum of every gradient over
the group (`parallel.mesh.allreduce_grads`) gives each the whole
gradient once.  `_Halo`'s backward returns each halo plane's gradient
to the rank that owns the plane.

Collectives are all_gather and all_reduce, which gloo carries for CPU
and CUDA tensors alike.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _triple

from ..models.resnet3d import ResNet3D


def _all_gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Gather(torch.autograd.Function):
    """Slabs (B, C, L, H, W) -> the whole (B, C, n L, H, W); backward: the
    gradient summed over the group, this rank's slab of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.length = x.shape[2]
        return torch.cat(_all_gather(x, group), 2)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        r, n = dist.get_rank(ctx.group), ctx.length
        return grad[:, :, r * n:(r + 1) * n], None


class _Halo(torch.autograd.Function):
    """A slab (B, C, L, H, W) -> (B, C, lo + L + hi, H, W): the `lo` planes
    below it and `hi` above it from the ranks that hold them (`fill` past
    the volume's ends).  A window may reach further than one slab (a
    7-deep stem on 2-plane slabs), so each rank shares its first and
    last min(max(lo, hi), L) planes with every rank."""

    @staticmethod
    def forward(ctx, x, lo, hi, fill, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        length = x.shape[2]
        e = min(max(lo, hi), length)
        parts = _all_gather(
            torch.cat([x[:, :, :e], x[:, :, length - e:]], 2), group)
        pad = torch.full_like(x[:, :, :1], fill)

        def plane(q):
            if q < 0 or q >= n * length:
                return pad
            owner, j = divmod(q, length)
            k = j if j < e else e + j - (length - e)
            return parts[owner][:, :, k:k + 1]

        start = r * length
        below = [plane(q) for q in range(start - lo, start)]
        above = [plane(q) for q in range(start + length,
                                          start + length + hi)]
        ctx.lo, ctx.hi, ctx.length, ctx.group = lo, hi, length, group
        return torch.cat(below + [x] + above, 2)

    @staticmethod
    def backward(ctx, grad):
        lo, hi, length, group = ctx.lo, ctx.hi, ctx.length, ctx.group
        r = dist.get_rank(group)
        out = grad[:, :, lo:lo + length].clone()
        halos = _all_gather(
            torch.cat([grad[:, :, :lo], grad[:, :, lo + length:]], 2), group)
        start = r * length
        for src, h in enumerate(halos):
            # the global planes of rank src's halo, below then above
            first = src * length
            planes = list(range(first - lo, first)) + list(
                range(first + length, first + length + hi))
            for i, q in enumerate(planes):
                if start <= q < start + length:
                    out[:, :, q - start] += h[:, :, i]
        return out, None, None, None, None


class DepthSlabs:
    """A depth-sharded backbone pass over `group`: which rank holds which
    planes, and whether the activations are still sharded."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.sharded = False

    def _keeps(self, depth, stride):
        return depth % (self.n * stride) == 0 and depth // stride >= self.n

    def split(self, x):
        """This rank's slab of the whole (B, C, D, H, W) input, or the
        whole input where D does not divide the group."""
        depth = x.shape[2]
        self.sharded = self.n > 1 and self._keeps(depth, 1)
        if not self.sharded:
            return x
        length = depth // self.n
        return x[:, :, self.rank * length:(self.rank + 1) * length]

    def settle(self, x, op):
        """x, gathered whole if its depth no longer divides the group
        times `op`'s depth stride (and replicated from there)."""
        if self.sharded and not self._keeps(x.shape[2] * self.n,
                                            _triple(op.stride)[0]):
            self.sharded = False
            return _Gather.apply(x, self.group)
        return x

    def whole(self, x):
        """x gathered whole, if sharded."""
        return _Gather.apply(x, self.group) if self.sharded else x

    def apply(self, op, x):
        """A Conv3d or MaxPool3d on the slab, with its depth halo."""
        if not self.sharded:
            return op(x)
        k, s, p = (_triple(v)[0] for v in (op.kernel_size, op.stride,
                                           op.padding))
        d = _triple(op.dilation)[0]
        lo, hi = p, max(d * (k - 1) + 1 - s - p, 0)
        is_pool = isinstance(op, nn.MaxPool3d)
        if lo or hi:
            x = _Halo.apply(x, lo, hi, float("-inf") if is_pool else 0.0,
                            self.group)
        pad = (0,) + _triple(op.padding)[1:]
        if is_pool:
            return F.max_pool3d(x, op.kernel_size, op.stride, pad,
                                op.dilation, op.ceil_mode)
        return F.conv3d(x, op.weight, op.bias, op.stride, pad, op.dilation,
                        op.groups)


@contextlib.contextmanager
def depth_sharded(backbone, group=None):
    """Within it, `backbone` (a ResNet3D) runs depth-sharded over `group`
    (the default group when None): it takes the whole volume on every
    rank and returns whole stage outputs."""
    if not isinstance(backbone, ResNet3D):
        raise ValueError(
            f"depth sharding needs the ResNet3D backbone (got "
            f"{type(backbone).__name__}): only it has the per-stage slab "
            "rule (models/resnet3d.py)")
    backbone.depth_slabs = DepthSlabs(group or dist.group.WORLD)
    try:
        yield
    finally:
        backbone.depth_slabs = None


def spatial_extract_feat(model, group=None):
    """A function imgs (B, 3, D, H, W) -> the FPN levels, whole on every
    rank, with the backbone depth-sharded over `group`; `imgs` is the
    whole volume on every rank (`mrcnn3d/parallel/spatial.py:
    spatial_extract_feat`)."""

    def fn(imgs):
        with depth_sharded(model.backbone, group):
            return model.extract_feat(imgs)

    return fn


def sharded_simple_test(det, group=None):
    """Whole-volume inference with the backbone depth-sharded over
    `group`; proposals, heads and NMS run replicated.  det: an
    `entry.Flagship`.  Returns a function batch -> (dets, labels,
    valid)."""

    def fn(batch):
        with depth_sharded(det.model.backbone, group):
            out = det.simple_test(batch)
        return out["dets"], out["labels"], out["valid"]

    return fn
