"""Assignment, sampling and target encoding (torch), static shapes.

Port of `mrcnn3d/core/targets.py`: every array keeps a fixed padded size
with boolean validity masks, so no step needs a count on the host and
the train step never waits for the card.  Per image, as in the JAX
package (whose callers vmap these over the batch).

Semantics (reference mmdet):
  * MaxIoUAssigner's 4-step rule -- max_iou_assigner.py:130-223;
  * RandomSampler: above quota, draws WITH replacement, then `.unique()`
    (sorted, deduplicated), the negative quota counting the deduplicated
    positives -- random_sampler.py:36-59, base_sampler.py:77-79;
  * anchor_target_single -- anchor_target.py:126-201;
  * bbox targets -- bbox_target.py:34-58;
  * mask targets -- mask_target.py:17-51.

Random draws.  `jax.random` cannot be reproduced in torch, so every
sampler takes its integers from a `draws` source: a callable
`draws(site, n, high) -> (n,) int64 tensor in [0, high)` on `high`'s
device, where `site` names the draw (stage, scale, image, "pos"/"neg")
and `high` is a 0-d int64 tensor.  `TorchDraws` (the default) takes them
from an explicit `torch.Generator`; the tests pass a source that replays
the JAX package's key tree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.box3d import bbox2delta3d, bbox_overlaps_3d


class TorchDraws:
    """Uniform integers from `generator`: torch.randint over [0, 2^62)
    reduced modulo `high` (a bias below high / 2^62).  `high` stays a
    device tensor, so no count reaches the host."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, site, n, high):
        r = torch.randint(0, 2**62, (n,), generator=self.generator,
                          device=self.generator.device)
        return r.to(high.device) % high


def _stable_order(flags):
    """Indices with the True flags first, each group in ascending index
    order (JAX `argsort(~flags, stable=True)`)."""
    return torch.argsort((~flags).to(torch.uint8), stable=True)


def max_iou_assign(boxes, box_valid, gt_boxes, gt_valid, pos_iou_thr,
                   neg_iou_thr, min_pos_iou, gt_max_assign_all=True):
    """4-step max-IoU assignment.

    boxes (N, 6), box_valid (N,) bool; gt_boxes (G, 6), gt_valid (G,).
    Returns assigned (N,) int64 (-1 ignore, 0 negative, i+1 gt i),
    max_overlaps (N,) and argmax (N,).
    """
    g = gt_boxes.shape[0]
    overlaps = bbox_overlaps_3d(gt_boxes.float(), boxes.float())  # (G, N)
    pair_valid = gt_valid[:, None] & box_valid[None, :]
    overlaps = torch.where(pair_valid, overlaps, -1.0)

    max_overlaps, argmax = overlaps.max(dim=0)
    gt_max = overlaps.max(dim=1).values

    assigned = torch.full((boxes.shape[0],), -1, dtype=torch.int64,
                          device=boxes.device)
    # step 2: negatives
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           0, assigned)
    # step 3: positives above pos_iou_thr
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax + 1, assigned)
    # step 4: each gt's best boxes (a sequential loop in the reference:
    # later gts override earlier ones, so the last eligible gt wins)
    eligible = ((overlaps == gt_max[:, None])
                & ((gt_max >= min_pos_iou) & gt_valid & (gt_max > -1.0))
                [:, None])
    if not gt_max_assign_all:
        cols = torch.arange(overlaps.shape[1], device=boxes.device)
        eligible = eligible & (cols[None, :]
                               == overlaps.argmax(dim=1)[:, None])
    gt_idx = torch.arange(g, device=boxes.device)[:, None]
    last_elig = torch.where(eligible, gt_idx, -1).max(dim=0).values
    assigned = torch.where(eligible.any(dim=0), last_elig + 1, assigned)
    assigned = torch.where(box_valid, assigned, -1)
    return assigned, max_overlaps, argmax


class SampleResult(NamedTuple):
    """Fixed-size sampling result, padded with slot masks."""

    pos_inds: torch.Tensor  # (P,) indices into the candidates
    pos_mask: torch.Tensor  # (P,) bool
    neg_inds: torch.Tensor  # (Q,)
    neg_mask: torch.Tensor  # (Q,) bool
    pos_count: torch.Tensor  # () int64
    neg_count: torch.Tensor  # () int64


def _unique_compact(draws, valid, sentinel):
    """torch `.unique()` of the valid draws at a static size: the
    distinct values, ascending, first; then zeros.  Returns (inds (K,),
    mask (K,), count ())."""
    k = draws.shape[0]
    x = torch.where(valid, draws, sentinel)
    sx = torch.sort(x).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       sx[1:] != sx[:-1]]) & (sx < sentinel)
    out = sx[_stable_order(first)]
    count = first.sum()
    mask = torch.arange(k, device=x.device) < count
    return torch.where(mask, out, 0), mask, count


def _take(order, k):
    """order[:k], zero-padded when there are fewer than k candidates."""
    if order.shape[0] >= k:
        return order[:k]
    return torch.cat([order, order.new_zeros(k - order.shape[0])])


def random_sample(draws, site, assigned, num, pos_fraction):
    """RandomSampler with the reference's semantics at static shapes.

    Above quota a class draws WITH replacement and is then deduplicated
    and sorted, so the realised count can fall below the quota; the
    negative quota is `num` less the deduplicated positive count.  Below
    quota every candidate is taken in ascending index order.  `site`
    prefixes the two draws' names (+ ("pos",), + ("neg",)).

    Returns a SampleResult with P = round(num * pos_fraction), Q = num.
    """
    dev = assigned.device
    num_expected_pos = int(round(num * pos_fraction))
    is_pos = assigned > 0
    is_neg = assigned == 0
    n_pos = is_pos.sum()
    n_neg = is_neg.sum()
    n_all = assigned.shape[0]
    slots_p = torch.arange(num_expected_pos, device=dev)
    slots_n = torch.arange(num, device=dev)

    pos_order = _stable_order(is_pos)
    r = draws(site + ("pos",), num_expected_pos, n_pos.clamp(min=1))
    pos_draws = pos_order[r.clamp(0, n_all - 1)]
    pos_uniq, pos_uniq_mask, pos_uniq_cnt = _unique_compact(
        pos_draws, torch.ones_like(pos_draws, dtype=torch.bool), n_all)
    over = n_pos > num_expected_pos
    pos_inds = torch.where(over, pos_uniq, _take(pos_order, num_expected_pos))
    pos_mask = torch.where(over, pos_uniq_mask, slots_p < n_pos)
    pos_count = torch.where(over, pos_uniq_cnt, n_pos)

    num_expected_neg = num - pos_count
    neg_order = _stable_order(is_neg)
    # `num` draws, of which the first num_expected_neg stand for the
    # reference's draw of that size (an iid prefix is that draw)
    rn = draws(site + ("neg",), num, n_neg.clamp(min=1))
    neg_draws = neg_order[rn.clamp(0, n_all - 1)]
    neg_uniq, neg_uniq_mask, neg_uniq_cnt = _unique_compact(
        neg_draws, slots_n < num_expected_neg, n_all)
    over_n = n_neg > num_expected_neg
    under_cnt = torch.minimum(n_neg, num_expected_neg)
    neg_inds = torch.where(over_n, neg_uniq, _take(neg_order, num))
    neg_count = torch.where(over_n, neg_uniq_cnt, under_cnt)
    neg_mask = torch.where(over_n, neg_uniq_mask, slots_n < under_cnt)
    return SampleResult(pos_inds, pos_mask, neg_inds, neg_mask, pos_count,
                        neg_count)


def anchor_target_single(draws, site, anchors, inside, gt_boxes, gt_valid,
                         cfg, target_means, target_stds):
    """RPN anchor targets for one image over the flat multi-level anchors
    (reference anchor_target_single; positives get label 1).

    anchors (A, 6), inside (A,) bool; cfg: train_cfg.rpn.  Returns dict of
    labels (A,), label_weights (A,), bbox_targets (A, 6), bbox_weights
    (A, 6), num_pos, num_neg (0-d, at least 1).
    """
    a = anchors.shape[0]
    assigner, sampler = cfg["assigner"], cfg["sampler"]
    assigned, _, _ = max_iou_assign(
        anchors, inside, gt_boxes, gt_valid, assigner["pos_iou_thr"],
        assigner["neg_iou_thr"], assigner["min_pos_iou"])
    res = random_sample(draws, site, assigned, sampler["num"],
                        sampler["pos_fraction"])

    pos_gt = gt_boxes[(assigned[res.pos_inds] - 1).clamp(min=0)]
    pos_deltas = bbox2delta3d(anchors[res.pos_inds], pos_gt, target_means,
                              target_stds)
    pos_w = float(cfg.get("pos_weight", -1))
    pos_label_w = 1.0 if pos_w <= 0 else pos_w

    # masked-out slots scatter into a spare row a, dropped afterwards
    pos_at = torch.where(res.pos_mask, res.pos_inds, a)
    neg_at = torch.where(res.neg_mask, res.neg_inds, a)
    dev = anchors.device
    labels = torch.zeros(a + 1, dtype=torch.int64, device=dev)
    labels[pos_at] = 1
    label_weights = torch.zeros(a + 1, dtype=torch.float32, device=dev)
    label_weights[neg_at] = 1.0
    label_weights[pos_at] = pos_label_w
    bbox_targets = torch.zeros((a + 1, 6), dtype=torch.float32, device=dev)
    bbox_targets[pos_at] = pos_deltas
    bbox_weights = torch.zeros((a + 1, 6), dtype=torch.float32, device=dev)
    bbox_weights[pos_at] = 1.0
    return dict(
        labels=labels[:a], label_weights=label_weights[:a],
        bbox_targets=bbox_targets[:a], bbox_weights=bbox_weights[:a],
        num_pos=res.pos_count.clamp(min=1), num_neg=res.neg_count.clamp(min=1),
    )


class RcnnSample(NamedTuple):
    """The fixed-size R-CNN sample of an image (or, stacked, a batch).

    rois (R, 6) sampled boxes; roi_valid (R,) bool; is_pos (R,) bool;
    labels (R,) gt class of positives, 0 otherwise; gt_idx (R,) assigned
    gt of positives, 0 otherwise; bbox_targets (R, 6); bbox_weights
    (R, 6); pos_count / neg_count (at least 1).
    """

    rois: torch.Tensor
    roi_valid: torch.Tensor
    is_pos: torch.Tensor
    labels: torch.Tensor
    gt_idx: torch.Tensor
    bbox_targets: torch.Tensor
    bbox_weights: torch.Tensor
    pos_count: torch.Tensor
    neg_count: torch.Tensor


def stack_samples(samples):
    """Per-image RcnnSamples -> one with a leading batch dim."""
    return RcnnSample(*(torch.stack(xs) for xs in zip(*samples)))


def cat_samples(samples):
    """Batched RcnnSamples -> one, concatenated along the batch dim."""
    return RcnnSample(*(torch.cat(xs) for xs in zip(*samples)))


def sample_rcnn_single(draws, site, proposals, proposal_valid, gt_boxes,
                       gt_valid, gt_labels, cfg, target_means, target_stds,
                       add_gt_as_proposals=True):
    """Assign and sample proposals and build the R-CNN bbox targets of
    one image (RandomSampler).  The R = sampler.num slots hold the
    positives first (ascending), then the negatives, then padding; with
    `add_gt_as_proposals` the gt boxes lead the candidates and each is
    assigned to itself (reference base_sampler.py:110-126)."""
    sampler, assigner = cfg["sampler"], cfg["assigner"]
    num = sampler["num"]
    if add_gt_as_proposals:
        cand = torch.cat([gt_boxes.float(), proposals.float()])
        cand_valid = torch.cat([gt_valid, proposal_valid])
    else:
        cand, cand_valid = proposals.float(), proposal_valid
    assigned, _, _ = max_iou_assign(
        cand, cand_valid, gt_boxes, gt_valid, assigner["pos_iou_thr"],
        assigner["neg_iou_thr"], assigner["min_pos_iou"])
    if add_gt_as_proposals:
        g = gt_boxes.shape[0]
        self_assign = torch.arange(1, g + 1, device=cand.device)
        assigned = torch.cat([torch.where(gt_valid, self_assign, -1),
                              assigned[g:]])
    res = random_sample(draws, site, assigned, num, sampler["pos_fraction"])

    p = res.pos_inds.shape[0]
    all_inds = torch.cat([res.pos_inds, res.neg_inds])
    all_mask = torch.cat([res.pos_mask, res.neg_mask])
    pack = _stable_order(all_mask)[:num]
    inds = all_inds[pack]
    roi_valid = all_mask[pack]
    is_pos = (pack < p) & roi_valid

    rois = torch.where(roi_valid[:, None], cand[inds], 0.0)
    gt_idx = torch.where(is_pos, (assigned[inds] - 1).clamp(min=0), 0)
    labels = torch.where(is_pos, gt_labels[gt_idx].long(), 0)
    deltas = bbox2delta3d(rois, gt_boxes[gt_idx], target_means, target_stds)
    return RcnnSample(
        rois=rois, roi_valid=roi_valid, is_pos=is_pos, labels=labels,
        gt_idx=gt_idx,
        bbox_targets=torch.where(is_pos[:, None], deltas, 0.0),
        bbox_weights=is_pos[:, None].float().expand(-1, 6),
        pos_count=res.pos_count.clamp(min=1),
        neg_count=res.neg_count.clamp(min=1),
    )


def mask_target_single(pos_rois, pos_mask, pos_gt_idx, gt_masks, mask_size,
                       mask_size_depth):
    """Voxel mask targets of one image's positive rois.

    The reference crops the gt mask to the truncated box, resizes it
    linearly to (mask_size_depth, mask_size, mask_size), scales by 255,
    casts to uint8 and takes `> 0`: any sample with interpolated
    occupancy >= 1/255 is foreground.  Here: a trilinear sample of the
    binary mask at skimage's grid-centre coordinates, in matrix form
    (per-axis two-tap interpolation matrices, the roi's gt chosen by a
    one-hot folded into the z matrix), then the 1/255 threshold.

    pos_rois (P, 6); pos_mask (P,) bool; pos_gt_idx (P,); gt_masks
    (G, D, H, W) {0, 1}.  Returns (P, Dm, Hm, Wm) float32.
    """
    g, d, h, w = gt_masks.shape
    dev = pos_rois.device
    bbox = torch.floor(pos_rois.float()).to(torch.int32)
    x1, y1, z1 = bbox[:, 0], bbox[:, 1], bbox[:, 4]
    bw = (bbox[:, 2] - x1 + 1).clamp(min=1)
    bh = (bbox[:, 3] - y1 + 1).clamp(min=1)
    bd = (bbox[:, 5] - z1 + 1).clamp(min=1)

    def axis_matrix(start, extent, out, dim):
        # skimage.resize maps output i to input (i + .5) * scale - .5
        scale = extent.float() / out
        i = torch.arange(out, dtype=torch.float32, device=dev)
        c = start[:, None].float() + ((i[None, :] + 0.5) * scale[:, None]
                                      - 0.5)
        c = c.clamp(0.0, dim - 1.0)
        lo = torch.floor(c).to(torch.int32)
        hi = (lo + 1).clamp(max=dim - 1)
        frac = c - lo
        cols = torch.arange(dim, dtype=torch.int32, device=dev)
        return ((cols == lo[..., None]).float() * (1.0 - frac)[..., None]
                + (cols == hi[..., None]).float() * frac[..., None])

    mz = axis_matrix(z1, bd, mask_size_depth, d)  # (P, Dm, D)
    my = axis_matrix(y1, bh, mask_size, h)  # (P, Hm, H)
    mx = axis_matrix(x1, bw, mask_size, w)  # (P, Wm, W)
    onehot = (torch.arange(g, device=dev)[None, :]
              == pos_gt_idx[:, None]).float()  # (P, G)
    mzg = torch.einsum("pg,pzd->pzgd", onehot, mz)
    acc = torch.einsum("gdhw,pzgd->pzhw", gt_masks.float(), mzg)
    acc = torch.einsum("pzhw,pyh->pzyw", acc, my)
    acc = torch.einsum("pzyw,pxw->pzyx", acc, mx)
    targets = (acc >= 1.0 / 255.0).float()
    return torch.where(pos_mask[:, None, None, None], targets, 0.0)
