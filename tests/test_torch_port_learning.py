"""What the learning protocol's mask gap is not (ROADMAP Queue C 6).

After the pinned protocol the port's masks score below the JAX
package's (PERF.md).  These tests hold two suspects against the JAX
package on the CPU:

- the samplers' draw source: the port draws from `TorchDraws`, the JAX
  package from a key per step.  Over many draws the R-CNN sampler's
  samples must have the same distribution under both;
- the train step at the protocol's geometry: a 64x64x48 crop of the
  pinned generator's 256x256x48 volumes and its 96x96x72 twin, the
  flagship's full training budgets, narrow widths.  The gradients of the
  heads (the mask heads above all) must equal JAX's from the same
  weights, crops and replayed draws.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from chip_smoke import small_config
from mrcnn3d.core import targets as jt
from mrcnn3d.data.coco3d import Coco3D2ScalesDataset as JDataset
from mrcnn3d.detectors import pipeline as jpl
from mrcnn3d.detectors.build import anchor_cfgs as j_anchor_cfgs
from mrcnn3d.detectors.build import build_detector as j_build
from mrcnn3d.utils.config import Config as JConfig
from mrcnn3d_torch.compat.jax_weights import state_dict_from_jax
from mrcnn3d_torch.core import targets as tt
from mrcnn3d_torch.data.synthetic import make_synthetic_coco3d
from mrcnn3d_torch.detectors.build import build_detector
from mrcnn3d_torch.detectors.pipeline import forward_train
from mrcnn3d_torch.train.step import create_train_state
from test_torch_port_models import narrow_cfg
from test_torch_port_targets import _assigned, forward_train_draws
from torch_port_fixtures import torch_threads  # noqa: F401

TRIALS = 400
# the R-CNN sampler of the flagship config
NUM, POS_FRACTION = 512, 0.25
# gradients, port against JAX, relative to each parameter's largest:
# the heads downstream of the aligns only see forward features, which
# agree to float32 rounding; the neck and the bbox head's first layer see
# the backbone's ReLU and max-pool ties, which route a few gradients
# differently on either side
GRAD_TOL = {"mask_head": 1e-4, "refinement_mask_head": 1e-4,
            "rpn_head": 1e-4, "rpn_head_2": 1e-4, "refinement_head": 1e-4,
            "bbox_head": 1e-2, "neck": 1e-2}


def _counts_and_inclusion(pos_inds, pos_mask, neg_mask, n):
    """Per trial, the positive and negative counts; per candidate, the
    share of trials that sampled it as a positive."""
    inc = np.zeros(n)
    for inds, mask in zip(pos_inds, pos_mask):
        inc[inds[mask]] += 1
    return (pos_mask.sum(1), neg_mask.sum(1), inc / len(pos_inds))


def test_torch_draws_sample_as_jax_keys():
    """Above quota the sampler draws with replacement and deduplicates:
    the realised counts and each positive's chance to be taken follow
    from the draws alone.  The port's TorchDraws and the JAX package's
    keys must give the same distribution (means within 4 standard errors
    of each other and of the closed form)."""
    rng = np.random.RandomState(4)
    n, n_pos, n_neg = 2000, 300, 1200
    assigned = _assigned(rng, n, n_pos, n_neg)
    keys = jax.random.split(jax.random.PRNGKey(11), TRIALS)
    sample = jax.jit(jax.vmap(
        lambda k: jt.random_sample(k, jnp.asarray(assigned), NUM,
                                   POS_FRACTION)))
    j = sample(keys)
    want = _counts_and_inclusion(np.asarray(j.pos_inds),
                                 np.asarray(j.pos_mask),
                                 np.asarray(j.neg_mask), n)
    draws = tt.TorchDraws(torch.Generator().manual_seed(11))
    t = [tt.random_sample(draws, (), torch.from_numpy(assigned), NUM,
                          POS_FRACTION) for _ in range(TRIALS)]
    got = _counts_and_inclusion(
        np.stack([s.pos_inds.numpy() for s in t]),
        np.stack([s.pos_mask.numpy() for s in t]),
        np.stack([s.neg_mask.numpy() for s in t]), n)

    quota = int(round(NUM * POS_FRACTION))
    p_take = 1.0 - (1.0 - 1.0 / n_pos) ** quota
    for what, w, g in (("positives", want[0], got[0]),
                       ("negatives", want[1], got[1])):
        se = np.hypot(w.std(), g.std()) / np.sqrt(TRIALS)
        assert abs(w.mean() - g.mean()) <= 4 * se, (what, w.mean(), g.mean())
    for counts in (want[0], got[0]):
        se = counts.std() / np.sqrt(TRIALS)
        assert abs(counts.mean() - n_pos * p_take) <= 4 * se
    pos = assigned > 0
    se_take = np.sqrt(p_take * (1 - p_take) / TRIALS)
    for inc in (want[2], got[2]):
        assert (inc[~pos] == 0).all()
        # each positive's share of trials: no candidate favoured
        assert np.abs(inc[pos] - p_take).max() <= 5 * se_take
        assert abs(inc[pos].mean() - p_take) <= 4 * se_take / np.sqrt(n_pos)


def test_head_gradients_match_jax_at_the_learning_geometry(tmp_path):
    tcfg = small_config()
    jcfg = narrow_cfg(JConfig)
    ann, img = make_synthetic_coco3d(str(tmp_path), num_volumes=2, hw=256,
                                     depth=48, seed=123)
    tr = tcfg.data["train"]
    ds = JDataset(ann, img, img_norm_cfg=tr["img_norm_cfg"], max_gt=16,
                  extra_aug=tr["extra_aug"], seed=3)
    sample = ds[0]
    shapes = [sample["imgs"].shape[:3], sample["imgs_2"].shape[:3]]
    assert int(sample["gt_valid"].sum()) > 0, "no gt in the crop"
    assert shapes == [(48, 64, 64), (72, 96, 96)]

    jmodel = j_build(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 32, 32, 3)))
    sets = []
    for (d, h, w), ac in zip(shapes, j_anchor_cfgs(jcfg)):
        feats = jax.eval_shape(
            lambda x: jmodel.apply(variables, x, method=jmodel.extract_feat),
            jnp.zeros((1, d, h, w, 3)))
        sets.append(jpl.build_anchor_set(
            [f.shape[1:4] for f in feats], (h, w, 3, d), ac))

    def loss_fn(params, batch, rng):
        return jpl.forward_train(
            jmodel, {"params": params,
                     "batch_stats": variables["batch_stats"]},
            batch, rng, jcfg, sets)

    rng = jax.random.PRNGKey(1)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], {n: jnp.asarray(v[None])
                              for n, v in sample.items()}, rng)
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})

    model = build_detector(tcfg, device="cpu", train=True)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables)), strict=True)
    state = create_train_state(model, tcfg)
    tb = {n: torch.from_numpy(np.ascontiguousarray(v[None]))
          for n, v in sample.items()}
    for n in ("imgs", "imgs_2"):
        tb[n] = tb[n].permute(0, 4, 1, 2, 3)
    total, losses = forward_train(
        model, tb, tcfg, state.anchor_sets([tb["imgs"].shape[2:],
                                            tb["imgs_2"].shape[2:]]),
        forward_train_draws(rng, 1))
    total.backward()
    for name in ("loss_mask", "loss_mask_refinement"):
        assert abs(float(losses[name]) - float(jlosses[name])) <= 1e-5
    for name, p in model.named_parameters():
        tol = GRAD_TOL.get(name.split(".")[0])
        if tol is None:
            continue
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= tol * scale, (name, err, scale)
