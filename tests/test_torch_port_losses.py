"""PyTorch port vs JAX: the weighted detection losses (`ops/losses.py`)
and the optimizer's schedule, on numpy inputs from a seed, within 1e-6
(float32 sums in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrcnn3d.ops import losses as jl
from mrcnn3d.train.optim import step_lr_schedule as j_schedule
from mrcnn3d_torch.ops import losses as tl
from mrcnn3d_torch.train.optim import step_lr_schedule

TOL = 1e-6


def _inputs(seed):
    rng = np.random.RandomState(seed)
    n, c = 96, 3
    logits = (rng.randn(n, c) * 4).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    weight = np.where(rng.rand(n) > 0.3, rng.choice([1.0, 3.0], n),
                      0.0).astype(np.float32)
    pred = rng.randn(n, 6).astype(np.float32)
    target = (pred + rng.randn(n, 6) * 0.3).astype(np.float32)
    w6 = (rng.rand(n, 6) > 0.5).astype(np.float32)
    mpred = (rng.randn(n // 8, c, 4, 6, 6) * 3).astype(np.float32)
    mtarget = (rng.rand(n // 8, 4, 6, 6) > 0.5).astype(np.float32)
    mlabel = rng.randint(0, c, n // 8).astype(np.int32)
    mvalid = rng.rand(n // 8) > 0.3
    return dict(logits=logits, labels=labels, weight=weight, pred=pred,
                target=target, w6=w6, mpred=mpred, mtarget=mtarget,
                mlabel=mlabel, mvalid=mvalid, avg=np.float32(37.0),
                blogits=(rng.randn(n) * 5).astype(np.float32),
                blabels=rng.randint(0, 2, n).astype(np.int32))


CASES = {
    "cross_entropy": lambda m, x: m.weighted_cross_entropy(
        x["logits"], x["labels"], x["weight"], x["avg"]),
    "binary_cross_entropy": lambda m, x: m.weighted_binary_cross_entropy(
        x["blogits"], x["blabels"], x["weight"], x["avg"]),
    "smooth_l1": lambda m, x: m.smooth_l1(x["pred"], x["target"], 1.0 / 9),
    "weighted_smoothl1": lambda m, x: m.weighted_smoothl1(
        x["pred"], x["target"], x["w6"], 1.0, x["avg"]),
    "mask_cross_entropy": lambda m, x: m.mask_cross_entropy(
        x["mpred"], x["mtarget"], x["mlabel"], x["mvalid"]),
    "mask_cross_entropy_no_valid": lambda m, x: m.mask_cross_entropy(
        x["mpred"], x["mtarget"], x["mlabel"]),
    "accuracy": lambda m, x: m.accuracy(x["logits"], x["labels"],
                                        x["weight"] > 0),
    "accuracy_no_valid": lambda m, x: m.accuracy(x["logits"], x["labels"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case):
    x = _inputs(0)
    want = np.asarray(CASES[case](jl, {k: jnp.asarray(v)
                                       for k, v in x.items()}))
    got = CASES[case](tl, {k: torch.as_tensor(v) for k, v in x.items()})
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(want).sum() > 0


def test_mask_cross_entropy_all_invalid_is_zero():
    x = _inputs(1)
    got = tl.mask_cross_entropy(torch.from_numpy(x["mpred"]),
                                torch.from_numpy(x["mtarget"]),
                                torch.from_numpy(x["mlabel"]),
                                torch.zeros(len(x["mlabel"]), dtype=bool))
    assert float(got) == 0.0


def test_bce_stable_at_large_logits():
    logits = torch.tensor([-200.0, -30.0, 0.0, 30.0, 200.0])
    labels = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0])
    got = tl._bce_with_logits(logits, labels)
    want = np.asarray(jl._bce_with_logits(jnp.asarray(logits.numpy()),
                                          jnp.asarray(labels.numpy())))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["binary_cross_entropy",
                                  "mask_cross_entropy"])
def test_bce_gradient_at_zero_logits_matches_jax(case):
    """Logits exactly 0 (a head's last layer on all-zero features, its
    bias still 0: every first step from zero biases) among others: the
    gradient equals jax.grad's, -y at 0 (torch's clamp and abs slopes
    gave 1 - y there; ROADMAP Queue C 5)."""
    import jax

    x = _inputs(2)
    x["blogits"][::3] = 0.0
    x["mpred"][:, :, ::2] = 0.0
    key = "blogits" if case == "binary_cross_entropy" else "mpred"

    def jloss(v):
        return CASES[case](jl, {**{k: jnp.asarray(a) for k, a in x.items()},
                                key: v})

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x[key])))
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    t[key] = t[key].clone().requires_grad_(True)
    CASES[case](tl, t).backward()
    got = t[key].grad.numpy()
    zero = x[key] == 0
    assert zero.sum() > 10 and np.abs(want[zero]).max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("steps", [[], [2, 3]])
def test_schedule_matches_optax(steps):
    """Warmup over 10 iterations from a third of the rate, then the step
    policy at epochs 2 and 3 (5 iterations an epoch)."""
    want = j_schedule(1e-3, steps, 5, 10, 1.0 / 3)
    got = step_lr_schedule(1e-3, steps, 5, 10, 1.0 / 3)
    for count in range(0, 22):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, err_msg=str(count))
