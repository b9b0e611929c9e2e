"""The port's NAdam, plateau scheduler and loss against the JAX package.

20 steps from the same numpy gradients, to 1e-6 (both update in float32
with the same operation order; only the pow of the momentum schedule may
round differently in the last bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu.embed.losses import push_extremes as jax_push_extremes
from aware_tpu.embed.optim import nadam as jax_nadam
from aware_tpu.embed.schedulers import reduce_lr_on_plateau as jax_plateau
from aware_tpu_torch.embed.losses import push_extremes
from aware_tpu_torch.embed.optim import nadam
from aware_tpu_torch.embed.schedulers import reduce_lr_on_plateau

STEPS, TOL = 20, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kwargs", [{}, {"weight_decay": 0.01}, {"betas": (0.8, 0.99)},
                                    {"momentum_decay": 1e-2, "eps": 1e-6}])
def test_nadam_matches_jax_with_per_clip_lr(kwargs):
    rng = np.random.default_rng(len(kwargs))
    p0 = rng.standard_normal((3, 5, 4)).astype(np.float32)
    grads = rng.standard_normal((STEPS, 3, 5, 4)).astype(np.float32)
    lrs = np.array([0.1, 0.05, 0.2], np.float32)
    ours_opt, ref_opt = nadam(**kwargs), jax_nadam(**kwargs)

    p, s = torch.from_numpy(p0), None
    s = ours_opt.init(p)
    for g in grads:
        p, s = ours_opt.update(torch.from_numpy(g), s, p, torch.from_numpy(lrs))
    for i in range(3):  # the JAX optimizer runs one clip per vmap lane
        pj = jnp.asarray(p0[i])
        sj = ref_opt.init(pj)
        for g in grads:
            pj, sj = ref_opt.update(jnp.asarray(g[i]), sj, pj, jnp.float32(lrs[i]))
        np.testing.assert_allclose(p[i].numpy(), np.asarray(pj), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s["m"][i].numpy(), np.asarray(sj["m"]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s["v"][i].numpy(), np.asarray(sj["v"]), rtol=TOL, atol=TOL)
    assert float(s["step"]) == STEPS
    np.testing.assert_allclose(float(s["mu_prod"]), float(sj["mu_prod"]), rtol=TOL)


def test_nadam_matches_torch_optim():
    """The reference's own optimizer: torch.optim.NAdam on a leaf.  torch
    keeps its scalar schedule in float64 host floats, so the trajectories
    part at the ULP level; tests/test_optim.py allows the JAX package the
    same atol 5e-5 / rtol 2e-4 against it."""
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal(50).astype(np.float32)
    grads = rng.standard_normal((STEPS, 50)).astype(np.float32)
    leaf = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ref = torch.optim.NAdam([leaf], lr=0.1)
    opt = nadam()
    p = torch.from_numpy(p0)
    s = opt.init(p)
    for g in grads:
        leaf.grad = torch.from_numpy(g)
        ref.step()
        p, s = opt.update(torch.from_numpy(g), s, p, 0.1)
    np.testing.assert_allclose(p.numpy(), leaf.detach().numpy(), rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("kwargs", [
    {"factor": 0.9, "patience": 500},                      # the default card: a no-op
    {"factor": 0.5, "patience": 2},
    {"factor": 0.5, "patience": 1, "cooldown": 2, "min_lr": 0.02},
    {"factor": 0.7, "patience": 0, "threshold_mode": "abs", "threshold": 0.05},
])
def test_plateau_matches_jax_per_clip(kwargs):
    rng = np.random.default_rng(7)
    # a falling and then flat loss per clip, so that plateaus happen
    losses = np.cumsum(rng.uniform(-0.2, 0.05, (STEPS, 3)), axis=0).astype(np.float32)
    losses[STEPS // 2 :] = losses[STEPS // 2]
    ours, ref = reduce_lr_on_plateau(**kwargs), jax_plateau(**kwargs)
    s = ours.init(0.1, 3)
    sj = [ref.init(0.1) for _ in range(3)]
    for row in losses:
        s = ours.step(s, torch.from_numpy(row))
        sj = [ref.step(st, jnp.float32(v)) for st, v in zip(sj, row)]
        for key in ("lr", "best", "num_bad", "cooldown"):
            np.testing.assert_allclose(s[key].numpy(), [float(st[key]) for st in sj],
                                       rtol=TOL, atol=TOL)


def test_default_plateau_never_reduces_in_400_steps():
    sched = reduce_lr_on_plateau(factor=0.9, patience=500)
    s = sched.init(0.1, 2)
    for _ in range(400):
        s = sched.step(s, torch.ones(2))
    assert torch.all(s["lr"] == torch.tensor(0.1))


def test_push_extremes_matches_jax():
    rng = np.random.default_rng(3)
    pred = np.tanh(rng.standard_normal((4, 20))).astype(np.float32)
    target = (2 * rng.integers(0, 2, (4, 20)) - 1).astype(np.float32)
    ours = push_extremes(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    ref = [float(jax_push_extremes(jnp.asarray(p), jnp.asarray(t))) for p, t in zip(pred, target)]
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
