"""The port's schedulers against the JAX package's: 1000 ticks per clip.

Per-clip state (B = 3 clips, each with its own base lr and losses) against
the JAX scheduler run on each clip alone (one ``vmap`` lane of its
solver), every tick's lr to 1 float32 ulp: both evaluate the JAX
package's closed forms in float32 tensors, with the same operations.
Where a schedule goes through cos, the ulp is that of the clip's base lr
(the scale of (1 + cos) / 2): torch's and XLA's float32 cos differ by 1
ulp of cos on some arguments, which is many ulps of an lr near its
minimum.  The parameters include the chip check's (``chip_smoke.py``
phase 9).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu.embed import schedulers as js
from aware_tpu_torch.embed import schedulers as ts

TICKS = 1000
BASE = np.array([0.1, 0.05, 1.0], np.float32)

CASES = [
    ("cosine_annealing", {"T_max": 400}),
    ("cosine_annealing", {"T_max": 37, "eta_min": 0.001}),
    ("cosine_annealing_warm_restarts", {"T_0": 50, "T_mult": 2}),
    ("cosine_annealing_warm_restarts", {"T_0": 7, "T_mult": 3, "eta_min": 1e-3}),
    ("cosine_annealing_warm_restarts", {"T_0": 30}),
    ("step", {"step_size": 100, "gamma": 0.5}),
    ("step", {"step_size": 7, "gamma": 0.9}),
    ("multi_step", {"milestones": [100, 250], "gamma": 0.5}),
    ("multi_step", {"milestones": [300, 5, 12], "gamma": 0.3}),
    ("exponential", {"gamma": 0.995}),
    ("cyclic", {"base_lr": 0.01, "max_lr": 0.1, "step_size_up": 100, "mode": "triangular2"}),
    ("cyclic", {"base_lr": 0.01, "max_lr": 0.1, "step_size_up": 60, "step_size_down": 25}),
    ("cyclic", {"base_lr": 0.001, "max_lr": 0.05, "step_size_up": 40, "mode": "exp_range",
                "gamma": 0.999}),
    ("reduce_lr_on_plateau", {"factor": 0.5, "patience": 20, "cooldown": 5}),
]


def _id(case):
    name, kwargs = case
    return name + "".join(f"-{k}" for k in kwargs)


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_schedule_matches_jax_to_one_ulp(case):
    name, kwargs = case
    rng = np.random.default_rng(len(_id(case)))
    # falling, then flat losses: the plateau machine reduces on the flat part
    losses = np.cumsum(rng.uniform(-0.02, 0.01, (TICKS, 3)), axis=0).astype(np.float32)
    losses[TICKS // 3 :] = losses[TICKS // 3]
    ours = ts.get_scheduler(name, **kwargs)
    s = ours.init(1.0, 3)
    s = {k: v * torch.from_numpy(BASE) if k in ("lr", "base") else v for k, v in s.items()}
    ref = js.get_scheduler(name, **kwargs)
    sj = [ref.init(float(b)) for b in BASE]
    got, want = [], []
    for row in losses:
        got.append(s["lr"].numpy().copy())
        want.append([np.float32(st["lr"]) for st in sj])
        s = ours.step(s, torch.from_numpy(row))
        sj = [ref.step(st, jnp.float32(v)) for st, v in zip(sj, row)]
    got, want = np.array(got), np.array(want, np.float32)
    assert got.dtype == np.float32 and got.shape == (TICKS, 3)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    within = ulps <= 1
    if "cosine" in name:
        within |= np.abs(got - want) <= np.spacing(BASE)[None, :]
    assert within.all(), (np.argwhere(~within)[:5], got[~within][:5], want[~within][:5])
    assert len(np.unique(got[:, 0])) > 1  # the schedule moved


def test_init_takes_the_base_lr_per_clip():
    s = ts.get_scheduler("cyclic", base_lr=0.01, max_lr=0.1, step_size_up=10).init(0.1, 2)
    # cyclic's first step runs at the optimizer's lr; the ticks take its own
    assert torch.equal(s["lr"], torch.full((2,), 0.1))
    s = ts.get_scheduler("cyclic", base_lr=0.01, max_lr=0.1, step_size_up=10).step(s, torch.ones(2))
    np.testing.assert_allclose(s["lr"].numpy(), [0.019, 0.019], rtol=1e-6)


def test_registry_matches_jax():
    assert list(ts.SCHEDULER_REGISTRY) == list(js.SCHEDULER_REGISTRY)
    with pytest.raises(ValueError, match="not found"):
        ts.get_scheduler("one_cycle")
