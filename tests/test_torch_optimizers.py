"""The port's optimizers against the JAX package's and against torch.optim.

* 50 steps from the same numpy gradients with a per-clip lr (B = 3), each
  clip against the JAX optimizer run on that clip alone (one ``vmap`` lane
  of its solver), to rtol 1e-5: both update in float32 with the same
  operations; only the pow of the bias corrections may round differently.
* 50 steps on one clip against torch.optim's own optimizer of that name
  (the reference's), to the JAX suite's bounds against it (atol 5e-5, rtol
  2e-4, tests/test_optim.py): torch keeps some scalar state in float64.
* The registry: its names are the JAX package's, ``sparse_adam`` is Adam,
  ``lbfgs`` a marker, ``get_optimizer`` drops ``lr``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aware_tpu.embed import optim as jo
from aware_tpu_torch.embed import optim as to

STEPS, TOL = 50, 1e-5

CASES = [
    ("adam", {}), ("adam", {"weight_decay": 0.01}), ("adam", {"betas": (0.8, 0.99)}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1, "eps": 1e-6}),
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {"momentum": 0.8, "dampening": 0.1, "weight_decay": 1e-3}),
    ("rmsprop", {}), ("rmsprop", {"momentum": 0.9}), ("rmsprop", {"centered": True}),
    ("rmsprop", {"centered": True, "momentum": 0.5, "weight_decay": 1e-3, "alpha": 0.9}),
    ("adagrad", {}), ("adagrad", {"lr_decay": 0.01, "initial_accumulator_value": 0.1}),
    ("adagrad", {"weight_decay": 1e-3}),
    ("adadelta", {}), ("adadelta", {"rho": 0.95, "weight_decay": 1e-3}),
    ("adamax", {}), ("adamax", {"weight_decay": 1e-3, "betas": (0.8, 0.99)}),
    ("sparse_adam", {}), ("nadam", {"weight_decay": 1e-4}),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _id(case):
    name, kwargs = case
    return name + "".join(f"-{k}" for k in kwargs)


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_trajectory_matches_jax_with_per_clip_lr(case):
    name, kwargs = case
    rng = np.random.default_rng(len(_id(case)))
    p0 = rng.standard_normal((3, 6, 4)).astype(np.float32)
    grads = rng.standard_normal((STEPS, 3, 6, 4)).astype(np.float32)
    lrs = np.array([0.1, 0.03, 0.2], np.float32)
    opt = to.get_optimizer(name, lr=0.1, **kwargs)
    ref = jo.get_optimizer(name, lr=0.1, **kwargs)

    p = torch.from_numpy(p0)
    s = opt.init(p)
    traj = []
    for g in grads:
        p, s = opt.update(torch.from_numpy(g), s, p, torch.from_numpy(lrs))
        traj.append(p)
    for i in range(3):
        pj = jnp.asarray(p0[i])
        sj = ref.init(pj)
        for t, g in enumerate(grads):
            pj, sj = ref.update(jnp.asarray(g[i]), sj, pj, jnp.float32(lrs[i]))
            np.testing.assert_allclose(traj[t][i].numpy(), np.asarray(pj), rtol=TOL, atol=TOL,
                                       err_msg=f"clip {i}, step {t}")
        for key, value in s.items():
            if value.ndim:  # the per-element state; the counters are shared scalars
                np.testing.assert_allclose(value[i].numpy(), np.asarray(sj[key]), rtol=TOL,
                                           atol=TOL, err_msg=key)
            else:
                assert float(value) == pytest.approx(float(sj[key]), rel=TOL)


TORCH_OPTIM = {
    "adam": torch.optim.Adam, "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD,
    "rmsprop": torch.optim.RMSprop, "adagrad": torch.optim.Adagrad,
    "adadelta": torch.optim.Adadelta, "adamax": torch.optim.Adamax, "nadam": torch.optim.NAdam,
}


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in TORCH_OPTIM],
                         ids=[_id(c) for c in CASES if c[0] in TORCH_OPTIM])
def test_trajectory_matches_torch_optim_on_one_clip(case):
    name, kwargs = case
    rng = np.random.default_rng(100 + len(_id(case)))
    p0 = rng.standard_normal(40).astype(np.float32)
    grads = rng.standard_normal((STEPS, 40)).astype(np.float32)
    lr = 0.05
    leaf = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ref = TORCH_OPTIM[name]([leaf], lr=lr, **kwargs)
    opt = to.get_optimizer(name, **kwargs)
    p = torch.from_numpy(p0)
    s = opt.init(p)
    for t, g in enumerate(grads):
        leaf.grad = torch.from_numpy(g)
        ref.step()
        p, s = opt.update(torch.from_numpy(g), s, p, lr)
        np.testing.assert_allclose(p.numpy(), leaf.detach().numpy(), atol=5e-5, rtol=2e-4,
                                   err_msg=f"{name} parted from torch.optim at step {t}")


def test_registry_matches_jax():
    assert list(to.OPTIMIZER_REGISTRY) == list(jo.OPTIMIZER_REGISTRY)
    marker = to.get_optimizer("lbfgs", lr=1.0, history_size=7)
    assert isinstance(marker, to.LBFGSMarker) and marker.history_size == 7
    assert to.OPTIMIZER_REGISTRY["sparse_adam"] is to.adam
    with pytest.raises(ValueError, match="not found"):
        to.get_optimizer("lion")
    with pytest.raises(TypeError):
        to.get_optimizer("adam", momentum=0.9)  # Adam has no momentum parameter
