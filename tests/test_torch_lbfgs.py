"""The port's L-BFGS update against the JAX package's and torch.optim.LBFGS.

* In float64, from the same start, 40 steps of a Rosenbrock-like problem
  with a box clamp between steps (as the solver clamps): the port on torch
  tensors and the JAX package's numpy loop give the same trajectory to
  1e-10 (the same operations; only the dot products' summation order may
  differ), with a history of 100 and of 3 (the history's truncation).
* Against ``torch.optim.LBFGS(lr, max_iter=1, history_size=10)`` driven by
  a closure once a step, on the JAX suite's problem, without a clamp
  (torch knows none): in float64 to 1e-10, in float32 to the JAX suite's
  bounds (atol 1e-4, rtol 1e-3, tests/test_optim.py).  torch keeps its
  recursion's scalars as tensors of the params' dtype, the port (and the
  JAX package) as Python floats, so float32 parts in the last bits.
"""

import numpy as np
import pytest
import torch

from aware_tpu.embed import lbfgs as jl
from aware_tpu_torch.embed import lbfgs as tl

STEPS = 40
LOWER = np.array([-0.2, -0.6, 0.1, -1.0, -1.0])
UPPER = np.array([1.1, 0.9, 0.9, 1.0, 0.45])
P0 = np.array([0.3, -0.5, 0.8, 0.2, -0.4])


def _loss(p):
    return ((p[0] - 1.3) ** 2 + 3.0 * (p[1] - p[0] ** 2) ** 2 + 0.1 * p[2] ** 2
            + (p[3] - 0.5 * p[4]) ** 2 + 0.5 * (p[4] - 0.7) ** 4)


def _grad(p):
    g = np.zeros_like(p)
    g[0] = 2 * (p[0] - 1.3) - 12.0 * p[0] * (p[1] - p[0] ** 2)
    g[1] = 6.0 * (p[1] - p[0] ** 2)
    g[2] = 0.2 * p[2]
    g[3] = 2 * (p[3] - 0.5 * p[4])
    g[4] = -(p[3] - 0.5 * p[4]) + 2.0 * (p[4] - 0.7) ** 3
    return g


@pytest.mark.parametrize("history, lr", [(100, 1.0), (3, 0.5), (100, 0.1)])
def test_update_matches_jax_in_float64_with_a_clamp(history, lr):
    mem_t, mem_j = tl.LBFGSMemory(history_size=history), jl.LBFGSMemory(history_size=history)
    p_t, p_j = torch.from_numpy(P0.copy()), P0.copy()
    lo, hi = torch.from_numpy(LOWER), torch.from_numpy(UPPER)
    clamped = 0
    for step in range(STEPS):
        p_t = torch.clamp(tl.lbfgs_update(mem_t, p_t, torch.from_numpy(_grad(p_t.numpy())), lr),
                          lo, hi)
        p_j = np.clip(jl.lbfgs_update(mem_j, p_j, _grad(p_j), lr), LOWER, UPPER)
        clamped += int(np.any((p_j == LOWER) | (p_j == UPPER)))
        np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-10, atol=1e-10,
                                   err_msg=f"step {step}")
        assert mem_t.n_iter == mem_j.n_iter and len(mem_t.old_dirs) == len(mem_j.old_dirs)
        assert mem_t.t == pytest.approx(mem_j.t, rel=1e-10)
        assert mem_t.h_diag == pytest.approx(mem_j.h_diag, rel=1e-10)
    assert clamped > 0  # the box bit, so the recorded step ignored the clamp
    assert len(mem_t.old_dirs) <= history


def _loss3(p):  # the JAX suite's problem (tests/test_optim.py)
    return (p[0] - 1.3) ** 2 + 3.0 * (p[1] - p[0] ** 2) ** 2 + 0.1 * p[2] ** 2


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float64, 1e-10, 1e-10),
                                              (torch.float32, 1e-4, 1e-3)])
@pytest.mark.parametrize("lr", [0.5, 1.0])
def test_update_matches_torch_optim_lbfgs(dtype, atol, rtol, lr):
    p0 = [0.3, -0.5, 0.8]
    tp = torch.tensor(p0, dtype=dtype, requires_grad=True)
    opt = torch.optim.LBFGS([tp], lr=lr, max_iter=1, history_size=10)

    def closure():
        opt.zero_grad()
        loss = _loss3(tp)
        loss.backward()
        return loss

    mem = tl.LBFGSMemory(history_size=10)
    p = torch.tensor(p0, dtype=dtype)
    for step in range(30):
        opt.step(closure)
        q = p.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(_loss3(q), q)
        p = tl.lbfgs_update(mem, p, g, lr)
        np.testing.assert_allclose(p.numpy(), tp.detach().numpy(), atol=atol, rtol=rtol,
                                   err_msg=f"step {step}")


def test_first_step_and_a_flat_gradient():
    """The first step is min(1, 1 / sum|g|) * lr along -g; a gradient under
    torch's tolerance returns the params and leaves the state untouched."""
    mem = tl.LBFGSMemory()
    p = torch.zeros(4, dtype=torch.float64)
    g = torch.tensor([0.5, -1.0, 2.0, 0.0], dtype=torch.float64)
    out = tl.lbfgs_update(mem, p, g, 0.3)
    torch.testing.assert_close(out, -g * (0.3 / 3.5), rtol=1e-15, atol=0)
    assert mem.n_iter == 1 and mem.t == pytest.approx(0.3 / 3.5)
    same = tl.lbfgs_update(mem, out, torch.full((4,), 1e-8, dtype=torch.float64), 0.3)
    assert same is out and mem.n_iter == 1
