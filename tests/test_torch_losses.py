"""The port's seven losses against the JAX package's, value and gradient.

Per clip: the port maps (B, n_bits) to (B,), the JAX loss runs one clip
(under ``vmap`` in its solver).  Both compute in float32 with the same
operations, so values and gradients agree to rtol 1e-6; NaN where JAX has
NaN (``bce`` of tanh outputs, and its gradient at p = 0 or 1), and at
exact ties the gradient split of ``jnp.maximum`` (0.5 / 0.5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aware_tpu.embed import losses as jl
from aware_tpu_torch.embed import losses as tl

TOL = 1e-6
B, N_BITS = 4, 20


def _inputs(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    bipolar = (2 * rng.integers(0, 2, (B, N_BITS)) - 1).astype(np.float32)
    if kind == "tanh":  # the detector's outputs and the solver's targets
        return np.tanh(rng.standard_normal((B, N_BITS))).astype(np.float32), bipolar
    if kind == "prob":  # probabilities against {0, 1} targets
        p = 1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, N_BITS))))
        return p.astype(np.float32), (bipolar > 0).astype(np.float32)
    # exact ties: p * t == 1 (hinge's kink), p == 0 (sign's kink, and sign(0)
    # for ber), p at 0 and 1 (bce's log at 0: its clamp and a NaN gradient)
    p = np.tanh(rng.standard_normal((B, N_BITS))).astype(np.float32)
    p[:, 0:4] = bipolar[:, 0:4]
    p[:, 4:8] = 0.0
    p[:, 8:10] = 1.0
    p[:, 10:12] = -bipolar[:, 10:12]
    return p, bipolar


def _jax_value_and_grad(name, pred, target):
    fn = jl.get_loss_fn(name)
    value = jax.vmap(fn)(jnp.asarray(pred), jnp.asarray(target))
    grad = jax.vmap(jax.grad(fn))(jnp.asarray(pred), jnp.asarray(target))
    return np.asarray(value), np.asarray(grad)


@pytest.mark.parametrize("kind", ["tanh", "prob", "ties"])
@pytest.mark.parametrize("name", sorted(jl.LOSS_REGISTRY))
def test_loss_value_and_gradient_match_jax(name, kind):
    pred, target = _inputs(kind, seed=len(name) + len(kind))
    ref_value, ref_grad = _jax_value_and_grad(name, pred, target)
    p = torch.from_numpy(pred).requires_grad_(True)
    value = tl.get_loss_fn(name)(p, torch.from_numpy(target))
    assert value.shape == (B,) and value.dtype == torch.float32
    np.testing.assert_allclose(value.detach().numpy(), ref_value, rtol=TOL, atol=TOL)
    if name == "ber":
        # no gradient graph in torch; JAX's gradient is exactly 0
        assert not value.requires_grad and np.all(ref_grad == 0.0)
        return
    (grad,) = torch.autograd.grad(value.sum(), p)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=TOL, atol=TOL)


def test_bce_of_tanh_outputs_is_nan_as_in_jax():
    """The detector's tanh outputs are negative on some bits, so ``bce``
    takes the log of a negative: NaN in both packages, on each clip."""
    pred, target = _inputs("tanh", seed=5)
    ref_value, _ = _jax_value_and_grad("bce", pred, target)
    value = tl.bce(torch.from_numpy(pred), torch.from_numpy(target))
    assert np.all(np.isnan(ref_value)) and torch.isnan(value).all()


@pytest.mark.parametrize("name, want", [("hinge", 0.5), ("sign", 0.5)])
def test_maximum_splits_a_tie(name, want):
    """At max(x, 0) with x == 0, the gradient to x is one half, as
    jnp.maximum's; a clamp or relu would give 0 or 1."""
    t = torch.ones(1, 2)
    p = torch.tensor([[1.0, 0.0]]) if name == "hinge" else torch.tensor([[0.0, 0.0]])
    p.requires_grad_(True)
    (g,) = torch.autograd.grad(tl.get_loss_fn(name)(p, t).sum(), p)
    ref = jax.grad(jl.get_loss_fn(name))(jnp.asarray(p.detach().numpy()[0]), jnp.ones(2))
    np.testing.assert_array_equal(g.numpy()[0], np.asarray(ref))
    assert abs(float(g[0, 0])) == pytest.approx(want / 2)  # over the mean of 2 bits


def test_registry_and_unknown_name():
    assert list(tl.LOSS_REGISTRY) == list(jl.LOSS_REGISTRY)
    with pytest.raises(ValueError, match="Unknown loss type"):
        tl.get_loss_fn("focal")
