"""Embedding objectives: the seven losses of the card schema.

The port of ``aware_tpu/embed/losses.py``, batched: predictions and
targets are (B, n_bits) and each loss is one value per clip, (B,).  The
default card's is ``push_extremes``.

Kept as in the JAX package, where its autodiff decides the gradient:
``hinge``, ``sign`` and ``bce`` take ``_maximum``, torch.maximum's value
with ``jnp.maximum``'s gradient (half to each side at a tie, where a clamp
or relu gives it whole to one side; none to a NaN, where torch.maximum
passes it on); ``bce`` takes the log of the detector's tanh outputs,
negative ones included, so its value is NaN there, as in JAX; ``ber`` is a count of sign mismatches with no gradient
graph at all (JAX's gradient there is exactly 0).  ``push_extremes`` and
``push_sigmoid`` take |x| as ``_abs``, whose gradient at 0 is 1, as
``jnp.abs``'s is (torch's ``abs`` gives 0 there); the same floats
elsewhere.
"""

from __future__ import annotations

from typing import Callable

import torch

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class _Maximum(torch.autograd.Function):
    """torch.maximum with lax.max's gradient: each side gets g where it
    equals the result, g / 2 if both do, else 0."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.maximum(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        x_on, y_on = x == out, y == out
        share = torch.where(x_on & y_on, 0.5, 1.0)
        return (g * torch.where(x_on, share, 0.0), g * torch.where(y_on, share, 0.0))


def _maximum(x: torch.Tensor, floor: float) -> torch.Tensor:
    return _Maximum.apply(x, torch.full_like(x, floor))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: 1 at x == 0."""
    return torch.where(x >= 0, x, -x)


def hinge(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean(max(0, 1 - p*t)) per clip."""
    return _maximum(1.0 - predicted * target, 0.0).mean(dim=-1)


def mse(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((predicted - target) ** 2).mean(dim=-1)


def push_extremes(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE minus a reward for confident (large-|p|) outputs, per clip."""
    return mse(predicted, target) - 0.1 * _abs(predicted).mean(dim=-1)


def push_sigmoid(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The push-from-0.5 variant for sigmoid readouts, per clip."""
    return mse(predicted, target) - 0.1 * _abs(predicted - 0.5).mean(dim=-1)


def sign_loss(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean(max(0, -p*t)) per clip: sign agreement only."""
    return _maximum(-predicted * target, 0.0).mean(dim=-1)


def bce(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities with torch's log clamp at -100
    (F.binary_cross_entropy's), per clip; NaN where p is outside [0, 1]."""
    logp = _maximum(torch.log(predicted), -100.0)
    log1mp = _maximum(torch.log(1.0 - predicted), -100.0)
    return -(target * logp + (1.0 - target) * log1mp).mean(dim=-1)


def ber_loss(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The hard sign-mismatch rate per clip: no gradient graph."""
    return (torch.sign(predicted) != torch.sign(target)).to(predicted.dtype).mean(dim=-1)


LOSS_REGISTRY: dict[str, LossFn] = {
    "hinge": hinge,
    "mse": mse,
    "push_extremes": push_extremes,
    "push_sigmoid": push_sigmoid,
    "sign": sign_loss,
    "bce": bce,
    "ber": ber_loss,
}


def get_loss_fn(loss_type: str) -> LossFn:
    if loss_type not in LOSS_REGISTRY:
        raise ValueError(f"Unknown loss type: {loss_type}. Available: {list(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[loss_type]
