"""torch.optim.NAdam as a pure batched update.

The port of ``aware_tpu/embed/optim.py:43-78``: the same lerp-form moment
updates and mu-product recursion, so the trajectory follows torch's own
NAdam step for step.  ``lr`` may be a scalar or one value per clip (B,),
broadcast over the parameter's trailing dimensions.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple]


def nadam_schedule(step, mu_prod, b1: float, psi: float):
    """One step of NAdam's momentum schedule from the state before it:
    (t, mu_t, mu_next, mu_prod * mu_t), float32 tensors like ``step``."""
    t = step + 1.0
    mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * psi))
    mu_next = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1.0) * psi))
    return t, mu_t, mu_next, mu_prod * mu_t


def nadam(
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    momentum_decay: float = 4e-3,
) -> Optimizer:
    """torch.optim.NAdam (Dozat's Nesterov Adam with the mu-product
    momentum schedule)."""
    b1, b2 = betas
    psi = momentum_decay

    def init(p: torch.Tensor) -> dict:
        return {
            "step": torch.zeros((), device=p.device),
            "m": torch.zeros_like(p),
            "v": torch.zeros_like(p),
            "mu_prod": torch.ones((), device=p.device),
        }

    def update(g, s, p, lr):
        lr = torch.as_tensor(lr, dtype=p.dtype, device=p.device)
        lr = lr.reshape(lr.shape + (1,) * (p.ndim - lr.ndim))
        if weight_decay:
            g = g + weight_decay * p
        t, mu_t, mu_next, mu_prod = nadam_schedule(s["step"], s["mu_prod"], b1, psi)
        mu_prod_next = mu_prod * mu_next
        m = s["m"] + (1.0 - b1) * (g - s["m"])
        v = b2 * s["v"] + (1.0 - b2) * (g * g)
        denom = torch.sqrt(v / (1.0 - b2**t)) + eps
        p = p - lr * (1.0 - mu_t) / (1.0 - mu_prod) * g / denom
        p = p - lr * mu_next / (1.0 - mu_prod_next) * m / denom
        return p, {"step": t, "m": m, "v": v, "mu_prod": mu_prod}

    return Optimizer(init, update)
