"""The card schema's optimizers as pure batched updates.

The port of ``aware_tpu/embed/optim.py``: each optimizer is a pair of
pure functions::

    init(params)                     -> state
    update(grad, state, params, lr)  -> (new_params, new_state)

with the JAX package's update formulas operation for operation, which
follow torch.optim's defaults step for step (the lerp-form moments,
Adam's ``sqrt(v) / sqrt(1 - b2^t)``, SGD seeding its buffer with the raw
gradient at t = 1, Adamax's ``max(b2 u, |g| + eps)``).  ``lr`` may be a
scalar or one value per clip (B,), broadcast over the parameter's
trailing dimensions; the step counters are float32 scalars, the same for
every clip.  ``sparse_adam`` is dense Adam (no sparse gradients here);
``lbfgs`` resolves to a marker, and the solver runs it as a host loop
(``embed/lbfgs.py``, ``solver.embed_lbfgs``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple]


def _per_clip(lr, p: torch.Tensor) -> torch.Tensor:
    """``lr`` as a tensor broadcast against p: a scalar, or (B,) over p's
    trailing dimensions."""
    lr = torch.as_tensor(lr, dtype=p.dtype, device=p.device)
    return lr.reshape(lr.shape + (1,) * (p.ndim - lr.ndim))


def _step(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), device=p.device)


# ---------------------------------------------------------------- NAdam ---

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
            "step": _step(p),
            "m": torch.zeros_like(p),
            "v": torch.zeros_like(p),
            "mu_prod": torch.ones((), device=p.device),
        }

    def update(g, s, p, lr):
        lr = _per_clip(lr, p)
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


# ----------------------------------------------------------------- Adam ---

def adam(
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    b1, b2 = betas

    def init(p: torch.Tensor) -> dict:
        return {"step": _step(p), "m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def update(g, s, p, lr):
        lr = _per_clip(lr, p)
        t = s["step"] + 1.0
        if weight_decay:
            g = g + weight_decay * p
        m = s["m"] + (1.0 - b1) * (g - s["m"])
        v = b2 * s["v"] + (1.0 - b2) * (g * g)
        denom = torch.sqrt(v) / torch.sqrt(1.0 - b2**t) + eps
        p = p - (lr / (1.0 - b1**t)) * m / denom
        return p, {"step": t, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
) -> Optimizer:
    base = adam(betas, eps, 0.0)

    def update(g, s, p, lr):
        p = p * (1.0 - _per_clip(lr, p) * weight_decay)  # decoupled decay
        return base.update(g, s, p, lr)

    return Optimizer(base.init, update)


# ------------------------------------------------------------------ SGD ---

def sgd(
    momentum: float = 0.0,
    dampening: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
) -> Optimizer:
    def init(p: torch.Tensor) -> dict:
        return {"buf": torch.zeros_like(p), "step": _step(p)}

    def update(g, s, p, lr):
        t = s["step"] + 1.0
        if weight_decay:
            g = g + weight_decay * p
        if momentum != 0.0:
            # torch seeds the buffer with the raw gradient on step 1
            buf = torch.where(t == 1.0, g, momentum * s["buf"] + (1.0 - dampening) * g)
            d = g + momentum * buf if nesterov else buf
        else:
            buf = s["buf"]
            d = g
        return p - _per_clip(lr, p) * d, {"buf": buf, "step": t}

    return Optimizer(init, update)


# -------------------------------------------------------------- RMSprop ---

def rmsprop(
    alpha: float = 0.99,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    centered: bool = False,
) -> Optimizer:
    def init(p: torch.Tensor) -> dict:
        return {"sq": torch.zeros_like(p), "gavg": torch.zeros_like(p),
                "buf": torch.zeros_like(p)}

    def update(g, s, p, lr):
        lr = _per_clip(lr, p)
        if weight_decay:
            g = g + weight_decay * p
        sq = alpha * s["sq"] + (1.0 - alpha) * g * g
        gavg = s["gavg"]
        if centered:
            gavg = alpha * gavg + (1.0 - alpha) * g
            avg = torch.sqrt(sq - gavg * gavg) + eps
        else:
            avg = torch.sqrt(sq) + eps
        if momentum > 0.0:
            buf = momentum * s["buf"] + g / avg
            p = p - lr * buf
        else:
            buf = s["buf"]
            p = p - lr * g / avg
        return p, {"sq": sq, "gavg": gavg, "buf": buf}

    return Optimizer(init, update)


# -------------------------------------------------------------- Adagrad ---

def adagrad(
    lr_decay: float = 0.0,
    weight_decay: float = 0.0,
    initial_accumulator_value: float = 0.0,
    eps: float = 1e-10,
) -> Optimizer:
    def init(p: torch.Tensor) -> dict:
        return {"sum": torch.full_like(p, initial_accumulator_value), "step": _step(p)}

    def update(g, s, p, lr):
        t = s["step"] + 1.0
        if weight_decay:
            g = g + weight_decay * p
        clr = _per_clip(lr, p) / (1.0 + (t - 1.0) * lr_decay)
        acc = s["sum"] + g * g
        return p - clr * g / (torch.sqrt(acc) + eps), {"sum": acc, "step": t}

    return Optimizer(init, update)


# ------------------------------------------------------------- Adadelta ---

def adadelta(rho: float = 0.9, eps: float = 1e-6, weight_decay: float = 0.0) -> Optimizer:
    def init(p: torch.Tensor) -> dict:
        return {"sq": torch.zeros_like(p), "acc": torch.zeros_like(p)}

    def update(g, s, p, lr):
        if weight_decay:
            g = g + weight_decay * p
        sq = rho * s["sq"] + (1.0 - rho) * g * g
        dx = torch.sqrt(s["acc"] + eps) / torch.sqrt(sq + eps) * g
        acc = rho * s["acc"] + (1.0 - rho) * dx * dx
        return p - _per_clip(lr, p) * dx, {"sq": sq, "acc": acc}

    return Optimizer(init, update)


# --------------------------------------------------------------- Adamax ---

def adamax(
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    b1, b2 = betas

    def init(p: torch.Tensor) -> dict:
        return {"step": _step(p), "m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def update(g, s, p, lr):
        t = s["step"] + 1.0
        if weight_decay:
            g = g + weight_decay * p
        m = b1 * s["m"] + (1.0 - b1) * g
        u = torch.maximum(b2 * s["u"], g.abs() + eps)
        p = p - (_per_clip(lr, p) / (1.0 - b1**t)) * m / u
        return p, {"step": t, "m": m, "u": u}

    return Optimizer(init, update)


# -------------------------------------------------------------- Registry ---

class LBFGSMarker(NamedTuple):
    """Resolved for name 'lbfgs': its update is a host loop
    (``embed/lbfgs.py``), since its curvature history grows and its exits
    depend on the data.  The solver and the service dispatch on the
    optimizer's name, not on this object."""

    history_size: int = 100


def lbfgs(history_size: int = 100, **_ignored) -> LBFGSMarker:
    return LBFGSMarker(history_size=history_size)


OPTIMIZER_REGISTRY: dict[str, Callable[..., Any]] = {
    "adam": adam,
    "nadam": nadam,
    "sgd": sgd,
    "rmsprop": rmsprop,
    "adagrad": adagrad,
    "adadelta": adadelta,
    "adamax": adamax,
    "adamw": adamw,
    "sparse_adam": adam,  # dense: no sparse gradients here
    "lbfgs": lbfgs,       # the host loop's marker
}


def get_optimizer(name: str, **kwargs) -> Optimizer | LBFGSMarker:
    """The optimizer ``name`` with its card params; ``lr`` is dropped, as
    it comes to ``update`` from the scheduler."""
    if name not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Optimizer {name} not found")
    kwargs = dict(kwargs)
    kwargs.pop("lr", None)
    return OPTIMIZER_REGISTRY[name](**kwargs)
