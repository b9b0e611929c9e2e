"""The card schema's learning-rate schedulers as pure state machines with
per-clip state.

The port of ``aware_tpu/embed/schedulers.py``.  Each scheduler is::

    init(base_lr, batch, device)  -> state  (state["lr"] is read before a step)
    step(state, loss)             -> state  (after each iteration, with its
                                             (B,) loss)

and every field of the state is a (B,) float32 tensor, so each clip of a
batch keeps its own schedule, as under ``vmap`` in the JAX package.  The
default card's plateau machine (factor 0.9, patience 500, 400 iterations)
never reduces the rate; it is kept whole all the same.

The other six are the JAX package's closed forms of lr(t), ``t`` counting
completed ticks (torch's ``last_epoch``), computed in float32 tensors as
JAX computes them: torch's own recursive forms of ``cosine_annealing`` and
of the warm restarts with ``T_mult > 1`` differ in the last bits, and a
float64 ``floor(log(...))`` or ``mod`` could move a restart.  ``cyclic``
takes its own ``base_lr``; the optimizer's is only the first step's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


class Scheduler(NamedTuple):
    init: Callable[..., dict]
    step: Callable[[dict, torch.Tensor], dict]


def _full(value: float, batch: int, device) -> torch.Tensor:
    return torch.full((batch,), value, dtype=torch.float32, device=device)


def reduce_lr_on_plateau(
    factor: float = 0.1,
    patience: int = 10,
    threshold: float = 1e-4,
    threshold_mode: str = "rel",
    cooldown: int = 0,
    min_lr: float = 0.0,
    eps: float = 1e-8,
    mode: str = "min",
) -> Scheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau (mode='min')."""
    if mode != "min":
        raise ValueError("only mode='min' is used by this framework")

    def init(base_lr: float, batch: int, device=None) -> dict:
        return {
            "lr": _full(base_lr, batch, device),
            "best": _full(float("inf"), batch, device),
            "num_bad": _full(0.0, batch, device),
            "cooldown": _full(0.0, batch, device),
        }

    def step(s: dict, loss: torch.Tensor) -> dict:
        if threshold_mode == "rel":
            is_better = loss < s["best"] * (1.0 - threshold)
        else:
            is_better = loss < s["best"] - threshold
        best = torch.where(is_better, loss, s["best"])
        num_bad = torch.where(is_better, 0.0, s["num_bad"] + 1.0)
        in_cooldown = s["cooldown"] > 0.0
        cd = torch.where(in_cooldown, s["cooldown"] - 1.0, 0.0)
        num_bad = torch.where(in_cooldown, 0.0, num_bad)
        reduce = num_bad > patience
        new_lr = torch.clamp(s["lr"] * factor, min=min_lr)
        new_lr = torch.where(s["lr"] - new_lr > eps, new_lr, s["lr"])
        lr = torch.where(reduce, new_lr, s["lr"])
        cd = torch.where(reduce, float(cooldown), cd)
        num_bad = torch.where(reduce, 0.0, num_bad)
        return {"lr": lr, "best": best, "num_bad": num_bad, "cooldown": cd}

    return Scheduler(init, step)


def _lr_lambda_scheduler(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> Scheduler:
    """A stateless lr(t, base) schedule; ``t`` counts completed ticks."""

    def init(base_lr: float, batch: int, device=None) -> dict:
        return {"lr": _full(base_lr, batch, device), "t": _full(0.0, batch, device),
                "base": _full(base_lr, batch, device)}

    def step(s: dict, loss: torch.Tensor) -> dict:
        t = s["t"] + 1.0
        return {"lr": fn(t, s["base"]), "t": t, "base": s["base"]}

    return Scheduler(init, step)


def step_lr(step_size: int, gamma: float = 0.1) -> Scheduler:
    return _lr_lambda_scheduler(lambda t, base: base * gamma ** torch.floor(t / step_size))


def multi_step_lr(milestones, gamma: float = 0.1) -> Scheduler:
    ms = sorted(float(m) for m in milestones)

    def fn(t, base):
        passed = torch.zeros_like(t)
        for m in ms:
            passed = passed + (t >= m).to(t.dtype)
        return base * gamma**passed

    return _lr_lambda_scheduler(fn)


def exponential_lr(gamma: float) -> Scheduler:
    return _lr_lambda_scheduler(lambda t, base: base * gamma**t)


def cosine_annealing_lr(T_max: int, eta_min: float = 0.0) -> Scheduler:
    return _lr_lambda_scheduler(
        lambda t, base: eta_min + (base - eta_min) * (1.0 + torch.cos(math.pi * t / T_max)) / 2.0
    )


def cosine_annealing_warm_restarts(T_0: int, T_mult: int = 1, eta_min: float = 0.0) -> Scheduler:
    if T_mult == 1:
        def fn(t, base):
            t_cur = torch.remainder(t, T_0)
            return eta_min + (base - eta_min) * (1.0 + torch.cos(math.pi * t_cur / T_0)) / 2.0
    else:
        # the closed form of the geometric restart schedule
        log_tm = math.log(T_mult)

        def fn(t, base):
            n = torch.floor(torch.log(t / T_0 * (T_mult - 1.0) + 1.0) / log_tm)
            t_start = T_0 * (T_mult**n - 1.0) / (T_mult - 1.0)
            t_i = T_0 * T_mult**n
            t_cur = t - t_start
            return eta_min + (base - eta_min) * (1.0 + torch.cos(math.pi * t_cur / t_i)) / 2.0

    return _lr_lambda_scheduler(fn)


def cyclic_lr(
    base_lr: float,
    max_lr: float,
    step_size_up: int = 2000,
    step_size_down: int | None = None,
    mode: str = "triangular",
    gamma: float = 1.0,
) -> Scheduler:
    up = float(step_size_up)
    down = float(step_size_down if step_size_down is not None else step_size_up)
    total = up + down
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise KeyError(mode)

    def fn(t, _base):
        cycle = torch.floor(1.0 + t / total)
        x = t - (cycle - 1.0) * total
        frac = torch.where(x <= up, x / up, 1.0 - (x - up) / down)
        if mode == "triangular":
            scale = 1.0
        elif mode == "triangular2":
            scale = 2.0 ** (1.0 - cycle)
        else:
            scale = gamma**t
        return base_lr + (max_lr - base_lr) * frac * scale

    return _lr_lambda_scheduler(fn)


SCHEDULER_REGISTRY: dict[str, Callable[..., Scheduler]] = {
    "reduce_lr_on_plateau": reduce_lr_on_plateau,
    "cosine_annealing": cosine_annealing_lr,
    "cosine_annealing_warm_restarts": cosine_annealing_warm_restarts,
    "step": step_lr,
    "multi_step": multi_step_lr,
    "exponential": exponential_lr,
    "cyclic": cyclic_lr,
}


def get_scheduler(name: str, **kwargs: Any) -> Scheduler:
    if name not in SCHEDULER_REGISTRY:
        raise ValueError(f"Scheduler {name} not found")
    return SCHEDULER_REGISTRY[name](**kwargs)
