"""ReduceLROnPlateau as a pure state machine with per-clip state.

The port of ``aware_tpu/embed/schedulers.py:31``.  Every field of the
state is a (B,) tensor, so each clip of a batch keeps its own plateau
count and learning rate, as under ``vmap`` in the JAX package.  The
default card (factor 0.9, patience 500, 400 iterations) never reduces the
rate; the machine is kept whole all the same.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Scheduler(NamedTuple):
    init: Callable[..., dict]
    step: Callable[[dict, torch.Tensor], dict]


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
        full = lambda v: torch.full((batch,), v, dtype=torch.float32, device=device)
        return {
            "lr": full(base_lr),
            "best": full(float("inf")),
            "num_bad": full(0.0),
            "cooldown": full(0.0),
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
