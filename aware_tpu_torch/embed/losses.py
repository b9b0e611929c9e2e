"""Embedding objective: ``push_extremes``, the default card's loss.

The port of ``aware_tpu/embed/losses.py:26``, batched: predictions and
targets are (B, n_bits) and the loss is one value per clip, (B,).
"""

from __future__ import annotations

import torch


def push_extremes(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE minus a reward for confident (large-|p|) outputs, per clip."""
    mse = ((predicted - target) ** 2).mean(dim=-1)
    return mse - 0.1 * predicted.abs().mean(dim=-1)
