"""The device every entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device``, or the CUDA card when it is None; raise where the card
    asked for is missing (nothing falls back to the CPU quietly)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aware_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
