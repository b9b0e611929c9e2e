"""Analysis windows.

Periodic (DFT-even) windows matching ``torch.hann_window`` /
``torch.hamming_window``, computed in float64 on the host and cast, so the
values are bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np


def get_window(window: str, win_length: int, dtype=np.float32) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    if window == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    elif window == "hamming":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)
    else:
        raise ValueError(f"Invalid window type: {window}")
    return w.astype(dtype)
