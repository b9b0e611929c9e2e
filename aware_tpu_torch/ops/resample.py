"""Polyphase resampling as one strided-frame matmul.

The port of ``aware_tpu/ops/resample.py:115-147``: the polyphase filter
bank is built on the host in float64 (scipy's ``resample_poly`` defaults:
a Kaiser(5.0) windowed-sinc FIR of 2*10*max(up, down)+1 taps) and the
signal, framed at stride ``down``, is multiplied by it once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser(numtaps: int, beta: float) -> np.ndarray:
    n = np.arange(numtaps, dtype=np.float64)
    alpha = (numtaps - 1) / 2.0
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - ((n - alpha) / alpha) ** 2))
    return np.i0(arg) / np.i0(beta)


def _firwin_kaiser(numtaps: int, cutoff: float, beta: float = 5.0) -> np.ndarray:
    """Lowpass FIR (scipy.signal.firwin with a Kaiser window, unit DC gain)."""
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m) * _kaiser(numtaps, beta)
    return h / np.sum(h)


@functools.lru_cache(maxsize=64)
def polyphase_filter(up: int, down: int) -> np.ndarray:
    """scipy-compatible anti-aliasing FIR for a rational up/down resample."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _firwin_kaiser(2 * half_len + 1, 1.0 / max_rate, beta=5.0)
    return (h * up).astype(np.float64)


# Plans are per (up, down, n_in).  256 holds, for one clip length, the robust
# detector's 19 resample lanes and the fine grid around each of them (6 a
# winner, service/robust.py), so a stream of such clips builds each once.
@functools.lru_cache(maxsize=256)
def _polyphase_plan(up: int, down: int, n_in: int):
    """Host-side constants: output n0 + m*up + s is frames[m] @ G[:, s],
    with frames of width W strided by ``down`` and G a (W, up) embedding
    of the per-phase filters."""
    n_out = -(-n_in * up // down)
    h = polyphase_filter(up, down)
    half_len = (len(h) - 1) // 2
    n_pre_pad = down - (half_len % down) if half_len % down else 0
    h_padded = np.concatenate([np.zeros(n_pre_pad), h])
    n0 = (half_len + n_pre_pad) // down

    k_len = -(-len(h_padded) // up)
    fbank = np.zeros((up, k_len))
    for r in range(up):
        taps = h_padded[r::up]
        fbank[r, : len(taps)] = taps

    n_s = n0 + np.arange(up)
    r_s = (n_s * down) % up
    base0 = (n_s * down - r_s) // up
    bmin = int(base0.min()) - (k_len - 1)
    w = int(base0.max()) - bmin + 1

    g_mat = np.zeros((w, up))
    for s in range(up):
        for k in range(k_len):
            g_mat[base0[s] - k - bmin, s] = fbank[r_s[s], k]

    c = -(-n_out // up)
    pad_left = max(0, -bmin)
    q = -(-w // down) + 1
    pad_right = max(0, bmin + (c + q) * down - n_in)
    return n_out, c, w, q, pad_left, pad_right, bmin, g_mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _g_tensor(up: int, down: int, n_in: int, device: torch.device, dtype: torch.dtype):
    """The plan's filter matrix on ``device``, built once: a copy from the
    host in every call would wait for the card."""
    return torch.from_numpy(_polyphase_plan(up, down, n_in)[-1]).to(device, dtype)


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Rational-rate resample of the last axis (scipy.resample_poly
    semantics); output length ``ceil(L * up / down)``."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    n_in = x.shape[-1]
    n_out, c, w, q, pad_left, pad_right, bmin, _ = _polyphase_plan(up, down, n_in)
    batch_shape = x.shape[:-1]
    xp = F.pad(x, (pad_left, pad_right))
    off = pad_left + bmin
    rows = xp[..., off : off + (c + q) * down].reshape(*batch_shape, c + q, down)
    frames = torch.cat([rows[..., i : i + c, :] for i in range(q)], dim=-1)[..., :w]
    y = frames @ _g_tensor(up, down, n_in, x.device, x.dtype)
    return y.reshape(*batch_shape, c * up)[..., :n_out]


def resample(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Resample between integer sample rates (e.g. 44100 -> 16000)."""
    if orig_sr == target_sr:
        return x
    return resample_poly(x, target_sr, orig_sr)
