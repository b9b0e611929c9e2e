"""Differentiable CELP-flavoured compression view (LPC-envelope codec).

The port of ``aware_tpu/attacks/celp.py``: the channel model of 8-16 kb/s
speech codecs, batched over (..., L).

    STFT (20 ms frames) -> per-frame autocorrelation (Wiener-Khinchin,
    irfft of the power spectrum) -> order-10 Levinson-Durbin -> all-pole
    envelope on the rfft grid -> straight-through log-domain envelope
    quantization -> excitation flattening (mag/env)^alpha -> an
    envelope-shaped noise floor -> soft band limit -> ISTFT with the
    original phase.

The reflection coefficients' clip to +/-0.999 is ``torch.maximum`` /
``torch.minimum`` against tensors, which split the gradient at a tie as
``jnp.clip`` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aware_tpu_torch.ops.stft import (
    device_envelope,
    device_window,
    istft,
    magphase,
    polar,
    stft,
)

_ORDER = 10          # the narrowband CELP short-term predictor's order
_FRAME_MS = 20.0

# the named pressure modes: (env_step_db, alpha, noise_rel_db, cutoff_hz)
#   env_step_db  - straight-through quantization step of the log envelope
#   alpha        - excitation fine-structure exponent (1 keeps, 0 flattens)
#   noise_rel_db - envelope-shaped noise floor relative to the envelope
#   cutoff_hz    - soft band limit (None keeps the full band)
MODES: dict[str, tuple[float, float, float, float | None]] = {
    "nb8k": (1.5, 0.35, -14.0, 3900.0),   # GSM-FR / 8 kb/s CELP pressure
    "mb16k": (1.0, 0.6, -20.0, 6500.0),   # milder medium-bitrate pressure
}


@functools.lru_cache(maxsize=8)
def _lpc_freq_tables(n_rfft: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (order+1, n_rfft) that evaluate A(e^{-jw}) on the grid."""
    w = 2.0 * np.pi * np.arange(n_rfft) / n_fft
    k = np.arange(_ORDER + 1)[:, None]
    return np.cos(k * w[None, :]).astype(np.float32), np.sin(k * w[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _tables(n_rfft: int, n_fft: int, device: torch.device):
    """The tables' transposes (n_rfft, order+1) on ``device``."""
    cos_t, sin_t = _lpc_freq_tables(n_rfft, n_fft)
    return torch.from_numpy(cos_t.T.copy()).to(device), torch.from_numpy(sin_t.T.copy()).to(device)


@functools.lru_cache(maxsize=16)
def _k_bounds(device: torch.device, dtype: torch.dtype):
    """The reflection coefficients' bounds as tensors on ``device``."""
    return torch.tensor(-0.999, dtype=dtype, device=device), torch.tensor(0.999, dtype=dtype,
                                                                           device=device)


@functools.lru_cache(maxsize=16)
def _gate(n_rfft: int, sr: int, n_fft: int, cutoff: float, device: torch.device):
    """The soft band limit (n_rfft, 1): a sigmoid rolloff over ~300 Hz."""
    f = torch.arange(n_rfft, dtype=torch.float32) * (sr / n_fft)
    return torch.sigmoid((cutoff - f) / 60.0)[:, None].to(device)


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (half to even, as jnp.round)."""
    return x + (torch.round(x) - x).detach()


def _levinson(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin over axis -2 of the lags ``r`` (..., order+1, T).

    Returns (a, g2): the predictor coefficients a_0..a_p (a_0 = 1) as
    (..., order+1, T) and the prediction-error power g2 (..., T).  Unrolled
    over the fixed order; a white-noise floor keeps silent frames finite."""
    k_lo, k_hi = _k_bounds(r.device, r.dtype)
    r = r / (r[..., 0:1, :] + 1e-10)  # normalized: r0 = 1 exactly
    # the white-noise floor: r0 = 1 + 1e-4, with no gradient to the old r0
    r = torch.cat([torch.full_like(r[..., :1, :], 1.0 + 1e-4), r[..., 1:, :]], dim=-2)
    rows = [torch.ones_like(r[..., 0, :])] + [torch.zeros_like(r[..., 0, :])] * _ORDER
    e = r[..., 0, :]
    for m in range(1, _ORDER + 1):
        # acc = sum_j a[j] r[m - j], j = 0 .. m-1
        acc = sum(rows[j] * r[..., m - j, :] for j in range(m))
        k = torch.minimum(k_hi, torch.maximum(k_lo, -acc / e))  # a stable filter
        # a'[j] = a[j] + k a[m - j] (j = 1 .. m), with a[m] 0 until now
        rows = [rows[0]] + [rows[j] + k * rows[m - j] for j in range(1, m + 1)] + rows[m + 1 :]
        e = e * (1.0 - k * k)
    return torch.stack(rows, dim=-2), e


def celp_envelope(mag: torch.Tensor, n_fft: int) -> torch.Tensor:
    """All-pole (LPC-10) spectral envelope of a magnitude STFT (..., F, T).

    The autocorrelation comes from each frame's own power spectrum
    (Wiener-Khinchin), so the envelope lands on the rfft grid."""
    n_rfft = mag.shape[-2]
    cos_t, sin_t = _tables(n_rfft, n_fft, mag.device)
    power = mag.float() ** 2
    # the autocorrelation lags (..., order+1, T) from irfft over frequency
    r = torch.fft.irfft(power, n=n_fft, dim=-2)[..., : _ORDER + 1, :]
    a, g2 = _levinson(r)
    re = cos_t @ a  # (..., F, T)
    im = sin_t @ a
    inv_a2 = 1.0 / (re * re + im * im + 1e-8)
    # scaled so that the envelope holds the frame's power
    env2 = g2[..., None, :] * inv_a2
    scale = power.sum(dim=-2, keepdim=True) / (env2.sum(dim=-2, keepdim=True) + 1e-10)
    return torch.sqrt(env2 * scale + 1e-12)


def celp_approx_mag(mag: torch.Tensor, sr: int, n_fft: int, mode: str = "nb8k") -> torch.Tensor:
    """CELP-flavoured re-coding of a magnitude STFT (..., F, T)."""
    env_step_db, alpha, noise_rel_db, cutoff = MODES[mode]
    env = celp_envelope(mag, n_fft)

    # coarse (LSF-like) envelope quantization, straight-through, in log10
    step = env_step_db / 20.0
    env_q = 10.0 ** (_ste_round(torch.log10(env + 1e-10) / step) * step)

    # codebook excitation: the residual's fine structure pressed toward
    # flat; the smoothed power form keeps the x^alpha gradient bounded
    ratio = mag / (env + 1e-10)
    out = env_q * (ratio * ratio + 1e-4) ** (alpha / 2.0)
    # the envelope-shaped coding-noise floor
    noise = 10.0 ** (noise_rel_db / 20.0) * env_q
    out = torch.sqrt(out * out + noise * noise)
    if cutoff is not None:
        out = out * _gate(mag.shape[-2], sr, n_fft, float(cutoff), mag.device)
    return out.to(mag.dtype)


def celp_approx(x: torch.Tensor, sr: int, mode: str = "nb8k") -> torch.Tensor:
    """The waveform-level CELP view of (..., L): the same length,
    differentiable.  Frames of 20 ms rounded up to a power of two (512 at
    16 kHz), 50 % hop; the original phase is kept (the conservative
    choice: the view never claims more damage than the real codec)."""
    n_fft = int(2 ** np.ceil(np.log2(_FRAME_MS * 1e-3 * sr)))
    hop = n_fft // 2
    w = device_window("hann", n_fft, x.device)
    mag, phase = magphase(stft(x, n_fft, hop, w))
    out = celp_approx_mag(mag, sr, n_fft, mode)
    env = device_envelope("hann", n_fft, hop, mag.shape[-1], x.device)
    y = istft(polar(out, phase), n_fft, hop, w, env=env)
    return y[..., : x.shape[-1]]
