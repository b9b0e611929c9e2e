"""Phase-vocoder time stretch and pitch shift.

The port of ``aware_tpu/attacks/vocoder.py``: identity-phase-locked
magnitude interpolation with cumulative-sum phase propagation, with no
loop over frames, so that it runs batched (..., L) and differentiates.
The constants of a length and rate are built once per device.
"""

from __future__ import annotations

import fractions
import functools

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.resample import resample_poly
from aware_tpu_torch.ops.stft import (
    device_envelope,
    device_window,
    istft,
    polar,
    safe_angle,
    safe_magnitude,
    stft,
)

_N_FFT = 2048
_HOP = 512


# 256: the robust detector's 12 stretch lanes and the fine grids around
# them for one clip length (service/robust.py), with room to spare
@functools.lru_cache(maxsize=256)
def _plan(t_in: int, rate: float, device: torch.device, dtype: torch.dtype):
    """(lo, hi, frac, omega) of a stretch of ``t_in`` frames by
    ``rate``.  The fractional analysis positions are taken on the host,
    with numpy, as the JAX package takes them, so that the output length
    is the same."""
    steps = np.arange(0.0, t_in - 1, rate)
    lo = np.floor(steps).astype(np.int64)
    frac = torch.as_tensor((steps - lo)[None, :], dtype=dtype, device=device)
    # arange's float step can reach t_in - 1 itself (t_in 51 at rate 1/1.12:
    # 57 steps, the last 50.0); JAX's gather clamps the frame after it to
    # the last one, where frac is 0
    hi = np.minimum(lo + 1, t_in - 1)
    # the expected phase advance a hop of each bin
    omega = (2.0 * np.pi * _HOP * np.arange(_N_FFT // 2 + 1) / _N_FFT).astype(np.float64)
    omega = torch.as_tensor(omega[:, None], dtype=dtype, device=device)
    return torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device), frac, omega


def time_stretch(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Stretch the playback speed of (..., L) by ``rate`` (rate > 1: a
    shorter output, ``(len(steps) - 1) * hop`` samples)."""
    if rate == 1.0:
        return x
    w = device_window("hann", _N_FFT, x.device)
    z = stft(x, _N_FFT, _HOP, w)  # (..., F, T)
    # the phase is differentiated through: safe_angle keeps its gradient
    # finite at exactly-zero bins
    mag = safe_magnitude(z.real, z.imag)
    phase = safe_angle(z.real, z.imag)
    lo, hi, frac, omega = _plan(z.shape[-1], float(rate), x.device, mag.dtype)

    # index_select: its VJP is an index_add, where advanced indexing's
    # sorts the indices on every call
    mag_i = mag.index_select(-1, lo) * (1 - frac) + mag.index_select(-1, hi) * frac
    dphi = phase.index_select(-1, hi) - phase.index_select(-1, lo) - omega
    dphi = dphi - 2.0 * np.pi * torch.round(dphi / (2.0 * np.pi))  # princarg
    increments = omega + dphi  # the true phase advance a step

    # the synthesis phase starts at the first analysis phase (steps[0] = 0)
    acc = torch.cumsum(torch.cat([phase[..., :1], increments[..., :-1]], dim=-1), dim=-1)
    env = device_envelope("hann", _N_FFT, _HOP, lo.shape[0], x.device)
    return istft(polar(mag_i, acc), _N_FFT, _HOP, w, env=env)


def pitch_shift(x: torch.Tensor, semitones: float) -> torch.Tensor:
    """Shift the pitch of (..., L), keeping its length: stretch by
    r = 2^(-s/12), then resample back by the rational approximation of r."""
    if semitones == 0.0:
        return x
    rate = 2.0 ** (-semitones / 12.0)
    stretched = time_stretch(x, rate)
    frac = fractions.Fraction(rate).limit_denominator(1000)
    y = resample_poly(stretched, frac.numerator, frac.denominator)
    n = x.shape[-1]
    if y.shape[-1] >= n:
        return y[..., :n]
    return F.pad(y, (0, n - y.shape[-1]))

