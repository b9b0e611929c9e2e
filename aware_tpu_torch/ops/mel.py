"""Slaney-scale mel filter bank.

Host-side (numpy, float64 internally) construction of the librosa-compatible
mel basis the detector's first layer multiplies by
(reference: src/AWARE/detection/modules/mel.py:105-149).  A copy of
``aware_tpu/ops/mel.py``, so that the port imports nothing of the JAX
package; the basis is a constant and the only device work is one
(n_mels, F) x (F, T) matmul.

Implemented from the standard Slaney mel definition (linear below 1 kHz,
log-spaced above, triangular filters with 2/(bandwidth) area normalization).
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Hz -> Slaney mels (linear < 1 kHz, logarithmic above)."""
    f = np.asarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mels = f / f_sp
    above = f >= min_log_hz
    mels = np.where(
        above,
        min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Slaney mels -> Hz."""
    m = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = f_sp * m
    above = m >= min_log_mel
    hz = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)
    return hz


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels)
    return mel_to_hz(mels)


@functools.lru_cache(maxsize=16)
def mel_filter_bank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular Slaney-normalized mel basis, shape (n_mels, n_fft//2+1)."""
    if fmax is None:
        fmax = float(sr) / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)  # (n_mels + 1,)
    # ramps[i, k] = mel_f[i] - fftfreqs[k]
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style: scale each filter to ~constant energy per channel.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)
