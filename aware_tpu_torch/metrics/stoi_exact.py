"""Exact STOI — faithful host-side implementation of the pystoi algorithm.

The reference reports STOI through the ``pystoi`` package
(reference: src/AWARE/metrics/audio.py:42-64).  That package is not in
this image, so this module reimplements its published algorithm
(Taal, Hendriks, Heusdens, Jensen, "An Algorithm for Intelligibility
Prediction of Time-Frequency Weighted Noisy Speech", IEEE TASL 2011)
step-for-step with pystoi's exact numerical choices:

* octave-compatible resampling to 10 kHz (kaiser-windowed sinc designed
  with Octave's ``resample`` parameters: 60 dB rejection, cutoff
  ``1/(2 max(p,q))``, rolloff ``cutoff/10`` — NOT scipy's default filter);
* 256-sample frames, hop 128, MATLAB-style symmetric hanning
  (``np.hanning(N+2)[1:-1]``), 512-point rFFT, and pystoi's frame range
  ``range(0, len(x) - framelen, hop)`` (the final full frame is excluded);
* silent-frame removal by 40 dB energy gating on the *clean* signal,
  rebuilding both signals by plain overlap-add of the surviving frames;
* 15 one-third-octave bands from 150 Hz whose edges snap to the nearest
  FFT-bin frequency (argmin over squared distance — pystoi keeps
  out-of-range bands as empty rows; at 10 kHz/512 all 15 are non-empty);
* 30-frame (384 ms) segments, per-(segment, band) energy normalization of
  the degraded signal, clipping at -15 dB SDR, zero-mean correlation,
  final score = mean over segments × bands;
* the extended variant (``extended=True``) row/column-normalizes segments
  instead (Jensen & Taal 2016).

Everything is float64 numpy on host — metrics are reporting-side, not part
of the device compute path (the device-side proxy in metrics/audio.py
remains for in-graph use).  (A copy of ``aware_tpu/metrics/stoi_exact.py``.)
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import resample_poly

FS = 10000            # working sample rate
N_FRAME = 256         # 25.6 ms frames
NFFT = 512
NUMBAND = 15
MINFREQ = 150.0
N = 30                # frames per segment (384 ms)
BETA = -15.0          # SDR clip (dB)
DYN_RANGE = 40.0      # silent-frame gate (dB)
EPS = np.finfo(np.float64).eps


# ------------------------------------------------------------- resampling ---

def _resample_window_oct(p: int, q: int) -> np.ndarray:
    """Octave ``resample``'s anti-aliasing filter (what pystoi uses so its
    10 kHz path matches the MATLAB reference implementation)."""
    gcd = int(np.gcd(p, q))
    p, q = p // gcd, q // gcd
    log10_rejection = -3.0
    stopband_cutoff_f = 1.0 / (2.0 * max(p, q))
    roll_off_width = stopband_cutoff_f / 10.0
    rejection_db = -20.0 * log10_rejection  # 60 dB
    l = int(np.ceil(rejection_db / (22.0 * roll_off_width)))
    t = np.arange(-l, l + 1)
    ideal = 2 * p * stopband_cutoff_f * np.sinc(2 * stopband_cutoff_f * t)
    if 21 < rejection_db <= 50:
        beta = 0.5842 * (rejection_db - 21) ** 0.4 + 0.07886 * (rejection_db - 21)
    elif rejection_db > 50:
        beta = 0.1102 * (rejection_db - 8.7)
    else:
        beta = 0.0
    return np.kaiser(2 * l + 1, beta) * ideal


def resample_oct(x: np.ndarray, p: int, q: int) -> np.ndarray:
    """Octave-compatible polyphase resampling (pystoi's resampler)."""
    h = _resample_window_oct(p, q)
    window = h / np.sum(h)
    return resample_poly(x, p, q, window=window)


# ------------------------------------------------------------ frame tools ---

def _hanning_matlab(n: int) -> np.ndarray:
    """MATLAB ``hanning(n)`` — symmetric, endpoints nonzero."""
    return np.hanning(n + 2)[1:-1]


def _frame_starts(length: int, framelen: int, hop: int) -> range:
    """pystoi's frame range: the frame starting at exactly
    ``length - framelen`` is excluded (``range`` end is exclusive)."""
    return range(0, length - framelen, hop)


def _stdft(x: np.ndarray, framelen: int, nfft: int, hop: int) -> np.ndarray:
    w = _hanning_matlab(framelen)
    frames = np.array(
        [w * x[i : i + framelen] for i in _frame_starts(len(x), framelen, hop)]
    )
    return np.fft.rfft(frames, n=nfft, axis=-1)


def _overlap_and_add(frames: np.ndarray, hop: int) -> np.ndarray:
    n_frames, framelen = frames.shape
    out = np.zeros((n_frames - 1) * hop + framelen, dtype=np.float64)
    for i in range(n_frames):
        out[i * hop : i * hop + framelen] += frames[i]
    return out


def remove_silent_frames(
    x: np.ndarray, y: np.ndarray, dyn_range: float, framelen: int, hop: int
) -> tuple[np.ndarray, np.ndarray]:
    """Drop frames whose *clean*-signal energy is more than ``dyn_range`` dB
    below the loudest frame; rebuild both signals by overlap-add."""
    w = _hanning_matlab(framelen)
    starts = list(_frame_starts(len(x), framelen, hop))
    x_frames = np.array([w * x[i : i + framelen] for i in starts])
    y_frames = np.array([w * y[i : i + framelen] for i in starts])
    x_energies = 20.0 * np.log10(np.linalg.norm(x_frames, axis=1) + EPS)
    mask = (np.max(x_energies) - dyn_range - x_energies) < 0
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    if x_frames.shape[0] == 0:
        raise ValueError("all frames are silent — STOI is undefined")
    return _overlap_and_add(x_frames, hop), _overlap_and_add(y_frames, hop)


# --------------------------------------------------------- 1/3-octave bank ---

@functools.lru_cache(maxsize=4)
def thirdoct(
    fs: int = FS, nfft: int = NFFT, num_bands: int = NUMBAND,
    min_freq: float = MINFREQ,
) -> tuple[np.ndarray, np.ndarray]:
    """(num_bands, nfft//2+1) 0/1 aggregation matrix + center frequencies;
    band edges snap to the nearest FFT-bin frequency (pystoi's argmin
    convention; out-of-range bands would stay empty rows)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = (2.0 ** (1.0 / 3.0)) ** k * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = int(np.argmin(np.square(f - freq_low[i])))
        fh_ii = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl_ii:fh_ii] = 1.0
    return obm, cf


# ------------------------------------------------------------------- STOI ---

def _row_col_normalize(segments: np.ndarray) -> np.ndarray:
    """Extended-STOI normalization: zero-mean/unit-norm rows then columns."""
    x = segments + 0.0
    x = x - np.mean(x, axis=2, keepdims=True)
    x = x / (np.linalg.norm(x, axis=2, keepdims=True) + EPS)
    x = x - np.mean(x, axis=1, keepdims=True)
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + EPS)
    return x


def stoi_exact(
    x: np.ndarray, y: np.ndarray, fs_sig: int, extended: bool = False
) -> float:
    """STOI of degraded ``y`` against clean ``x`` (pystoi argument order)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same length")
    if fs_sig != FS:
        x = resample_oct(x, FS, fs_sig)
        y = resample_oct(y, FS, fs_sig)
    x, y = remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)

    x_spec = _stdft(x, N_FRAME, NFFT, N_FRAME // 2).T  # (257, T)
    y_spec = _stdft(y, N_FRAME, NFFT, N_FRAME // 2).T
    if x_spec.shape[1] < N:
        raise ValueError(
            f"not enough frames ({x_spec.shape[1]} < {N}) after silence "
            "removal — clip too short for STOI"
        )
    obm, _ = thirdoct()
    x_tob = np.sqrt(obm @ np.square(np.abs(x_spec)))  # (15, T)
    y_tob = np.sqrt(obm @ np.square(np.abs(y_spec)))

    x_segments = np.array(
        [x_tob[:, m - N : m] for m in range(N, x_tob.shape[1] + 1)]
    )  # (S, 15, N)
    y_segments = np.array(
        [y_tob[:, m - N : m] for m in range(N, y_tob.shape[1] + 1)]
    )

    if extended:
        x_n = _row_col_normalize(x_segments)
        y_n = _row_col_normalize(y_segments)
        return float(
            np.sum(x_n * y_n / N) / x_n.shape[0]
        )

    norm_const = np.linalg.norm(x_segments, axis=2, keepdims=True) / (
        np.linalg.norm(y_segments, axis=2, keepdims=True) + EPS
    )
    y_norm = y_segments * norm_const
    clip_value = 10.0 ** (-BETA / 20.0)
    y_primes = np.minimum(y_norm, x_segments * (1 + clip_value))
    y_primes = y_primes - np.mean(y_primes, axis=2, keepdims=True)
    x_seg = x_segments - np.mean(x_segments, axis=2, keepdims=True)
    y_primes = y_primes / (np.linalg.norm(y_primes, axis=2, keepdims=True) + EPS)
    x_seg = x_seg / (np.linalg.norm(x_seg, axis=2, keepdims=True) + EPS)
    correlations = x_seg * y_primes
    j, m = x_seg.shape[0], x_seg.shape[1]
    return float(np.sum(correlations) / (j * m))
