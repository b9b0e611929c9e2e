"""Audio quality and detection metrics.

The port of ``aware_tpu/metrics/audio.py`` (reference:
src/AWARE/metrics/audio.py:8-89):

* ``ber``: bit error rate **as a percentage** (reference quirk, :16);
* ``snr``: 10 log10(P_out / P_err) with the *output* power in the
  numerator (reference :89), +inf on identical signals;
* ``stoi``: exact STOI on the host (``metrics/stoi_exact.py``, the pystoi
  algorithm the reference calls); ``stoi_device`` its approximation in
  torch on a device;
* ``pesq``: wideband PESQ MOS-LQO on the host (``metrics/pesq_p862.py``,
  the P.862.2 pipeline); ``pesq_proxy`` a PESQ-style score in [1.02, 4.64]
  in torch on a device, its map least-squares calibrated against ``pesq``
  (the JAX package's tools/calibrate_proxy.py, PROXY_CALIBRATION.json).

All metrics take (output, target) in reference argument order, accept
stereo (L, 2) input (mean-downmixed, :27-33), truncate to the common
length, and resample to their operating rate with the port's resampler on
``device`` (the CUDA card unless the caller asks for the CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aware_tpu_torch.device import resolve_device
from aware_tpu_torch.ops.resample import resample
from aware_tpu_torch.ops.stft import stft
from aware_tpu_torch.ops.windows import get_window


def _downmix_pair(output, target):
    """Stereo -> mono mean downmix + truncate to common length (host-side
    shape logic; reference :27-35)."""
    output = np.asarray(output, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    if output.ndim == 2 and output.shape[1] == 2:
        output = output.mean(axis=1)
    if target.ndim == 2 and target.shape[1] == 2:
        target = target.mean(axis=1)
    n = min(len(output), len(target))
    return output[:n], target[:n]


def _resampled(x: np.ndarray, sr: int, target_sr: int, device) -> torch.Tensor:
    """Host audio as a float32 tensor on ``device`` at ``target_sr``."""
    return resample(torch.as_tensor(x, device=resolve_device(device)), sr, target_sr)


# ------------------------------------------------------------------- BER ---

def ber(output, target) -> float:
    """Percent bit mismatches (reference: :8-17)."""
    output = np.asarray(output)
    target = np.asarray(target)
    return float(np.mean(output != target) * 100.0)


# ------------------------------------------------------------------- SNR ---

def snr(output, target) -> float:
    """Reference-form SNR (output power over error power), dB (:68-89)."""
    output, target = _downmix_pair(output, target)
    if np.array_equal(output, target):
        return float("inf")
    return float(
        10.0
        * np.log10(np.mean(output**2) / np.mean((output - target) ** 2))
    )


# ------------------------------------------------------------------ STOI ---

_STOI_SR = 10000
_STOI_NFFT = 512
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30          # 384 ms segments
_STOI_BETA_DB = -15.0  # SDR clip
_STOI_DYN_RANGE = 40.0


@functools.lru_cache(maxsize=4)
def _third_octave_matrix() -> np.ndarray:
    """(15, 257) one-third-octave band aggregation matrix at 10 kHz."""
    f = np.linspace(0, _STOI_SR / 2, _STOI_NFFT // 2 + 1)
    cf = _STOI_MINFREQ * 2.0 ** (np.arange(_STOI_NBANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    mat = np.zeros((_STOI_NBANDS, len(f)), dtype=np.float32)
    for i in range(_STOI_NBANDS):
        # snap band edges to the nearest FFT bins (as the published
        # implementation does)
        lo_i = np.argmin((f - lo[i]) ** 2)
        hi_i = np.argmin((f - hi[i]) ** 2)
        mat[i, lo_i:hi_i] = 1.0
    return mat


def _frames(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    n = (x.shape[-1] - frame) // hop + 1
    idx = torch.arange(n, device=x.device)[:, None] * hop + torch.arange(frame, device=x.device)
    return x[..., idx]


def _stoi_core(x10: torch.Tensor, y10: torch.Tensor) -> torch.Tensor:
    """STOI approximation of two equal-length 10 kHz signals (silent-frame
    removal as a mask weight, so the shapes do not depend on the data)."""
    w = torch.as_tensor(get_window("hann", _STOI_FRAME + 1)[1:], device=x10.device)
    xf = _frames(x10, _STOI_FRAME, _STOI_HOP) * w
    yf = _frames(y10, _STOI_FRAME, _STOI_HOP) * w

    # silent-frame mask from the *clean* signal energy (x = target)
    e = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + 1e-12)
    mask = e > (e.max() - _STOI_DYN_RANGE)

    spec_x = torch.fft.rfft(xf, n=_STOI_NFFT, dim=-1).abs() ** 2
    spec_y = torch.fft.rfft(yf, n=_STOI_NFFT, dim=-1).abs() ** 2
    octmat = torch.as_tensor(_third_octave_matrix(), device=x10.device)
    big_x = torch.sqrt(spec_x @ octmat.T + 1e-20)  # (F, 15)
    big_y = torch.sqrt(spec_y @ octmat.T + 1e-20)

    # segments of N frames; a segment counts when all frames are non-silent
    # (indices past the last frame clamp, as a JAX gather's do)
    n_frames = big_x.shape[0]
    n_seg = n_frames - _STOI_N + 1
    seg_idx = (torch.arange(max(n_seg, 1), device=x10.device)[:, None]
               + torch.arange(_STOI_N, device=x10.device)[None, :]).clamp(max=n_frames - 1)
    xs = big_x[seg_idx]  # (S, N, 15)
    ys = big_y[seg_idx]
    seg_ok = mask[seg_idx].all(dim=1)  # (S,)

    # normalize Y to X energy per (segment, band), clip at -15 dB SDR
    alpha = torch.sqrt((xs**2).sum(dim=1, keepdim=True)
                       / ((ys**2).sum(dim=1, keepdim=True) + 1e-20))
    yn = ys * alpha
    clip = 10.0 ** (-_STOI_BETA_DB / 20.0)
    yn = torch.minimum(yn, xs * (1.0 + clip))

    xm = xs - xs.mean(dim=1, keepdim=True)
    ym = yn - yn.mean(dim=1, keepdim=True)
    corr = (xm * ym).sum(dim=1) / (
        torch.linalg.vector_norm(xm, dim=1) * torch.linalg.vector_norm(ym, dim=1) + 1e-20
    )  # (S, 15)
    seg_d = corr.mean(dim=-1)
    w_ok = seg_ok.to(seg_d.dtype)
    return (seg_d * w_ok).sum() / (w_ok.sum() + 1e-20)


def stoi_device(output, target, sampling_rate: int, device=None) -> float:
    """The STOI approximation in torch on ``device``.  For reported scores
    use :func:`stoi`, the exact pystoi algorithm on the host."""
    output, target = _downmix_pair(output, target)
    x = _resampled(target, sampling_rate, _STOI_SR, device)
    y = _resampled(output, sampling_rate, _STOI_SR, device)
    return float(_stoi_core(x, y))


def stoi(output, target, sampling_rate: int, device=None) -> float:
    """Exact STOI of ``output`` given clean ``target``.

    Mirrors the reference wrapper (metrics/audio.py:42-64): stereo
    mean-downmix, truncate to common length, resample to 16 kHz (the port's
    resampler on ``device``), then the pystoi algorithm on the host (which
    itself resamples to 10 kHz): ``metrics.stoi_exact``.
    """
    from aware_tpu_torch.metrics.stoi_exact import stoi_exact

    output, target = _downmix_pair(output, target)
    if sampling_rate != 16000:
        output = _resampled(output, sampling_rate, 16000, device).cpu().numpy()
        target = _resampled(target, sampling_rate, 16000, device).cpu().numpy()
    return stoi_exact(target, output, 16000)


# ------------------------------------------------------------ PESQ proxy ---

_PESQ_SR = 16000


def _bark_matrix(n_fft: int, sr: int, n_bands: int = 49) -> np.ndarray:
    """Triangular Bark-scale aggregation (z = 13 atan(.00076 f) +
    3.5 atan((f/7500)^2))."""
    f = np.linspace(0, sr / 2, n_fft // 2 + 1)
    z = 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)
    z_edges = np.linspace(z[1], z[-1], n_bands + 2)
    mat = np.zeros((n_bands, len(f)), dtype=np.float32)
    for i in range(n_bands):
        lo, cf, hi = z_edges[i], z_edges[i + 1], z_edges[i + 2]
        up = (z - lo) / max(cf - lo, 1e-6)
        dn = (hi - z) / max(hi - cf, 1e-6)
        mat[i] = np.clip(np.minimum(up, dn), 0.0, None)
    return mat


@functools.lru_cache(maxsize=4)
def _pesq_bark() -> np.ndarray:
    return _bark_matrix(512, _PESQ_SR)


def _pesq_nd(ref16: torch.Tensor, deg16: torch.Tensor) -> torch.Tensor:
    """Normalized perceptual disturbance (pre-map) of the PESQ proxy.

    Level-normalizes both signals (PESQ is level-invariant), compares Bark
    loudness over ALL frames (silent frames included, exactly where
    additive noise hurts most in P.862) with the P.862 asymmetry idea
    (added disturbance weighted above removed signal).
    """
    w = get_window("hann", 512)
    ref16 = ref16 / (torch.sqrt((ref16**2).mean()) + 1e-9)
    deg16 = deg16 / (torch.sqrt((deg16**2).mean()) + 1e-9)
    r = stft(ref16, 512, 256, w).abs() ** 2  # (257, T)
    d = stft(deg16, 512, 256, w).abs() ** 2
    bark = torch.as_tensor(_pesq_bark(), device=ref16.device)
    # loudness-ish compression (Zwicker exponent on band power)
    lr = (bark @ r + 1e-10) ** 0.23
    ld = (bark @ d + 1e-10) ** 0.23
    diff = ld - lr
    # P.862 asymmetry: added distortion hurts more than removed signal
    disturbance = torch.where(diff > 0, 1.8 * diff, -0.6 * diff)
    dist = disturbance.mean(dim=0).mean()
    rms_l = torch.sqrt((lr.mean(dim=0) ** 2).mean())
    return dist / (rms_l + 1e-9)


def _pesq_core(ref16: torch.Tensor, deg16: torch.Tensor) -> torch.Tensor:
    nd = _pesq_nd(ref16, deg16)
    # stretched-exponential map to the wideband MOS-LQO range [1.02, 4.64];
    # constants least-squares fitted against the exact P.862.2
    # implementation (the JAX package's tools/calibrate_proxy.py)
    return 1.02 + 3.6296 * torch.exp(-2.6283 * (nd + 1e-9) ** 1.1667)


def pesq_proxy(output, target, sampling_rate: int, device=None) -> float:
    """PESQ-style perceptual proxy in [1.02, 4.64] in torch on ``device``,
    calibrated against :func:`pesq`; for reported scores use :func:`pesq`."""
    output, target = _downmix_pair(output, target)
    d = _resampled(output, sampling_rate, _PESQ_SR, device)
    r = _resampled(target, sampling_rate, _PESQ_SR, device)
    return float(_pesq_core(r, d))


def pesq(output, target, sampling_rate: int, device=None) -> float:
    """Wideband PESQ MOS-LQO (P.862.2 pipeline, host-side).

    Mirrors the reference wrapper (metrics/audio.py:19-39): stereo
    mean-downmix, truncate to common length, resample to 16 kHz (the port's
    resampler on ``device``), then ``pesq(16000, ref, deg, 'wb')``:
    ``metrics.pesq_p862`` (see its docstring for the exactness statement).
    """
    from aware_tpu_torch.metrics.pesq_p862 import pesq_wb

    output, target = _downmix_pair(output, target)
    if sampling_rate != 16000:
        output = _resampled(output, sampling_rate, 16000, device).cpu().numpy()
        target = _resampled(target, sampling_rate, 16000, device).cpu().numpy()
    return pesq_wb(target, output, 16000)


# ------------------------------------------------- reference-style classes ---

class BER:
    """Callable matching the reference class surface (reference: :8-17)."""

    def __call__(self, output, target) -> float:
        return ber(output, target)


class SNR:
    def __call__(self, output, target) -> float:
        return snr(output, target)


class STOI:
    def __call__(self, output, target, sampling_rate: int) -> float:
        return stoi(output, target, sampling_rate)


class PESQ:
    """Wideband PESQ callable (P.862.2 pipeline; the reference calls the
    ITU C extension at :19-39)."""

    def __call__(self, output, target, sampling_rate: int) -> float:
        return pesq(output, target, sampling_rate)
