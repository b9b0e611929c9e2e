"""Desync-robust detection by a compensation search.

The port of ``aware_tpu/service/robust.py``: recovery from playback-rate
desync (speed edits, which resampling undoes exactly) and phase-vocoder
time stretch (which re-stretching by the inverse factor undoes in time
base, at constant pitch).  Every hypothesis of the grid is a lane: the
clip compensated by that lane's rate, its band-limited STFT magnitude,
then one masked detector forward (``DetectorNet.forward_masked``) over all
lanes at once, zero-padded to the longest lane.  The most confident
readout (largest mean |tanh readout|) wins; a clean clip wins at the
identity lane.

Each lane's compensation runs on the detector's device once a call:
``resample_poly`` (``ops/resample.py``) or ``time_stretch``
(``attacks/vocoder.py``), whose host plans are cached per input length and
rate.  Those caches hold the whole coarse grid and a fine grid around
every coarse winner for one clip length, so a stream of clips of one
length builds each plan once.
"""

from __future__ import annotations

import fractions
import typing

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.attacks.vocoder import time_stretch
from aware_tpu_torch.config import in_band_bins
from aware_tpu_torch.models.detector import preprocess_magnitude
from aware_tpu_torch.ops.resample import resample_poly
from aware_tpu_torch.ops.windows import get_window
from aware_tpu_torch.service.api import AWAREDetector
from aware_tpu_torch.service.codec import decode_pattern

DEFAULT_RATES: tuple[float, ...] = (
    0.78, 0.8, 0.82, 0.85, 0.88, 0.9, 0.92, 0.95, 0.97, 1.0,
    1.03, 1.05, 1.08, 1.1, 1.12, 1.15, 1.18, 1.2, 1.22, 1.25,
)

# Vocoder-compensation lanes: a time-stretch attack at rate r is undone by
# re-stretching at 1/r, so this grid spans the inverse of the attack range
# the eval suite exercises (ts_0.8 .. ts_1.2 -> compensation 1.25 .. 0.83).
DEFAULT_STRETCH_RATES: tuple[float, ...] = (
    0.8, 0.83, 0.86, 0.9, 0.93, 0.96, 1.04, 1.08, 1.12, 1.16, 1.2, 1.25,
)

# the fine grid around a coarse winner, as factors of its rate
REFINE_FACTORS: tuple[float, ...] = (0.985, 0.99, 0.995, 1.005, 1.01, 1.015)

Hypothesis = tuple[str, float]  # ("resample" | "stretch", rate)


class RobustDetection(typing.NamedTuple):
    """Winning hypothesis of the compensation search: ``kind`` names the
    family ("resample" | "stretch"), ``rate`` is the positive length
    multiplier of its compensation."""

    bits: np.ndarray
    kind: str
    rate: float
    confidence: float


def _rate_fraction(rate: float) -> fractions.Fraction:
    return fractions.Fraction(rate).limit_denominator(64)


def _compensate(x: torch.Tensor, kind: str, rate: float) -> torch.Tensor:
    """One compensation lane of the waveform (L,)."""
    if rate == 1.0:
        return x
    if kind == "resample":
        frac = _rate_fraction(rate)
        return resample_poly(x, frac.numerator, frac.denominator)
    if kind == "stretch":
        # time_stretch(x, s) maps T frames to about T / s, so the lane's
        # length multiplier r is applied as the stretch factor 1 / r
        return time_stretch(x, 1.0 / rate)
    raise ValueError(f"unknown compensation kind {kind!r}")


def _hypotheses(rates, stretch_rates) -> tuple[Hypothesis, ...]:
    return tuple(("resample", r) for r in tuple(rates)) + tuple(
        ("stretch", r) for r in tuple(stretch_rates))


def _grid_values(detector: AWAREDetector, audio: np.ndarray,
                 hyps: tuple[Hypothesis, ...], split: bool = False) -> np.ndarray:
    """Raw detector values of every lane: (H, bits), or with ``split``
    (H, 3, bits), the whole lane and its first and second halves (the
    same magnitudes under half masks)."""
    cfg = detector.cfg
    net_cfg = cfg.detection_net
    w = get_window(cfg.window, cfg.win_length or net_cfg.n_fft)
    lo, hi = in_band_bins(net_cfg.sample_rate, net_cfg.n_fft, cfg.embedding_bands)
    x = torch.as_tensor(np.asarray(audio, np.float32), device=detector.device)
    with torch.no_grad():
        mags = [preprocess_magnitude(_compensate(x, kind, rate), net_cfg.n_fft,
                                     cfg.hop_length, w, lo, hi)
                for kind, rate in hyps]
        t_max = max(m.shape[-1] for m in mags)
        mag_b = torch.stack([F.pad(m, (0, t_max - m.shape[-1])) for m in mags])
        t = torch.tensor([m.shape[-1] for m in mags], device=x.device)[:, None]
        frames = torch.arange(t_max, device=x.device)[None, :]
        mask = frames < t
        if split:
            half = t // 2
            mask = torch.stack([mask, frames < half, (frames >= half) & mask], dim=1)
        values = detector.net.forward_masked(mag_b, mask, cfg.matmul_precision)
    return values.cpu().numpy()


def robust_values(
    detector: AWAREDetector,
    audio: np.ndarray,
    rates: tuple[float, ...] = DEFAULT_RATES,
    stretch_rates: tuple[float, ...] = (),
) -> np.ndarray:
    """(H, bits) raw detector values for every compensation hypothesis
    (resample lanes first, then stretch lanes), in one masked forward."""
    return _grid_values(detector, audio, _hypotheses(rates, stretch_rates))


def robust_values_split(
    detector: AWAREDetector,
    audio: np.ndarray,
    rates: tuple[float, ...] = DEFAULT_RATES,
    stretch_rates: tuple[float, ...] = (),
) -> np.ndarray:
    """(H, 3, bits) raw detector values per hypothesis: the whole clip and
    its two halves, for coherence-based scoring."""
    return _grid_values(detector, audio, _hypotheses(rates, stretch_rates), split=True)


def _search(detector, audio, hyps: tuple[Hypothesis, ...],
            identity_margin: float = 1.0):
    """The most confident hypothesis of ``hyps``: (kind, rate, conf,
    values).  ``identity_margin > 1`` keeps the identity lane unless a
    non-identity lane beats its confidence by that factor (the JAX
    package's calibration: under genuine desync the right lane beats the
    identity by 2.3x or more, while on weak marks spurious lanes stay
    under 1.6x and always raise the BER)."""
    values = _grid_values(detector, audio, hyps)
    conf = np.mean(np.abs(values), axis=1)
    best = int(np.argmax(conf))
    if identity_margin > 1.0 and ("resample", 1.0) in hyps:
        ident = hyps.index(("resample", 1.0))
        if conf[best] < identity_margin * conf[ident]:
            best = ident
    kind, rate = hyps[best]
    return kind, rate, float(conf[best]), values[best]


def detect_watermark_robust(
    audio: np.ndarray,
    sample_rate: int,
    detector: AWAREDetector,
    rates: tuple[float, ...] = DEFAULT_RATES,
    stretch_rates: tuple[float, ...] = DEFAULT_STRETCH_RATES,
    return_confidence: bool = False,
    refine: bool = True,
    identity_margin: float = 1.9,
):
    """Detect under unknown time scaling; returns the decoded bits, or a
    :class:`RobustDetection` when ``return_confidence`` is set.

    Two stages: the coarse grid, then with ``refine`` (when the coarse
    winner is not the identity) a fine grid of +-1.5 % around the winner
    in its own family, in 0.5 % steps; the better of the two stages wins.
    ``identity_margin``: see :func:`_search` (coarse stage only).
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if sample_rate != detector.cfg.detection_net.sample_rate:
        raise ValueError(
            f"Robust detector operates at {detector.cfg.detection_net.sample_rate} Hz"
        )
    kind, best_rate, best_conf, best_values = _search(
        detector, audio, _hypotheses(rates, stretch_rates), identity_margin)

    if refine and best_rate != 1.0:
        fine = tuple((kind, round(best_rate * f, 4)) for f in REFINE_FACTORS)
        fkind, frate, fconf, fvalues = _search(detector, audio, fine)
        if fconf > best_conf:
            kind, best_rate, best_conf, best_values = fkind, frate, fconf, fvalues

    bits = decode_pattern(best_values, detector.pattern_mode, detector.threshold)
    if return_confidence:
        return RobustDetection(bits, kind, float(best_rate), float(best_conf))
    return bits
