"""Wideband PESQ (ITU-T P.862.2) — host-side numpy implementation.

The reference reports PESQ through the ``pesq`` C-extension package
(reference: src/AWARE/metrics/audio.py:19-39, mode ``'wb'`` at 16 kHz).
That package is not in this image, so this module implements the P.862
algorithm itself (perceptual model of P.862 with the P.862.2 wideband
input filter and MOS-LQO mapping), following the structure of the ITU
reference implementation:

    level alignment (350-3250 Hz band power -> 1e7)
    -> wideband input high-pass IIR
    -> global time alignment (FFT cross-correlation, sample-exact)
    -> perceptual model:
         1024-point Hann frames, hop 512
         -> 49-band Bark grouping of the power spectrum
         -> frequency-response compensation of the reference (band ratio
            of time-averaged audible spectra, clamped to [0.01, 100])
         -> slowly-varying local gain compensation of the degraded signal
            (per-frame audible-power ratio, 0.8/0.2 smoothed, in [3e-4, 5])
         -> Zwicker loudness transform (power 0.23, low-band exponent
            correction h = min((6/(z+2)), 2)^0.15)
         -> center-clipped loudness difference (deadzone 0.25*min)
         -> symmetric disturbance: band-width-weighted L2 over bands
         -> asymmetric disturbance: Bark-ratio^1.2 factor in [3 cut, 12 cap]
            times the signed difference, L1 over bands
         -> per-frame weighting ((P_ref+1e5)/1e7)^0.04, clip at 45
         -> L6 over 20-frame "syllables" every 10 frames, then L2 over time
    -> raw PESQ = 4.5 - 0.1*d_symm - 0.0309*d_asymm
    -> P.862.2 MOS-LQO = 0.999 + 4.0 / (1 + exp(-1.3669*raw + 3.8224))

Exactness statement (be honest about what this is):

* The pipeline structure, the constants named above, and the MOS-LQO map
  are the ITU algorithm's.
* The 49-band Bark discretization tables (band edges, widths, power
  correction, absolute-threshold-in-quiet) are RECONSTRUCTED — uniform
  Bark spacing of the Zwicker scale over 0-8 kHz, thresholds from the
  Terhardt threshold-in-quiet curve anchored at 1e7 internal power
  = 79.3 dB SPL — because the ITU tables are not reproducible in this
  offline image.  Scores are therefore not bit-identical to the ITU tool;
  validated properties (tests/test_pesq.py): identity = 4.644 (the P.862.2
  maximum), level invariance, small-delay invariance, monotonicity in
  noise/distortion, and sane absolute placement for common degradations.
* Utterance splitting and bad-interval re-alignment of P.862 time
  alignment are omitted: this metric is used on time-aligned pairs
  (embed output vs input); crude alignment handles constant offsets.

Everything is float64 numpy on host; metrics are reporting-side, not part
of the device compute path.  (A copy of ``aware_tpu/metrics/pesq_p862.py``.)
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import lfilter

# ----------------------------------------------------------- constants ---

FS = 16000
NF = 1024                 # frame length (Align_Nfft for 16 k)
HOP = NF // 2
NB = 49                   # Bark bands
DOWNSAMPLE = 64           # VAD window (16 k)
SEARCHBUFFER = 75         # alignment guard, in DOWNSAMPLE units
DATAPADDING = 320 * (FS // 1000)   # 320 ms zero padding
TARGET_AVG_POWER = 1e7

SP = 6.910853e-6          # power-spectrum scale (16 k model)
SL = 1.866055e-1          # loudness scale (16 k model)
ZWICKER_POWER = 0.23

D_POW_F, D_POW_S, D_POW_T = 2.0, 6.0, 2.0
A_POW_F, A_POW_S, A_POW_T = 1.0, 6.0, 2.0
D_WEIGHT, A_WEIGHT = 0.1, 0.0309
FRAMES_PER_SYLLABLE = 20

# P.862.2 wideband input filter (single high-pass biquad, ~100 Hz)
WB_IIR_B = np.array([2.6657628, -5.3315255, 2.6657628])
WB_IIR_A = np.array([1.0, -1.8890331, 0.89487434])

# level-alignment band (piecewise-linear dB gain, brick wall outside)
_ALIGN_FILTER_DB = np.array([
    [0, -500], [50, -500], [100, -500], [125, -500], [160, -500],
    [200, -500], [250, -500], [300, -500], [350, 0], [400, 0],
    [500, 0], [600, 0], [630, 0], [800, 0], [1000, 0], [1250, 0],
    [1600, 0], [2000, 0], [2500, 0], [3000, 0], [3250, 0],
    [3500, -500], [4000, -500], [5000, -500], [6300, -500], [8000, -500],
], dtype=np.float64)


# ------------------------------------------------------------ bark scale ---

def _hz_to_bark(f):
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@functools.lru_cache(maxsize=1)
def _band_tables():
    """Reconstructed 49-band discretization (see module docstring):
    returns (bin_band_index (NF//2,), centre_hz, width_bark, abs_thresh)."""
    df = FS / NF
    # FFT bins 0..NF/2-1 (the ITU model consumes NF/2 spectral values)
    f_bin = (np.arange(NF // 2) + 0.5) * df
    z_edges = np.linspace(0.0, _hz_to_bark(FS / 2), NB + 1)
    band_of_bin = np.clip(
        np.searchsorted(z_edges, _hz_to_bark(f_bin), side="right") - 1, 0, NB - 1
    )
    centre_hz = np.array([
        f_bin[band_of_bin == b].mean() if np.any(band_of_bin == b)
        else 0.5 * (z_edges[b] + z_edges[b + 1])  # unused fallback
        for b in range(NB)
    ])
    width_bark = np.diff(z_edges)
    # Terhardt threshold-in-quiet (dB SPL), anchored at 1e7 <-> 79.3 dB SPL
    khz = np.maximum(centre_hz / 1000.0, 0.02)
    tq_db = (
        3.64 * khz ** -0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz ** 4
    )
    abs_thresh = 1e7 / (10 ** 7.93) * 10 ** (tq_db / 10.0)
    return band_of_bin, centre_hz, width_bark, abs_thresh


# ------------------------------------------------------- pre-processing ---

def _apply_align_filter(x: np.ndarray) -> np.ndarray:
    """One-shot FFT filtering with the piecewise-linear dB response."""
    n = len(x)
    nfft = int(2 ** np.ceil(np.log2(n)))
    spec = np.fft.rfft(x, nfft)
    f = np.fft.rfftfreq(nfft, 1.0 / FS)
    gain_db = np.interp(f, _ALIGN_FILTER_DB[:, 0], _ALIGN_FILTER_DB[:, 1])
    spec *= 10 ** (gain_db / 20.0)
    return np.fft.irfft(spec, nfft)[:n]


def _fix_power_level(x: np.ndarray, n_orig: int) -> np.ndarray:
    """Scale so the 350-3250 Hz band power over the evaluation region is
    TARGET_AVG_POWER (1e7)."""
    filt = _apply_align_filter(x)
    a = SEARCHBUFFER * DOWNSAMPLE
    b = n_orig - SEARCHBUFFER * DOWNSAMPLE + DATAPADDING
    seg = filt[a:b]
    power = np.mean(seg ** 2) + 1e-20
    return x * np.sqrt(TARGET_AVG_POWER / power)


def _align_delay(ref: np.ndarray, deg: np.ndarray) -> int:
    """Global delay of ``deg`` vs ``ref`` in samples, by FFT
    cross-correlation, clamped to ±SEARCHBUFFER·DOWNSAMPLE.

    Replaces P.862's crude (log-VAD) + fine (frame-histogram) alignment
    with a sample-exact global estimate — equivalent for constant delays,
    which is the only alignment case this metric is applied to (embed
    output vs input; codec/filter constant group delays).  Per-utterance
    variable delay and utterance splitting are out of scope (documented)."""
    n = min(len(ref), len(deg))
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    r = np.fft.rfft(ref[:n], nfft)
    d = np.fft.rfft(deg[:n], nfft)
    corr = np.fft.irfft(d * np.conj(r), nfft)
    max_delay = SEARCHBUFFER * DOWNSAMPLE
    lags = np.concatenate([np.arange(0, max_delay + 1),
                           np.arange(-max_delay, 0)])
    vals = np.concatenate([corr[: max_delay + 1], corr[-max_delay:]])
    if not np.any(np.abs(vals) > 0):
        return 0
    return int(lags[np.argmax(vals)])


# ------------------------------------------------------ perceptual model ---

def _frame_spectra(x: np.ndarray, n_frames: int, offset: int) -> np.ndarray:
    """(n_frames, NF//2) power spectra of Hann-windowed frames starting at
    ``offset + k*HOP``."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(NF) / NF))
    starts = offset + np.arange(n_frames) * HOP
    idx = starts[:, None] + np.arange(NF)[None, :]
    frames = x[idx] * w
    spec = np.fft.rfft(frames, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2)[:, : NF // 2]


def _bark_spectra(power_spec: np.ndarray) -> np.ndarray:
    """(n_frames, NB) 'pitch power densities' — band-summed, Sp-scaled."""
    band_of_bin, _, _, _ = _band_tables()
    out = np.zeros((power_spec.shape[0], NB))
    np.add.at(out.T, band_of_bin, power_spec.T)
    return out * SP


def _total_audible(bark: np.ndarray, factor: float) -> np.ndarray:
    """Per-frame total power of bands exceeding factor*abs_threshold
    (band 0 excluded, as in the ITU model)."""
    _, _, _, thr = _band_tables()
    audible = np.where(bark[:, 1:] > factor * thr[None, 1:], bark[:, 1:], 0.0)
    return np.sum(audible, axis=1)


def _loudness(bark: np.ndarray) -> np.ndarray:
    """Zwicker loudness densities (n_frames, NB)."""
    _, _, _, thr = _band_tables()
    _, _, width, _ = _band_tables()
    _, centre_hz, _, _ = _band_tables()
    z = _hz_to_bark(centre_hz)
    h = np.minimum(np.where(z < 4.0, 6.0 / (z + 2.0), 1.0), 2.0) ** 0.15
    zp = ZWICKER_POWER * h
    ratio = 0.5 + 0.5 * bark / thr[None, :]
    loud = (thr[None, :] / 0.5) ** zp[None, :] * (ratio ** zp[None, :] - 1.0)
    loud = np.where(bark > thr[None, :], loud, 0.0)
    return SL * loud


def _pseudo_lp(d: np.ndarray, p: float) -> np.ndarray:
    """Band-width-weighted Lp over bands 1..NB-1, per frame (the ITU
    pseudo-Lp: result = (sum((|d|*w)^p)/W)^(1/p) * W)."""
    _, _, width, _ = _band_tables()
    w = width[1:]
    total_w = np.sum(w)
    s = np.sum((np.abs(d[:, 1:]) * w[None, :]) ** p, axis=1) / total_w
    return s ** (1.0 / p) * total_w


def _lpq_weight(frame_disturbance: np.ndarray, p_syllable: float,
                p_time: float) -> float:
    """L_{p_syllable} over 20-frame windows every 10 frames, then
    L_{p_time} over windows."""
    n = len(frame_disturbance)
    vals = []
    for start in range(0, n, FRAMES_PER_SYLLABLE // 2):
        chunk = frame_disturbance[start : start + FRAMES_PER_SYLLABLE]
        # the ITU loop divides by the full syllable length even when the
        # window overruns the end (missing frames count as zeros)
        s = np.sum(chunk ** p_syllable) / FRAMES_PER_SYLLABLE
        vals.append(s ** (1.0 / p_syllable))
    vals = np.asarray(vals)
    return float((np.mean(vals ** p_time)) ** (1.0 / p_time))


def _raw_pesq(ref: np.ndarray, deg: np.ndarray, n_orig: int, delay: int) -> float:
    """Perceptual-model raw score of pre-processed, level-aligned signals."""
    offset_ref = SEARCHBUFFER * DOWNSAMPLE
    offset_deg = offset_ref + delay
    usable = n_orig - 2 * SEARCHBUFFER * DOWNSAMPLE + DATAPADDING
    n_frames = usable // HOP - 1
    # keep every frame inside both (padded) buffers
    while (
        offset_deg + (n_frames - 1) * HOP + NF > len(deg)
        or offset_ref + (n_frames - 1) * HOP + NF > len(ref)
    ):
        n_frames -= 1
    if n_frames < 1:
        raise ValueError("signal too short for PESQ (needs > 0.35 s)")

    bark_ref = _bark_spectra(_frame_spectra(ref, n_frames, offset_ref))
    bark_deg = _bark_spectra(_frame_spectra(deg, n_frames, max(offset_deg, 0)))

    _, _, _, thr = _band_tables()

    # frame activity (silent = total audible power at factor 100 < 1e7)
    pow_ref_100 = _total_audible(bark_ref, 100.0)
    silent = pow_ref_100 < 1e7

    # frequency-response compensation of the reference
    def _time_avg_audible(bark):
        mask = (~silent)[:, None] & (bark > 100.0 * thr[None, :])
        return np.sum(np.where(mask, bark, 0.0), axis=0) / len(bark)

    avg_ref = _time_avg_audible(bark_ref)
    avg_deg = _time_avg_audible(bark_deg)
    band_ratio = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    mod_ref = bark_ref * band_ratio[None, :]

    # slowly-varying local gain compensation of the degraded signal
    pow_ref = _total_audible(mod_ref, 1.0)
    pow_deg = _total_audible(bark_deg, 1.0)
    scale = np.empty(n_frames)
    s_prev = None
    for i in range(n_frames):
        s = (pow_ref[i] + 5e3) / (pow_deg[i] + 5e3)
        if s_prev is not None:
            s = 0.2 * s_prev + 0.8 * s
        s_prev = s
        scale[i] = np.clip(s, 3e-4, 5.0)
    scaled_deg = bark_deg * scale[:, None]

    loud_ref = _loudness(mod_ref)
    loud_deg = _loudness(scaled_deg)

    # center-clipped loudness difference
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    d_frame = _pseudo_lp(d, D_POW_F)

    # asymmetry factor from the raw Bark spectra
    asym = ((scaled_deg + 50.0) / (mod_ref + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))
    a_frame = _pseudo_lp(d * asym, A_POW_F)

    h = ((pow_ref_100 + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / h, 45.0)
    a_frame = np.minimum(a_frame / h, 45.0)

    d_symm = _lpq_weight(d_frame, D_POW_S, D_POW_T)
    d_asym = _lpq_weight(a_frame, A_POW_S, A_POW_T)

    return 4.5 - D_WEIGHT * d_symm - A_WEIGHT * d_asym


def _mos_lqo_wb(raw: float) -> float:
    """P.862.2 mapping (exact): raw PESQ -> wideband MOS-LQO."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


# ------------------------------------------------------------ public API ---

def pesq_wb(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> float:
    """Wideband PESQ MOS-LQO of ``deg`` against clean ``ref``.

    Argument order matches ``pesq.pesq(fs, ref, deg, 'wb')``.  Arbitrary
    input rates are polyphase-resampled to 16 kHz first (the reference
    wrapper does the same via librosa — metrics/audio.py:36-38).
    """
    ref = np.asarray(ref, dtype=np.float64).ravel()
    deg = np.asarray(deg, dtype=np.float64).ravel()
    if fs != FS:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(FS, fs)
        ref = resample_poly(ref, FS // g, fs // g)
        deg = resample_poly(deg, FS // g, fs // g)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < FS // 2:
        raise ValueError("PESQ needs at least 0.5 s of audio")

    guard = SEARCHBUFFER * DOWNSAMPLE
    pad = np.zeros(guard)
    tail = np.zeros(guard + DATAPADDING)
    ref_p = np.concatenate([pad, ref, tail])
    deg_p = np.concatenate([pad, deg, tail])
    n_padded = n + 2 * guard

    ref_p = _fix_power_level(ref_p, n_padded)
    deg_p = _fix_power_level(deg_p, n_padded)

    ref_p = lfilter(WB_IIR_B, WB_IIR_A, ref_p)
    deg_p = lfilter(WB_IIR_B, WB_IIR_A, deg_p)

    delay = _align_delay(ref_p[guard : guard + n], deg_p[guard : guard + n])

    raw = _raw_pesq(ref_p, deg_p, n_padded, delay)
    return float(_mos_lqo_wb(raw))
