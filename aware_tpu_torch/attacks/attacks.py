"""Signal-edit attack suite.

The port of ``aware_tpu/attacks/attacks.py``: the reference's attack
classes plus additive noise and speed change, each a small dataclass with
``apply(audio, sr, key=None, device=None) -> np.ndarray`` (numpy in and
out, computed with torch on ``device``: the CUDA card unless the caller
asks for the CPU), and ``default_attack_suite``, the reference eval's 22
instances in its order, with the same names.

* MP3Compression -> the MDCT perceptual-quantization approximation
  (``attacks/codec.py``); the real codec is ``attacks/mp3_real.py``;
* TimeStretch / PitchShift -> the phase vocoder (``attacks/vocoder.py``);
* the filters -> ``ops/iir.py`` (the scan kernels on the card, SOS
  cascades where float32 needs them).

The random attacks (DeleteSamples, RandomBandstop, SampleSupression,
GaussianNoise) take ``key``: an int seed or a ``torch.Generator``, never
the global random state.  Each splits into ``draw`` (the start, the band
or the noise, from torch's generator on the host for an int seed) and
``apply_drawn``, a deterministic function of the clip and the draw, so
that a caller can hand it any draw.  Torch's draws are another sample from
the distributions the JAX package draws from with ``jax.random``, not its
numbers.

Length-changing attacks (DeleteSamples, Cropout, TimeStretch) return
shorter or longer arrays, as the reference's: desync is the point.
"""

from __future__ import annotations

import dataclasses
import fractions

import numpy as np
import torch

from aware_tpu_torch.attacks.codec import mp3_approx
from aware_tpu_torch.attacks.vocoder import pitch_shift, time_stretch
from aware_tpu_torch.device import resolve_device
from aware_tpu_torch.ops.iir import butter, butter_sos, lfilter, sosfilt, sosfiltfilt
from aware_tpu_torch.ops.resample import resample_poly


def _tensor(audio, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.float32, copy=False)


def _generator(key) -> torch.Generator:
    if key is None:
        raise ValueError("this attack is randomized: pass key= (int seed or torch.Generator)")
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


class Attack:
    """Base attack (reference: attacks.py:16-30)."""

    name: str = "attack"

    def apply(self, audio: np.ndarray, sr: int, key=None, device=None) -> np.ndarray:
        raise NotImplementedError


class RandomAttack(Attack):
    """An attack whose randomness is one draw: ``apply`` is
    ``apply_drawn(audio, sr, draw(audio, sr, key))``."""

    def draw(self, audio: np.ndarray, sr: int, key):
        raise NotImplementedError

    def apply_drawn(self, audio: np.ndarray, sr: int, drawn, device=None) -> np.ndarray:
        raise NotImplementedError

    def apply(self, audio, sr, key=None, device=None):
        return self.apply_drawn(audio, sr, self.draw(audio, sr, key), device)


@dataclasses.dataclass
class PCMBitDepthConversion(Attack):
    """Quantize to signed 8/12/16/24-bit PCM and back (reference: :33-70),
    with the reference's truncating float->int cast."""

    pcm: int = 16

    _LEVELS = {8: (127.0, -128, 127), 12: (4095.0, -4096, 4095),
               16: (32767.0, -32768, 32767), 24: (8388607.0, -8388608, 8388607)}

    def __post_init__(self):
        if self.pcm not in self._LEVELS:
            raise ValueError(f"Unsupported PCM bit depth: {self.pcm}")
        self.name = f"pcm_{self.pcm}"

    def apply(self, audio, sr, key=None, device=None):
        return _numpy(self._apply(_tensor(audio, device)))

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        scale, lo, hi = self._LEVELS[self.pcm]
        x = x / (x.abs().max() + 1e-8)
        q = torch.trunc(torch.clamp(x * scale, lo, hi))  # C-cast truncation
        return q / scale


@dataclasses.dataclass
class MP3Compression(Attack):
    """The MDCT codec approximation (``mp3approx_{q}``); the real codec is
    ``attacks.mp3_real.MP3CompressionReal`` (``mp3_{q}``, reference:
    :73-148)."""

    quality: int = 2
    pcm_bits: int = 16

    def __post_init__(self):
        self.name = f"mp3approx_{self.quality}"

    def apply(self, audio, sr, key=None, device=None):
        pre = PCMBitDepthConversion(self.pcm_bits)._apply(_tensor(audio, device))
        return _numpy(mp3_approx(pre, sr, self.quality))


@dataclasses.dataclass
class DeleteSamples(RandomAttack):
    """Remove a random contiguous fraction: desync (reference: :151-178)."""

    percentage: float = 0.1

    def __post_init__(self):
        self.name = f"delete_{self.percentage}"

    def draw(self, audio, sr, key) -> int:
        """The start, uniform in [0, n - d)."""
        n = len(audio)
        d = int(self.percentage * n)
        return int(torch.randint(0, n - d, (), generator=_generator(key)))

    def apply_drawn(self, audio, sr, drawn, device=None):
        audio = np.asarray(audio)
        d = int(self.percentage * len(audio))
        return np.concatenate([audio[:drawn], audio[drawn + d :]])


@dataclasses.dataclass
class Cropout(Attack):
    """Drop the first percentage*sr samples (reference: :181-205)."""

    percentage: float = 0.1

    def __post_init__(self):
        self.name = f"cropout_{self.percentage}"

    def apply(self, audio, sr, key=None, device=None):
        return np.asarray(audio)[int(self.percentage * sr) :]


@dataclasses.dataclass
class TimeStretch(Attack):
    """Phase-vocoder speed change (reference: :208-228 via rubberband)."""

    rate: float = 1.0

    def __post_init__(self):
        self.name = f"ts_{self.rate}"

    def apply(self, audio, sr, key=None, device=None):
        return _numpy(time_stretch(_tensor(audio, device), self.rate))


@dataclasses.dataclass
class PitchShift(Attack):
    """Pitch shift by cents/100 semitones: the reference's unit quirk
    (5 'cents' -> 0.05 semitones) is kept (reference: :231-252)."""

    cents: float = 5

    def __post_init__(self):
        self.name = f"ps_{self.cents}"  # the reference names the default "ps_5"

    def apply(self, audio, sr, key=None, device=None):
        return _numpy(pitch_shift(_tensor(audio, device), self.cents / 100.0))


@dataclasses.dataclass
class Resample(Attack):
    """Rate round trip (reference: :256-294): naive decimation and linear
    re-interpolation when sr is a multiple of the target, else a 441/160
    polyphase round trip."""

    target_sr: int = 16000

    def __post_init__(self):
        self.name = f"resample_{self.target_sr}"

    def apply(self, audio, sr, key=None, device=None):
        factor = sr // self.target_sr
        if factor > 1:
            down = np.asarray(audio, np.float32)[::factor]
            t = np.arange(len(audio))
            tp = np.arange(0, len(audio), factor)
            return np.interp(t, tp, down).astype(np.float32)
        y = resample_poly(_tensor(audio, device), 441, 160)
        return _numpy(resample_poly(y, 160, 441))


@dataclasses.dataclass
class RandomBandstop(RandomAttack):
    """Zero-phase Butterworth stop of a random 200 Hz band in
    [min_freq, max_freq] (reference: :298-356), as an SOS cascade: the
    order-8 narrow bandstop is unstable in a float32 direct form."""

    band_width: float = 200.0
    min_freq: float = 300.0
    max_freq: float = 4000.0
    order: int = 4

    def __post_init__(self):
        self.name = f"bandstop_{int(self.band_width)}Hz"

    def draw(self, audio, sr, key) -> float:
        """The band's lower edge in Hz, uniform in [min_freq, max_freq - band_width)."""
        u = float(torch.rand((), generator=_generator(key), dtype=torch.float64))
        return self.min_freq + (self.max_freq - self.band_width - self.min_freq) * u

    def apply_drawn(self, audio, sr, drawn, device=None):
        nyq = sr / 2.0
        sos = butter_sos(self.order, (drawn / nyq, (drawn + self.band_width) / nyq), "bandstop")
        return _numpy(sosfiltfilt(sos, _tensor(audio, device)))


@dataclasses.dataclass
class SampleSupression(RandomAttack):
    """Zero a random percentage*sr window (reference: :359-385; the class
    name [sic] kept for API compatibility)."""

    percentage: float = 0.1

    def __post_init__(self):
        self.name = f"sample_supression_{self.percentage}"

    def draw(self, audio, sr, key) -> int:
        """The window's start, uniform in [0, n - d)."""
        d = int(self.percentage * sr)
        return int(torch.randint(0, len(audio) - d, (), generator=_generator(key)))

    def apply_drawn(self, audio, sr, drawn, device=None):
        d = int(self.percentage * sr)
        out = np.array(audio, copy=True)
        out[drawn : drawn + d] = 0
        return out


@dataclasses.dataclass
class LowPassFilter(Attack):
    """Causal Butterworth low-pass (reference: :388-423)."""

    cut_off: float = 4000.0
    order: int = 6

    def __post_init__(self):
        self.name = "low_pass"

    def apply(self, audio, sr, key=None, device=None):
        b, a = butter(self.order, self.cut_off / (0.5 * sr), "low")
        return _numpy(lfilter(b, a, _tensor(audio, device)))


@dataclasses.dataclass
class HighPassFilter(Attack):
    """Causal Butterworth high-pass (reference: :426-455), an SOS cascade
    for the float32 stability of the near-DC poles."""

    cut_off: float = 500.0
    order: int = 4

    def __post_init__(self):
        self.name = "high_pass"

    def apply(self, audio, sr, key=None, device=None):
        sos = butter_sos(self.order, self.cut_off / (0.5 * sr), "high")
        return _numpy(sosfilt(sos, _tensor(audio, device)))


@dataclasses.dataclass
class SpeedChange(Attack):
    """Playback-rate change (tape or vinyl speed): a resampling desync that
    shifts both time base and pitch."""

    rate: float = 1.05

    def __post_init__(self):
        self.name = f"speed_{self.rate}"

    def apply(self, audio, sr, key=None, device=None):
        frac = fractions.Fraction(self.rate).limit_denominator(64)
        return _numpy(resample_poly(_tensor(audio, device), frac.numerator, frac.denominator))


@dataclasses.dataclass
class GaussianNoise(RandomAttack):
    """Additive white noise at a target SNR."""

    snr_db: float = 30.0

    def __post_init__(self):
        self.name = f"noise_{self.snr_db}dB"

    def draw(self, audio, sr, key) -> torch.Tensor:
        """Standard normal noise of the clip's shape (on the generator's device)."""
        g = _generator(key)
        return torch.randn(np.shape(audio), generator=g, device=g.device)

    def apply_drawn(self, audio, sr, drawn, device=None):
        x = _tensor(audio, device)
        p_sig = (x**2).mean()
        p_noise = p_sig / (10.0 ** (self.snr_db / 10.0))
        noise = torch.sqrt(p_noise) * torch.as_tensor(drawn, dtype=x.dtype, device=x.device)
        return _numpy(x + noise)


def default_attack_suite(real_mp3: bool | None = None) -> list[Attack]:
    """The reference eval harness's 22 attack instances
    (reference: scripts/test.py:15-18), in its order.

    The four MP3 rows run the real codec (``mp3_{q}``:
    ``attacks.mp3_real``, libmp3lame + libmpg123 on the host) where the
    libraries load, else the MDCT approximation (``mp3approx_{q}``);
    ``real_mp3=False`` forces the approximation, ``real_mp3=True`` the
    codec (raising where its libraries are missing)."""
    from aware_tpu_torch.attacks import mp3_real

    if real_mp3 is None:
        real_mp3 = mp3_real.available()
    mp3_cls = mp3_real.MP3CompressionReal if real_mp3 else MP3Compression
    return [
        PCMBitDepthConversion(8), PCMBitDepthConversion(12),
        PCMBitDepthConversion(16), PCMBitDepthConversion(24),
        mp3_cls(9), mp3_cls(5), mp3_cls(2),
        mp3_cls(0),
        DeleteSamples(0.1), DeleteSamples(0.15), DeleteSamples(0.2),
        TimeStretch(0.8), TimeStretch(0.9), TimeStretch(1.1), TimeStretch(1.2),
        PitchShift(),
        Resample(),
        RandomBandstop(),
        SampleSupression(0.1), SampleSupression(0.25),
        LowPassFilter(), HighPassFilter(),
    ]
