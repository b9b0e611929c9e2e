"""The attack suite (``attacks.py``, the reference eval's 22 instances), the
real MP3 codec on the host (``mp3_real.py``), and the differentiable edits
of the embed solver's EOT views: the phase vocoder's time stretch and pitch
shift, the MDCT codec approximation and the CELP channel model.  The JAX
package's other host codecs (``voice_codecs``: Opus, GSM full-rate and
``extended_attack_suite``; ``av_codecs``; ``soxr_real``) are not ported."""

from aware_tpu_torch.attacks.attacks import (
    Attack,
    Cropout,
    DeleteSamples,
    GaussianNoise,
    HighPassFilter,
    LowPassFilter,
    MP3Compression,
    PCMBitDepthConversion,
    PitchShift,
    RandomBandstop,
    Resample,
    SampleSupression,
    SpeedChange,
    TimeStretch,
    default_attack_suite,
)
from aware_tpu_torch.attacks.celp import celp_approx
from aware_tpu_torch.attacks.codec import mp3_approx
from aware_tpu_torch.attacks.mp3_real import MP3CompressionReal, mp3_roundtrip
from aware_tpu_torch.attacks.mp3_real import available as mp3_real_available
from aware_tpu_torch.attacks.vocoder import pitch_shift, time_stretch

__all__ = [
    "Attack",
    "PCMBitDepthConversion",
    "MP3Compression",
    "DeleteSamples",
    "Cropout",
    "TimeStretch",
    "PitchShift",
    "Resample",
    "RandomBandstop",
    "SampleSupression",
    "LowPassFilter",
    "HighPassFilter",
    "GaussianNoise",
    "SpeedChange",
    "default_attack_suite",
    "mp3_approx",
    "celp_approx",
    "MP3CompressionReal",
    "mp3_roundtrip",
    "mp3_real_available",
    "time_stretch",
    "pitch_shift",
]
