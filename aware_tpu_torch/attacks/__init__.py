"""The attack suite (``attacks.py``, the reference eval's 22 instances), the
real codecs on the host (``mp3_real.py``: MP3; ``voice_codecs.py``: Opus,
GSM full-rate and ``extended_attack_suite``, the 22 rows plus every real
codec row this machine's libraries support; ``av_codecs.py``: AAC, Vorbis,
Speex and G.722 through the libavcodec shim; ``soxr_real.py``: the SoX
resampler), and the differentiable edits of the embed solver's EOT views:
the phase vocoder's time stretch and pitch shift, the MDCT codec
approximation and the CELP channel model (the voice card's real codec
views call ``voice_codecs``)."""

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
from aware_tpu_torch.attacks.voice_codecs import (
    GSMFullRate,
    OpusCompression,
    extended_attack_suite,
    gsm_roundtrip,
    opus_roundtrip,
)
from aware_tpu_torch.attacks.av_codecs import (
    AACCompression,
    G722Telephony,
    SpeexWideband,
    VorbisCompression,
    avc_available,
    avc_roundtrip,
)
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
    "OpusCompression",
    "GSMFullRate",
    "opus_roundtrip",
    "gsm_roundtrip",
    "extended_attack_suite",
    "AACCompression",
    "VorbisCompression",
    "SpeexWideband",
    "G722Telephony",
    "avc_available",
    "avc_roundtrip",
    "time_stretch",
    "pitch_shift",
]
