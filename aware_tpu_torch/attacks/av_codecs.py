"""Real codec attacks via the in-process libavcodec shim.

A copy of ``aware_tpu/attacks/av_codecs.py`` over the port's own copy of
the shim (``_native/aware_codecs.cc``), with its names, rows and errors.
Host code: the attack classes' ``apply`` takes the other attacks'
``device`` and ignores it.

The reference's only lossy-codec attack is MP3 (reference:
scripts/attacks.py:73-148, shelling out to the ffmpeg binary).  The FFmpeg
5.1 *libraries* with their dev headers are enough: the shim runs any
encoder→decoder pair fully in-process (raw packets, no container) and this
module exposes the deployment-relevant families as harness attacks:

* **AAC** (``aac_{kbps}k``) — the most widely deployed lossy codec
  (streaming, broadcast, Bluetooth); FFmpeg's native encoder at the
  input rate (16 kHz is AAC-native).
* **Vorbis** (``vorbis_q{q}``) — libvorbis VBR, the classic open codec.
* **Speex** (``speex_wb``) — legacy VoIP wideband (libspeex at 16 kHz).
* **G.722** (``g722``) — 64 kb/s wideband telephony ADPCM, natively
  16 kHz: exactly the conferencing leg a speech watermark crosses.

The shim is built at first use, never at import, by
``native.build_host_library`` (g++ with ``-lavcodec -lavutil
-lswresample``, into ``aware_tpu_torch/_build/`` under a name that carries
the hash of the source and the flags).  All decode legs are aligned to the
input by cross-correlation and trimmed to the input length (the shared
``voice_codecs._align``).  Everything degrades loudly: where the shim
cannot be built or a codec is absent, :func:`avc_available` is False and
says why in :func:`avc_unavailable_reason` (the compiler's first error
line; ``build_codecs`` raises with its whole output), the extended suite
leaves the row out, and the class raises at construction.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np

from aware_tpu_torch.attacks.voice_codecs import _align
from aware_tpu_torch.native import PACKAGE, build_host_library

__all__ = [
    "avc_available",
    "avc_roundtrip",
    "avc_unavailable_reason",
    "AACCompression",
    "VorbisCompression",
    "SpeexWideband",
    "G722Telephony",
]

SOURCE = PACKAGE / "_native" / "aware_codecs.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
LIBS = ("-lavcodec", "-lavutil", "-lswresample")


def build_codecs():
    """Compile the shim if it is not built yet; returns its path and raises
    RuntimeError, with the compiler's output, where it cannot."""
    return build_host_library(SOURCE, "libaware_codecs", CXX_FLAGS, LIBS)


@functools.lru_cache(maxsize=1)
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """(the shim, None), or (None, why it cannot be built or loaded)."""
    try:
        lib = ctypes.CDLL(str(build_codecs()))
    except (RuntimeError, OSError) as err:
        return None, str(err)
    lib.aware_avc_has.restype = ctypes.c_int
    lib.aware_avc_has.argtypes = [ctypes.c_char_p]
    lib.aware_avc_roundtrip.restype = ctypes.c_int
    lib.aware_avc_roundtrip.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    return lib, None


def _lib() -> ctypes.CDLL | None:
    return _load()[0]


def avc_available(codec: str | None = None) -> bool:
    """True when the shim builds/loads (and, if given, `codec` exists)."""
    lib = _lib()
    if lib is None:
        return False
    return codec is None or bool(lib.aware_avc_has(codec.encode()))


def avc_unavailable_reason(codec: str | None = None) -> str | None:
    """Why :func:`avc_available` is False for ``codec``, on one line (the
    compiler's first error line where the build failed); None where it is
    True."""
    lib, err = _load()
    if lib is None:
        lines = err.splitlines() or [""]
        cause = next((ln.strip() for ln in lines if "error" in ln), lines[0])
        return f"the libavcodec shim cannot be built or loaded: {cause}"
    if codec is not None and not lib.aware_avc_has(codec.encode()):
        return f"this libavcodec has no {codec!r} encoder and decoder pair"
    return None


def avc_roundtrip(
    x: np.ndarray,
    sr: int,
    codec: str,
    bitrate_bps: int = 0,
    q_scale: float = -1.0,
) -> np.ndarray:
    """Encode→decode mono float32 through a real libavcodec codec.

    ``bitrate_bps`` > 0 selects bitrate mode; else ``q_scale`` >= 0
    selects the encoder's VBR quality mode; both unset means codec
    defaults.  Output is delay-aligned and trimmed to ``len(x)``.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("libaware_codecs.so unavailable (no libavcodec?)")
    mono = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
    cap = len(mono) + 3 * sr + 8192  # room for codec delay + rate slack
    enospc = -28  # AVERROR(ENOSPC): native shim reports a truncated decode
    for _ in range(3):  # grow the buffer if a codec expands more than that
        out = np.zeros(cap, np.float32)
        n = lib.aware_avc_roundtrip(
            codec.encode(), int(sr), int(bitrate_bps), float(q_scale),
            mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(mono),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        )
        if n != enospc:
            break
        cap *= 2
    if n <= 0:
        raise RuntimeError(f"avc roundtrip failed for {codec!r}: rc={n}")
    return _align(out[:n], mono)


def _require(codec: str, row: str) -> None:
    if not avc_available(codec):
        raise RuntimeError(
            f"libavcodec codec {codec!r} unavailable — {row} attack "
            "cannot run (the rest of the suite still works)"
        )


@dataclasses.dataclass
class AACCompression:
    """Real AAC-LC round-trip (no reference counterpart — the reference
    stops at MP3; AAC is the dominant deployed lossy codec)."""

    bitrate_kbps: int = 64

    def __post_init__(self):
        self.name = f"aac_{self.bitrate_kbps}k"
        _require("aac", self.name)

    def apply(self, audio, sr, key=None, device=None):
        return avc_roundtrip(audio, sr, "aac", self.bitrate_kbps * 1000)


@dataclasses.dataclass
class VorbisCompression:
    """Real Vorbis VBR round-trip via libvorbis (quality -1..10)."""

    quality: float = 3.0

    def __post_init__(self):
        self.name = f"vorbis_q{self.quality:g}"
        _require("libvorbis", self.name)

    def apply(self, audio, sr, key=None, device=None):
        return avc_roundtrip(audio, sr, "libvorbis", 0, self.quality)


@dataclasses.dataclass
class SpeexWideband:
    """Legacy VoIP wideband leg: libspeex at its native 16 kHz.

    Speex is parametric CELP — it does NOT preserve waveform phase, so
    the decoded clip's waveform SNR vs the input is near 0 dB even
    though speech (and spectral magnitudes) come through.  That makes
    this the harshest codec row in the suite by design.
    """

    def __post_init__(self):
        self.name = "speex_wb"
        _require("libspeex", self.name)

    def apply(self, audio, sr, key=None, device=None):
        return avc_roundtrip(audio, sr, "libspeex")


@dataclasses.dataclass
class G722Telephony:
    """G.722 64 kb/s wideband-telephony ADPCM (natively 16 kHz)."""

    def __post_init__(self):
        self.name = "g722"
        _require("g722", self.name)

    def apply(self, audio, sr, key=None, device=None):
        return avc_roundtrip(audio, sr, "g722", 64000)
