"""Real voice-codec attacks: Opus and GSM 06.10, and the extended suite.

A copy of ``aware_tpu/attacks/voice_codecs.py`` (ctypes, numpy and scipy,
no device code), with its names, rows and errors: the codecs run on the
host whatever the device of the other attacks, and the attack classes'
``apply`` takes that ``device`` and ignores it, as
``mp3_real.MP3CompressionReal`` does.

The reference's only lossy-codec attack is MP3 (reference:
scripts/attacks.py:73-148).  Production speech watermarks face modern
transport codecs too — Opus dominates WebRTC/VoIP/streaming, and GSM
full-rate is the classic telephony floor — so both system libraries
(``libopus.so.0``, ``libgsm.so.1``) are bound in-process with ctypes
exactly like :mod:`aware_tpu_torch.attacks.mp3_real`.

* :func:`opus_roundtrip` — frame-based encode/decode at the input rate
  (Opus natively supports 16 kHz), VoIP or audio application, bitrate
  sweepable down to 6 kb/s.  No container needed: packets are passed
  straight from encoder to decoder.
* :func:`gsm_roundtrip` — GSM 06.10 full-rate at its native 8 kHz; for
  other input rates the chain resamples in→8k→codec→in with scipy's
  polyphase resampler, which is exactly the telephony path a watermark
  must survive.

Both align the decode to the input by cross-correlation (codec lookahead
/ algorithmic delay) and trim to the input length, so they compose with
the eval harness like every other attack.  All symbols degrade loudly
when a library is missing.

The voice card's straight-through views (``embed/solver.py``) call
:func:`opus_roundtrip` and :func:`gsm_roundtrip` once a lane an iteration.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np

from aware_tpu_torch.attacks.mp3_real import _load_first

__all__ = [
    "opus_available",
    "gsm_available",
    "opus_roundtrip",
    "gsm_roundtrip",
    "OpusCompression",
    "GSMFullRate",
    "extended_attack_suite",
    "extended_rows_left_out",
]

# ------------------------------------------------------------------- opus

_OPUS_APPLICATION_VOIP = 2048
_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_RATES = (8000, 12000, 16000, 24000, 48000)
_OPUS_NAMES = ("libopus.so.0", "libopus.so", "opus")
_GSM_NAMES = ("libgsm.so.1", "libgsm.so", "gsm")


@functools.lru_cache(maxsize=1)
def _opus():
    lib = _load_first(_OPUS_NAMES)
    if lib is None:
        return None
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_encode_float.restype = ctypes.c_int
    lib.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_decode_float.restype = ctypes.c_int
    lib.opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    # variadic ctl, but our only use is (handle, request, int32); declaring
    # fixed argtypes keeps ctypes from truncating the 64-bit handle
    lib.opus_encoder_ctl.restype = ctypes.c_int
    lib.opus_encoder_ctl.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def opus_available() -> bool:
    return _opus() is not None


def opus_roundtrip(
    x: np.ndarray,
    sr: int,
    bitrate_bps: int = 24000,
    voip: bool = True,
) -> np.ndarray:
    """Encode→decode mono float32 through real Opus at ``bitrate_bps``.

    Uses 20 ms frames at the input rate (must be an Opus-native rate;
    16 kHz — the framework's model rate — is).  Packets go straight from
    :c:func:`opus_encode_float` to :c:func:`opus_decode_float`.
    """
    lib = _opus()
    if lib is None:
        raise RuntimeError("libopus not available in this image")
    if sr not in _OPUS_RATES:
        raise ValueError(f"Opus supports {_OPUS_RATES}, got {sr}")
    mono = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
    frame = sr // 50  # 20 ms
    pad = (-len(mono)) % frame
    padded = np.concatenate([mono, np.zeros(pad, np.float32)])
    err = ctypes.c_int(0)
    app = _OPUS_APPLICATION_VOIP if voip else _OPUS_APPLICATION_AUDIO
    enc = lib.opus_encoder_create(sr, 1, app, ctypes.byref(err))
    if not enc or err.value:
        raise RuntimeError(f"opus_encoder_create failed: {err.value}")
    dec = lib.opus_decoder_create(sr, 1, ctypes.byref(err))
    if not dec or err.value:
        lib.opus_encoder_destroy(enc)
        raise RuntimeError(f"opus_decoder_create failed: {err.value}")
    try:
        lib.opus_encoder_ctl(
            enc, ctypes.c_int(_OPUS_SET_BITRATE),
            ctypes.c_int(int(bitrate_bps)),
        )
        pkt = (ctypes.c_ubyte * 4000)()
        # zeros, not empty: a short decode (DTX/short packet, m < frame)
        # must leave silence in the uncovered tail, never uninitialized
        # memory flowing into the attacked audio
        out = np.zeros_like(padded)
        pcm_out = (ctypes.c_float * frame)()
        for i in range(0, len(padded), frame):
            chunk = padded[i : i + frame]
            n = lib.opus_encode_float(
                enc, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame, pkt, len(pkt),
            )
            if n < 0:
                raise RuntimeError(f"opus_encode_float failed: {n}")
            m = lib.opus_decode_float(dec, pkt, n, pcm_out, frame, 0)
            if m < 0:
                raise RuntimeError(f"opus_decode_float failed: {m}")
            out[i : i + m] = np.ctypeslib.as_array(pcm_out, (frame,))[:m]
    finally:
        lib.opus_encoder_destroy(enc)
        lib.opus_decoder_destroy(dec)
    return _align(out, mono)


# -------------------------------------------------------------------- gsm

_GSM_FRAME = 160        # 20 ms at the codec's native 8 kHz
_GSM_PACKED = 33        # bytes per encoded frame


@functools.lru_cache(maxsize=1)
def _gsm():
    lib = _load_first(_GSM_NAMES)
    if lib is None:
        return None
    lib.gsm_create.restype = ctypes.c_void_p
    lib.gsm_destroy.argtypes = [ctypes.c_void_p]
    lib.gsm_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.gsm_decode.restype = ctypes.c_int
    lib.gsm_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int16),
    ]
    return lib


def gsm_available() -> bool:
    return _gsm() is not None


def gsm_resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """The telephony leg's polyphase resample (scipy ``resample_poly``,
    float32 out); ``x`` itself at equal rates."""
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(sr_out, sr_in)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def gsm_roundtrip(x: np.ndarray, sr: int) -> np.ndarray:
    """GSM 06.10 full-rate round-trip (native 8 kHz; resampled chain for
    other rates — the realistic telephony leg for a 16 kHz watermark)."""
    lib = _gsm()
    if lib is None:
        raise RuntimeError("libgsm not available in this image")
    mono = np.asarray(x, np.float32).reshape(-1)
    work = gsm_resample(mono, sr, 8000)
    pcm = np.clip(work * 32767.0, -32768, 32767).astype(np.int16)
    pad = (-len(pcm)) % _GSM_FRAME
    pcm = np.concatenate([pcm, np.zeros(pad, np.int16)])
    h = lib.gsm_create()
    if not h:
        raise RuntimeError("gsm_create failed")
    hd = lib.gsm_create()
    try:
        out = np.empty_like(pcm)
        buf = (ctypes.c_ubyte * _GSM_PACKED)()
        frame = (ctypes.c_int16 * _GSM_FRAME)()
        for i in range(0, len(pcm), _GSM_FRAME):
            chunk = np.ascontiguousarray(pcm[i : i + _GSM_FRAME])
            ctypes.memmove(frame, chunk.ctypes.data, _GSM_FRAME * 2)
            lib.gsm_encode(h, frame, buf)
            if lib.gsm_decode(hd, buf, frame) < 0:
                raise RuntimeError("gsm_decode failed")
            out[i : i + _GSM_FRAME] = np.ctypeslib.as_array(
                frame, (_GSM_FRAME,)
            )
    finally:
        lib.gsm_destroy(h)
        lib.gsm_destroy(hd)
    y = gsm_resample(out.astype(np.float32) / 32767.0, 8000, sr)
    return _align(y, mono)


# ---------------------------------------------------------------- shared

def _align(y: np.ndarray, ref: np.ndarray, max_lag: int = 4096) -> np.ndarray:
    """Cross-correlation delay alignment + trim/pad to len(ref).

    Codec algorithmic delay is small and bounded (tens of ms), so the lag
    search is restricted to ``±max_lag`` samples and the correlation runs
    via FFT — O(n log n) instead of the O(n^2) full ``np.correlate``.
    """
    from scipy.signal import correlate

    n = min(len(ref), len(y))
    lo = max(0, n - 1 - max_lag)
    hi = n - 1 + max_lag + 1
    corr = correlate(y[:n], ref[:n], mode="full", method="fft")[lo:hi]
    lag = int(np.argmax(corr)) + lo - (n - 1)
    if lag > 0:
        y = y[lag:]
    elif lag < 0:
        y = np.concatenate([np.zeros(-lag, y.dtype), y])
    if len(y) < len(ref):
        y = np.concatenate([y, np.zeros(len(ref) - len(y), y.dtype)])
    return y[: len(ref)].astype(np.float32)


@dataclasses.dataclass
class OpusCompression:
    """Real Opus round-trip attack (no reference counterpart — the
    reference stops at MP3; Opus is the modern transport a deployed
    watermark actually crosses)."""

    bitrate_bps: int = 24000
    voip: bool = True

    def __post_init__(self):
        self.name = f"opus_{self.bitrate_bps // 1000}k"
        if not opus_available():
            raise RuntimeError("libopus not found — Opus attack unavailable")

    def apply(self, audio, sr, key=None, device=None):
        return opus_roundtrip(audio, sr, self.bitrate_bps, self.voip)


@dataclasses.dataclass
class GSMFullRate:
    """GSM 06.10 full-rate telephony attack (no reference counterpart)."""

    def __post_init__(self):
        self.name = "gsm_fr"
        if not gsm_available():
            raise RuntimeError("libgsm not found — GSM attack unavailable")

    def apply(self, audio, sr, key=None, device=None):
        return gsm_roundtrip(audio, sr)


def _rows():
    """The extended rows after the default suite, in the JAX order:
    (row name, whether it runs here, its constructor, why it cannot)."""
    from aware_tpu_torch.attacks import av_codecs, soxr_real

    opus, gsm, soxr = opus_available(), gsm_available(), soxr_real.soxr_available()
    rows = [(f"opus_{k}k", opus, functools.partial(OpusCompression, k * 1000),
             f"libopus does not load ({', '.join(_OPUS_NAMES[:2])})") for k in (32, 16, 8)]
    rows.append(("gsm_fr", gsm, GSMFullRate,
                 f"libgsm does not load ({', '.join(_GSM_NAMES[:2])})"))
    for name, codec, make in [
        ("aac_64k", "aac", functools.partial(av_codecs.AACCompression, 64)),
        ("aac_32k", "aac", functools.partial(av_codecs.AACCompression, 32)),
        ("vorbis_q3", "libvorbis", functools.partial(av_codecs.VorbisCompression, 3.0)),
        ("speex_wb", "libspeex", av_codecs.SpeexWideband),
        ("g722", "g722", av_codecs.G722Telephony),
    ]:
        rows.append((name, av_codecs.avc_available(codec), make,
                     av_codecs.avc_unavailable_reason(codec)))
    rows += [(f"soxr_{rate}", soxr, functools.partial(soxr_real.SoxrResample, rate),
              "libsoxr does not load (libsoxr.so.0, libsoxr.so)") for rate in (44100, 8000)]
    return rows


def extended_attack_suite() -> list:
    """The reference's 22-instance suite plus the real-codec rows this
    machine supports: Opus (three bitrates), GSM full-rate, the libavcodec
    families (AAC, Vorbis, Speex-WB, G.722) and libsoxr; a row whose
    library is absent is left out (:func:`extended_rows_left_out` says
    which and why)."""
    from aware_tpu_torch.attacks.attacks import default_attack_suite

    return default_attack_suite() + [make() for _, ok, make, _ in _rows() if ok]


def extended_rows_left_out() -> list[tuple[str, str]]:
    """(row name, cause) of each extended row that this machine's
    libraries leave out of :func:`extended_attack_suite`."""
    return [(name, why) for name, ok, _, why in _rows() if not ok]
