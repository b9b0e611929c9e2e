"""Real MP3 codec round-trip via the system libmp3lame + libmpg123.

A copy of ``aware_tpu/attacks/mp3_real.py`` (ctypes and numpy, no device
code): the codec runs on the host whatever the device of the other
attacks; ``MP3CompressionReal.apply`` takes their ``device`` and ignores it.

The reference's MP3 attack (reference: scripts/attacks.py:73-148) shells
out to ``ffmpeg -q:a N`` (LAME VBR quality N) and reads the decode back.
This image has no ffmpeg binary, but it DOES ship the exact codec
libraries ffmpeg would use — ``libmp3lame.so.0`` (encoder) and
``libmpg123.so.0`` (decoder) — so we bind them directly with ctypes and
run the *actual* codec in-process.  That grounds the robustness suite's
``mp3_*`` rows against real MP3 artifacts instead of only the in-graph
MDCT approximation (:mod:`aware_tpu_torch.attacks.codec`), which remains
the differentiable device path.

Semantics matched to the reference chain:

* 16-bit PCM pre-quantization before encode (reference: :84-90 applies
  PCMBitDepthConversion(16) first);
* VBR quality mode: ``ffmpeg -q:a N`` maps to
  ``lame_set_VBR(vbr_default) + lame_set_VBR_quality(N)``;
* output sample rate pinned to the input rate (ffmpeg decodes with
  ``-ar sr``; we pin the encoder instead so no resample is needed);
* decoder output aligned to the input by cross-correlation (the codec
  pair adds encoder+decoder delay) and trimmed to the input length,
  mirroring how the eval harness consumes the attack.

Everything degrades loudly: :func:`available` reports whether both
libraries load, and the Attack class raises at construction when they
don't (mirroring the reference's ffmpeg presence check at :87-90).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np

__all__ = [
    "available",
    "mp3_encode",
    "mp3_decode",
    "mp3_roundtrip",
    "MP3CompressionReal",
]

# ---------------------------------------------------------------- loading

_LAME_NAMES = ("libmp3lame.so.0", "libmp3lame.so", "mp3lame")
_MPG123_NAMES = ("libmpg123.so.0", "libmpg123.so", "mpg123")


def _load_first(names):
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            found = ctypes.util.find_library(n)
            if found:
                try:
                    return ctypes.CDLL(found)
                except OSError:
                    pass
    return None


@functools.lru_cache(maxsize=1)
def _lame():
    lib = _load_first(_LAME_NAMES)
    if lib is None:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for fn, argtypes in {
        "lame_set_in_samplerate": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_out_samplerate": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_num_channels": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_mode": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_VBR": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_brate": (ctypes.c_void_p, ctypes.c_int),
        "lame_init_params": (ctypes.c_void_p,),
        "lame_close": (ctypes.c_void_p,),
        "lame_get_encoder_delay": (ctypes.c_void_p,),
    }.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.lame_set_VBR_quality.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.lame_set_VBR_quality.restype = ctypes.c_int
    lib.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    lib.lame_encode_buffer_ieee_float.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    lib.lame_encode_flush.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _mpg123():
    lib = _load_first(_MPG123_NAMES)
    if lib is None:
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.mpg123_rates.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_feed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_size_t,
    ]
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True when both codec libraries load from this image."""
    return _lame() is not None and _mpg123() is not None


# ----------------------------------------------------------------- encode

_MONO = 3            # MPEG mode enum: 3 = mono
_VBR_DEFAULT = 4     # vbr_mtrh, what ffmpeg -q:a selects


def mp3_encode(
    x: np.ndarray,
    sr: int,
    vbr_quality: float | None = 2.0,
    bitrate_kbps: int | None = None,
) -> bytes:
    """Encode mono float32 [-1, 1] to an MP3 bitstream (real LAME).

    ``vbr_quality`` mirrors ``ffmpeg -q:a`` (0 best … 9 worst); pass
    ``bitrate_kbps`` instead for CBR.  The encoder output rate is pinned
    to ``sr`` so the round-trip needs no resample.
    """
    lame = _lame()
    if lame is None:
        raise RuntimeError("libmp3lame not available in this image")
    mono = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
    gfp = lame.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gfp, int(sr))
        lame.lame_set_out_samplerate(gfp, int(sr))
        lame.lame_set_num_channels(gfp, 1)
        lame.lame_set_mode(gfp, _MONO)
        if bitrate_kbps is not None:
            lame.lame_set_brate(gfp, int(bitrate_kbps))
        else:
            lame.lame_set_VBR(gfp, _VBR_DEFAULT)
            lame.lame_set_VBR_quality(gfp, float(vbr_quality))
        if lame.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params rejected sr={sr} "
                f"(q={vbr_quality}, brate={bitrate_kbps})"
            )
        buf_len = int(1.25 * len(mono)) + 7200
        buf = (ctypes.c_ubyte * buf_len)()
        pcm = mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = lame.lame_encode_buffer_ieee_float(
            gfp, pcm, pcm, len(mono), buf, buf_len
        )
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {n}")
        out = bytes(buf[:n])
        n = lame.lame_encode_flush(gfp, buf, buf_len)
        if n < 0:
            raise RuntimeError(f"lame_encode_flush failed: {n}")
        return out + bytes(buf[:n])
    finally:
        lame.lame_close(gfp)


# ----------------------------------------------------------------- decode

_ENC_FLOAT_32 = 0x200
_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12


def mp3_decode(data: bytes, flush: bool = True) -> tuple[np.ndarray, int]:
    """Decode an MP3 bitstream to (mono float32, sample_rate) via mpg123.

    mpg123's feed API withholds the final frame(s) until it sees the next
    frame header, so a single feed of the whole stream loses up to ~1 frame
    (tens of ms) at the tail.  With ``flush`` (default) the stream's first
    bytes are re-fed after the payload — the extra headers let the decoder
    emit the withheld real tail — and at most two frames of the samples
    produced by that second feed are kept (the withheld tail is bounded by
    one granule + one frame; everything later is bogus re-fed content).
    """
    mlib = _mpg123()
    if mlib is None:
        raise RuntimeError("libmpg123 not available in this image")
    err = ctypes.c_int(0)
    h = mlib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if mlib.mpg123_open_feed(h) != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed")
        # accept every supported rate, mono or stereo, float32 only
        mlib.mpg123_format_none(h)
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        mlib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        for i in range(n_rates.value):
            mlib.mpg123_format(h, rates[i], 3, _ENC_FLOAT_32)
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(1)
        encoding = ctypes.c_int(0)
        out = (ctypes.c_ubyte * 65536)()
        done = ctypes.c_size_t(0)

        def drain(chunks: list) -> None:
            """Read until the decoder wants more input or is done."""
            while True:
                rc = mlib.mpg123_read(h, out, len(out), ctypes.byref(done))
                if done.value:
                    raw = bytes(out[: done.value])
                    pcm = np.frombuffer(raw, dtype=np.float32)
                    if channels.value == 2:
                        pcm = pcm.reshape(-1, 2).mean(axis=1)
                    chunks.append(pcm)
                if rc == _MPG123_NEW_FORMAT:
                    mlib.mpg123_getformat(
                        h, ctypes.byref(rate), ctypes.byref(channels),
                        ctypes.byref(encoding),
                    )
                    if encoding.value != _ENC_FLOAT_32:
                        raise RuntimeError(
                            f"mpg123 negotiated encoding {encoding.value:#x},"
                            " expected float32"
                        )
                elif rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                    return
                elif rc != _MPG123_OK:
                    raise RuntimeError(f"mpg123_read failed: {rc}")

        def feed(buf: bytes) -> None:
            payload = (ctypes.c_ubyte * len(buf)).from_buffer_copy(buf)
            if mlib.mpg123_feed(h, payload, len(buf)) != _MPG123_OK:
                raise RuntimeError("mpg123_feed failed")

        chunks: list[np.ndarray] = []
        feed(data)
        drain(chunks)
        if flush and len(data) > 0:
            tail: list[np.ndarray] = []
            feed(data[:8192])
            drain(tail)
            if tail:
                # the withheld tail is at most one MPEG-1 layer-III frame
                extra = np.concatenate(tail)
                chunks.append(extra[:1152])
        if not chunks:
            raise RuntimeError("mpg123 produced no audio")
        return np.concatenate(chunks), int(rate.value)
    finally:
        mlib.mpg123_delete(h)


# -------------------------------------------------------------- roundtrip

def _pcm16(x: np.ndarray) -> np.ndarray:
    q = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32767.0


def mp3_roundtrip(
    x: np.ndarray,
    sr: int,
    quality: float = 2.0,
    pcm_bits: int | None = 16,
    bitrate_kbps: int | None = None,
) -> np.ndarray:
    """Encode→decode through the REAL codec, aligned and trimmed to len(x).

    Alignment is by full cross-correlation against the input — the
    encoder (lame_get_encoder_delay ≈ 576) plus the decoder add a
    composite delay that varies with LAME version and mode, so measuring
    it per clip is the reliable route (same approach the ffmpeg
    crosscheck used).
    """
    mono = np.asarray(x, np.float32).reshape(-1)
    pre = _pcm16(mono) if pcm_bits == 16 else mono
    data = mp3_encode(pre, sr, vbr_quality=quality, bitrate_kbps=bitrate_kbps)
    y, out_sr = mp3_decode(data)
    if out_sr != sr:
        # scipy on the host, where the codec's output already is
        from scipy.signal import resample_poly

        g = np.gcd(int(sr), int(out_sr))
        y = resample_poly(y, sr // g, out_sr // g).astype(np.float32)
    # composite LAME+mpg123 delay is bounded (~1105 samples + resample
    # edge); restrict the lag search and correlate via FFT — O(n log n)
    # instead of the full O(n^2) np.correlate
    from scipy.signal import correlate

    max_lag = 4096
    n = min(len(mono), len(y))
    lo = max(0, n - 1 - max_lag)
    corr = correlate(y[:n], mono[:n], mode="full", method="fft")
    corr = corr[lo : n - 1 + max_lag + 1]
    lag = int(np.argmax(corr)) + lo - (n - 1)
    if lag > 0:
        y = y[lag:]
    elif lag < 0:
        y = np.concatenate([np.zeros(-lag, y.dtype), y])
    if len(y) < len(mono):
        y = np.concatenate([y, np.zeros(len(mono) - len(y), y.dtype)])
    return y[: len(mono)].astype(np.float32)


@dataclasses.dataclass
class MP3CompressionReal:
    """Attack wrapper running the actual codec (reference: :73-148).

    Named ``mp3_{q}`` — the same row names as the reference harness,
    whose MP3 rows are real-codec artifacts; the in-graph approximation
    reports as ``mp3approx_{q}``.  Raises at construction when the codec
    libraries are missing, mirroring the reference's ffmpeg presence
    check.
    """

    quality: int = 2
    pcm_bits: int = 16

    def __post_init__(self):
        self.name = f"mp3_{self.quality}"
        if not available():
            raise RuntimeError(
                "libmp3lame/libmpg123 not found — real-codec MP3 attack "
                "unavailable (the in-graph MP3Compression still works)"
            )

    def apply(self, audio, sr, key=None, device=None):
        return mp3_roundtrip(
            audio, sr, quality=float(self.quality),
            pcm_bits=self.pcm_bits,
        )
