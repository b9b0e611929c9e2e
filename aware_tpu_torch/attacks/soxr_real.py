"""Real high-quality resampler attack via libsoxr (the SoX resampler).

A copy of ``aware_tpu/attacks/soxr_real.py`` (ctypes and numpy, no device
code), with its names and errors; ``SoxrResample.apply`` takes the other
attacks' ``device`` and ignores it.

The reference's Resample attack (reference: scripts/attacks.py:256-294)
round-trips through scipy ``resample_poly`` (441/160) or a naive
decimate+linear-reinterp; our in-graph :class:`aware_tpu_torch.attacks.attacks.
Resample` reproduces both paths.  Real-world pipelines, however, resample
with dedicated native resamplers — ``libsoxr.so.0`` is the SoX/ffmpeg
high-quality polyphase resampler, bound in-process with ctypes exactly
like :mod:`aware_tpu_torch.attacks.mp3_real`:
a genuinely external, differently-engineered resampler the watermark
must survive, not our own math round-tripped.

:func:`soxr_roundtrip` resamples in_rate -> intermediate -> in_rate with
``soxr_oneshot`` (SOXR_HQ default quality, float32 I/O) and trims/pads
to the input length.  Degrades loudly when the library is missing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np

from aware_tpu_torch.attacks.mp3_real import _load_first

__all__ = [
    "soxr_available",
    "soxr_resample",
    "soxr_roundtrip",
    "SoxrResample",
]


@functools.lru_cache(maxsize=1)
def _soxr():
    lib = _load_first(("libsoxr.so.0", "libsoxr.so", "soxr"))
    if lib is None:
        return None
    # soxr_error_t soxr_oneshot(double in_rate, double out_rate, unsigned ch,
    #     soxr_in_t in, size_t ilen, size_t *idone,
    #     soxr_out_t out, size_t olen, size_t *odone,
    #     io_spec*, quality_spec*, runtime_spec*)   — NULL specs = HQ float32.
    lib.soxr_oneshot.restype = ctypes.c_char_p  # NULL on success
    lib.soxr_oneshot.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def soxr_available() -> bool:
    return _soxr() is not None


def soxr_resample(audio: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """One libsoxr pass (mono float32), SOXR_HQ default quality."""
    lib = _soxr()
    if lib is None:
        raise RuntimeError("libsoxr not found — soxr attack unavailable")
    x = np.ascontiguousarray(audio, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError("soxr_resample expects mono audio")
    olen = int(np.ceil(len(x) * out_rate / in_rate)) + 16
    out = np.zeros(olen, dtype=np.float32)
    idone = ctypes.c_size_t(0)
    odone = ctypes.c_size_t(0)
    err = lib.soxr_oneshot(
        float(in_rate), float(out_rate), 1,
        x.ctypes.data_as(ctypes.c_void_p), len(x), ctypes.byref(idone),
        out.ctypes.data_as(ctypes.c_void_p), olen, ctypes.byref(odone),
        None, None, None,
    )
    if err:
        raise RuntimeError(f"soxr_oneshot failed: {err.decode()}")
    return out[: odone.value]


def soxr_roundtrip(audio: np.ndarray, sr: int, intermediate_rate: int) -> np.ndarray:
    """sr -> intermediate_rate -> sr through libsoxr; output length == input."""
    up = soxr_resample(audio, sr, intermediate_rate)
    back = soxr_resample(up, intermediate_rate, sr)
    n = len(audio)
    if len(back) < n:
        back = np.pad(back, (0, n - len(back)))
    return back[:n].astype(np.float32)


@dataclasses.dataclass
class SoxrResample:
    """Real-resampler round-trip attack (reference analogue:
    scripts/attacks.py:256-294, which round-trips scipy resample_poly;
    this row uses the independently-engineered SoX resampler instead)."""

    intermediate_rate: int = 44100

    def __post_init__(self):
        self.name = f"soxr_{self.intermediate_rate}"
        if not soxr_available():
            raise RuntimeError("libsoxr not found — soxr attack unavailable")

    def apply(self, audio, sr, key=None, device=None):
        return soxr_roundtrip(audio, sr, self.intermediate_rate)
