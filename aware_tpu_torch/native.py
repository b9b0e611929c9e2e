"""ctypes bindings of the port's host runtime (``_native/aware_native.cc``).

The port of ``aware_tpu/native.py``, with its names and contracts, over
the port's own copy of the C++ source.  The library is host code (WAV
I/O, the two silence gates, PCM quantization, the batch loader), built at
first use, never at import, by

    g++ -O3 -std=c++17 -fPIC -pthread -shared

into ``aware_tpu_torch/_build/`` under a name that carries the hash of the
source and the flags, so an edited source rebuilds.  Where it cannot be
built, the entry points with a documented fallback take it: WAV I/O
``utils/io.py``, ``vad_is_silent`` ``ops/vad.py``, ``pcm_quantize`` the
attack suite's ``PCMBitDepthConversion`` on the CPU.  The GMM gate has no
fallback and raises, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Sequence

import numpy as np

PACKAGE = pathlib.Path(__file__).resolve().parent
SOURCE = PACKAGE / "_native" / "aware_native.cc"
BUILD_DIR = PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_P = ctypes.c_void_p
_F_PTR = ctypes.POINTER(ctypes.c_float)


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("frames", ctypes.c_int64),
    ]


# (restype, argtypes) of each C entry
SIGNATURES = {
    "an_read_wav": (_F_PTR, [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]),
    "an_write_wav": (ctypes.c_int, [ctypes.c_char_p, _F_PTR, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]),
    "an_free": (None, [_P]),
    "an_vad_is_silent": (ctypes.c_int, [_F_PTR, ctypes.c_int64, ctypes.c_int32,
                                        ctypes.c_float, ctypes.c_int32, ctypes.c_float]),
    "an_vad_gmm_is_silent": (ctypes.c_int, [_F_PTR, ctypes.c_int64, ctypes.c_int32,
                                            ctypes.c_float, ctypes.c_int32, ctypes.c_float]),
    "an_vad_gmm_flags": (ctypes.c_int64, [_F_PTR, ctypes.c_int64, ctypes.c_int32,
                                          ctypes.c_float, ctypes.c_int32,
                                          ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]),
    "an_pcm_quantize": (None, [_F_PTR, ctypes.c_int64, ctypes.c_int32]),
    "an_loader_create": (_P, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                              ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]),
    "an_loader_next": (ctypes.c_int32, [_P, _F_PTR, ctypes.POINTER(ctypes.c_int64),
                                        ctypes.POINTER(ctypes.c_int32)]),
    "an_loader_destroy": (None, [_P]),
}


def build_host_library(source: pathlib.Path, stem: str, flags=CXX_FLAGS,
                       libs=()) -> pathlib.Path:
    """Compile ``source`` with g++ into ``_build/<stem>_<hash>.so`` if it is
    not built yet (the hash covers the flags, the libraries and the source;
    a per-process temporary file, then ``os.replace``, so that concurrent
    builds never see half a library); returns its path and raises
    RuntimeError, with the compiler's output, where it cannot."""
    digest = hashlib.sha256(" ".join((*flags, *libs)).encode())
    digest.update(source.read_bytes())
    so = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        run = subprocess.run([cxx, *flags, "-o", str(tmp), str(source), *libs],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed ({run.returncode}):\n{run.stdout}{run.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


def build_native() -> pathlib.Path:
    """Compile the library if it is not built yet; returns its path and
    raises RuntimeError, with the compiler's output, where it cannot."""
    return build_host_library(SOURCE, "libaware_native")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The library, built at first use; None where it cannot be built."""
    try:
        return _load()
    except (RuntimeError, OSError):
        return None


def native_available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------------------------------------------- wrappers ---

def read_wav(path: str) -> tuple[np.ndarray, int]:
    """WAV read -> (float32 (L,) or (L, C), sample_rate); falls back to
    ``utils/io.read_wav``."""
    lib = get_lib()
    if lib is None:
        from aware_tpu_torch.utils.io import read_wav as py_read

        return py_read(path)
    info = _WavInfo()
    ptr = lib.an_read_wav(str(path).encode(), ctypes.byref(info))
    if not ptr:
        raise ValueError(f"failed to read {path}")
    n = info.frames * info.channels
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.an_free(ptr)
    if info.channels > 1:
        arr = arr.reshape(-1, info.channels)
    return arr, int(info.sample_rate)


def write_wav(path: str, audio: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """WAV write, PCM16 or float32; falls back to ``utils/io.write_wav``."""
    lib = get_lib()
    if lib is None:
        from aware_tpu_torch.utils.io import write_wav as py_write

        return py_write(path, audio, sample_rate, bits)
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    channels = 1 if audio.ndim == 1 else audio.shape[1]
    rc = lib.an_write_wav(str(path).encode(), _ptr(audio), audio.shape[0], channels,
                          sample_rate, bits)
    if rc != 0:
        raise ValueError(f"failed to write {path} (rc={rc})")


def vad_is_silent(
    audio: np.ndarray,
    sample_rate: int = 16000,
    frame_ms: float = 30.0,
    aggressiveness: int = 3,
    min_speech_seconds: float = 0.01,
) -> bool:
    """The spectral silence gate on the host; falls back to
    ``ops/vad.is_silent`` on the CPU."""
    lib = get_lib()
    if lib is None:
        import torch

        from aware_tpu_torch.ops.vad import is_silent

        x = torch.as_tensor(np.asarray(audio, np.float32))
        return bool(is_silent(x, sample_rate, frame_ms, aggressiveness, min_speech_seconds))
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    return bool(lib.an_vad_is_silent(_ptr(audio), audio.shape[-1], sample_rate, frame_ms,
                                     aggressiveness, min_speech_seconds))


def _gmm_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the host runtime is unavailable (no C++ toolchain): the GMM "
                           "gate has no fallback")
    return lib


def vad_gmm_is_silent(
    audio: np.ndarray,
    sample_rate: int = 16000,
    frame_ms: float = 30.0,
    aggressiveness: int = 3,
    min_speech_seconds: float = 0.01,
) -> bool:
    """The reference's silence gate: the WebRTC VAD architecture (a 6-band
    allpass filterbank, adaptive 2-component GMMs, LLR tests, hangover;
    see aware_native.cc).  Needs the library; no fallback.  Like webrtcvad
    it reads loud stationary noise and tones as speech; the spectral gate
    (the default) rejects those."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    return bool(_gmm_lib().an_vad_gmm_is_silent(_ptr(audio), audio.shape[-1], sample_rate,
                                                frame_ms, aggressiveness, min_speech_seconds))


def vad_gmm_flags(
    audio: np.ndarray,
    sample_rate: int = 16000,
    frame_ms: float = 30.0,
    aggressiveness: int = 3,
) -> np.ndarray:
    """Per-frame voiced decisions of the GMM VAD -> bool (n_frames,)."""
    lib = _gmm_lib()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    frame_len = int(sample_rate * frame_ms / 1000.0)
    n_frames = audio.shape[-1] // frame_len
    flags = np.zeros(max(n_frames, 1), dtype=np.uint8)
    n = lib.an_vad_gmm_flags(_ptr(audio), audio.shape[-1], sample_rate, frame_ms,
                             aggressiveness, _ptr(flags, ctypes.c_uint8), n_frames)
    if n < 0:
        raise ValueError("unsupported sample rate / frame length for GMM VAD")
    return flags[:n].astype(bool)


def pcm_quantize(audio: np.ndarray, bits: int) -> np.ndarray:
    """The truncating PCM round trip (the pcm_* attacks' float32 operation
    order); falls back to ``PCMBitDepthConversion`` on the CPU."""
    lib = get_lib()
    out = np.ascontiguousarray(audio, dtype=np.float32).copy()
    if lib is None:
        from aware_tpu_torch.attacks.attacks import PCMBitDepthConversion

        return PCMBitDepthConversion(bits).apply(out, 0, device="cpu")
    lib.an_pcm_quantize(_ptr(out), out.size, bits)
    return out


class BatchLoader:
    """Multithreaded prefetching WAV batch loader: yields (data (B, L)
    float32, lengths (B,), rates (B,), count) in file order, whatever the
    threads' order; a short final batch is zero-padded, with its count of
    valid clips."""

    def __init__(
        self,
        files: Sequence[str],
        batch: int,
        length: int,
        n_threads: int = 4,
        prefetch: int = 2,
    ):
        self._lib = lib = get_lib()
        if lib is None:
            raise RuntimeError("the host runtime is unavailable (no C++ toolchain)")
        self.batch, self.length = batch, length
        self._paths = [str(f).encode() for f in files]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.an_loader_create(arr, len(self._paths), batch, length, n_threads,
                                            prefetch)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        data = np.empty((self.batch, self.length), np.float32)
        lengths = np.empty(self.batch, np.int64)
        rates = np.empty(self.batch, np.int32)
        count = self._lib.an_loader_next(self._handle, _ptr(data), _ptr(lengths, ctypes.c_int64),
                                         _ptr(rates, ctypes.c_int32))
        if count < 0:
            self.close()
            raise StopIteration
        return data, lengths, rates, count

    def close(self):
        if not self._closed:
            self._lib.an_loader_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
