"""Minimal WAV I/O (RIFF PCM 16/24/32-bit and float32), numpy-based.

Replaces the reference's libsndfile dependency for the eval harness.  A
copy of ``aware_tpu/utils/io.py``.
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array in [-1,1] of shape (L,) or (L, C),
    sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sample_rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write float audio in [-1,1] as PCM16 (default) or float32 WAV."""
    audio = np.asarray(audio)
    channels = 1 if audio.ndim == 1 else audio.shape[1]
    if bits == 16:
        payload = np.round(
            np.clip(audio, -1.0, 1.0) * 32767.0
        ).astype("<i2").tobytes()
        fmt_code, bytes_per = 1, 2
    elif bits == 32:
        payload = audio.astype("<f4").tobytes()
        fmt_code, bytes_per = 3, 4
    else:
        raise ValueError("bits must be 16 or 32")
    block = channels * bytes_per
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, channels, sample_rate,
        sample_rate * block, block, bytes_per * 8,
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)
