"""Watermark pattern codec.

Transforms user payloads (bit arrays / bytes) to the bipolar patterns the
optimizer targets, and detector outputs back to payloads.
(reference: src/AWARE/utils/watermark/encoder.py:5-58, decoder.py:4-69)
A copy of ``aware_tpu/service/codec.py``, so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

_MODES = ("bits2bipolar", "bytes2bipolar", "bytes2bits", "bits")


def _bytes_to_bits(payload: bytes) -> np.ndarray:
    """Unpack bytes MSB-first to a 0/1 array (reference: encoder.py:22-33)."""
    arr = np.frombuffer(bytes(payload), dtype=np.uint8)
    return np.unpackbits(arr).astype(np.int32)


def _bits_to_bipolar(bits: np.ndarray) -> np.ndarray:
    return (2 * np.asarray(bits, dtype=np.int32) - 1).astype(np.int32)


def encode_pattern(payload, mode: str = "bits2bipolar") -> np.ndarray:
    """Payload -> optimizer target pattern (reference: encoder.py:10-20)."""
    if mode == "bits2bipolar":
        return _bits_to_bipolar(np.asarray(payload))
    if mode == "bytes2bipolar":
        return _bits_to_bipolar(_bytes_to_bits(payload))
    if mode == "bytes2bits":
        return _bytes_to_bits(payload)
    if mode == "bits":
        return payload
    raise ValueError(f"Invalid mode: {mode}")


def decode_pattern(detected_values: np.ndarray, mode: str = "bits2bipolar",
                   threshold: float = 0.0):
    """Detector values -> payload (reference: decoder.py:16-26).

    Note the reference's bits->bytes packing emits one byte per *bit*
    (decoder.py:53-57); that behavior is preserved for the byte modes.
    """
    v = np.asarray(detected_values)
    if mode == "bits2bipolar":
        bipolar = 2 * (v > threshold).astype(np.int32) - 1
        return (bipolar > 0).astype(np.int32)
    if mode == "bytes2bipolar":
        bipolar = 2 * (v > threshold).astype(np.int32) - 1
        return bytes(int(b) for b in (bipolar > 0).astype(np.int32))
    if mode == "bytes2bits":
        return bytes(int(b) for b in (v > threshold).astype(np.int32))
    if mode == "bits":
        return (v > threshold).astype(np.int32)
    raise ValueError(f"Invalid mode: {mode}")
