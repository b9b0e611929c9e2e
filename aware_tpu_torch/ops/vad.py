"""Spectral voice-activity silence gate.

The port of ``aware_tpu/ops/vad.py:69`` (the "spectral" gate).  A 30 ms
frame is voiced when it has (a) enough energy relative to full scale, (b)
most of its energy in the speech band (80-3500 Hz) and (c) a moderate
zero-crossing rate; a clip is silent when fewer than 0.01 s of its frames
are voiced.  The reference's WebRTC GMM gate (``vad="webrtc_gmm"``) needs
the JAX package's C++ runtime and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

# energy thresholds (dBFS) per aggressiveness 0..3; 3 is the reference's
_ENERGY_DBFS = (-55.0, -50.0, -45.0, -40.0)


def frame_voiced_flags(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    frame_ms: float = 30.0,
    aggressiveness: int = 3,
) -> torch.Tensor:
    """Per-frame voiced decisions (..., n_frames) for clips (..., L)."""
    frame_len = int(sample_rate * frame_ms / 1000.0)
    n = audio.shape[-1] // frame_len
    frames = audio[..., : n * frame_len].reshape(*audio.shape[:-1], n, frame_len)

    rms = torch.sqrt((frames**2).mean(dim=-1) + 1e-12)
    energetic = 20.0 * torch.log10(rms + 1e-12) > _ENERGY_DBFS[aggressiveness]

    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2
    freqs = np.fft.rfftfreq(frame_len, 1.0 / sample_rate)
    band = torch.as_tensor(
        (freqs >= 80.0) & (freqs <= 3500.0), dtype=spec.dtype, device=spec.device
    )
    band_share = (spec * band).sum(dim=-1) / (spec.sum(dim=-1) + 1e-12)
    speechy = band_share > 0.5

    zcr = (torch.diff(torch.sign(frames), dim=-1).abs() > 0).float().mean(dim=-1)
    return energetic & speechy & (zcr < 0.35)


def is_silent(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    frame_ms: float = 30.0,
    aggressiveness: int = 3,
    min_speech_seconds: float = 0.01,
) -> torch.Tensor:
    """True (per clip) when a clip (..., L) has effectively no voiced frames."""
    flags = frame_voiced_flags(audio, sample_rate, frame_ms, aggressiveness)
    return flags.sum(dim=-1) * (frame_ms / 1000.0) < min_speech_seconds
