"""Framed FFT / overlap-add core with ``torch.stft``-exact semantics.

The port of ``aware_tpu/ops/stft.py``.  Every function takes leading batch
dimensions; the signal or frame axis is the last one (the frequency axis
of a spectrogram is second to last, as in the JAX package).

* ``center=True`` reflect-pads ``n_fft//2`` samples on both sides.
* Frame count ``T = len(x) // hop + 1``.
* ``istft`` with no explicit length returns ``(T - 1) * hop`` samples, so
  a round trip truncates the clip to a hop multiple (the reference's
  quirk, kept).
* ``istft`` divides by the overlap-added squared-window envelope, computed
  on the host in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.windows import get_window


def num_frames(length: int, hop_length: int) -> int:
    """Frame count of a centered STFT over ``length`` samples."""
    return length // hop_length + 1


def istft_length(n_frames: int, hop_length: int) -> int:
    """Output length of a centered ISTFT with no explicit length."""
    return (n_frames - 1) * hop_length


def _window(window, like: torch.Tensor) -> torch.Tensor:
    """The window as a tensor beside ``like``: a host array is copied over,
    a tensor already on the device is used as it is."""
    if isinstance(window, torch.Tensor):
        return window.to(like.dtype)
    return torch.as_tensor(np.asarray(window), dtype=like.dtype, device=like.device)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides (no edge repeat)."""
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return xp.reshape(*lead, xp.shape[-1])


def stft_frames(
    x: torch.Tensor, n_fft: int, hop_length: int, window
) -> torch.Tensor:
    """Center-pad, frame and window a signal (..., L) -> (..., T, n_fft)."""
    length = x.shape[-1]
    t = num_frames(length, hop_length)
    xp = _reflect_pad(x, n_fft // 2)
    w = _window(window, x)
    if n_fft % hop_length == 0:
        r = n_fft // hop_length
        rows = xp[..., : (t - 1 + r) * hop_length].reshape(
            *x.shape[:-1], t - 1 + r, hop_length
        )
        frames = torch.cat([rows[..., k : k + t, :] for k in range(r)], dim=-1)
        return frames * w
    starts = torch.arange(t, device=x.device)[:, None] * hop_length
    idx = starts + torch.arange(n_fft, device=x.device)[None, :]
    return xp[..., idx] * w


def stft(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    window="hann",
    win_length: int | None = None,
) -> torch.Tensor:
    """Centered STFT (..., L) -> complex (..., n_fft//2+1, T)."""
    if isinstance(window, str):
        window = get_window(window, win_length or n_fft)
    frames = stft_frames(x, n_fft, hop_length, window)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


# 128 envelopes: one a frame count, and the robust detector's stretch lanes
# with their fine grids give 84 frame counts a clip length
@functools.lru_cache(maxsize=128)
def _ola_envelope(
    window_key: tuple, n_fft: int, hop_length: int, n_frames: int
) -> np.ndarray:
    """Cropped overlap-added squared-window envelope, float64 on the host."""
    w = np.asarray(window_key, dtype=np.float64)
    total = (n_frames - 1) * hop_length + n_fft
    env = np.zeros(total, dtype=np.float64)
    wsq = w * w
    for t in range(n_frames):
        env[t * hop_length : t * hop_length + n_fft] += wsq
    pad = n_fft // 2
    env = env[pad : pad + istft_length(n_frames, hop_length)]
    if np.any(env < 1e-11):
        raise ValueError("window overlap-add envelope is ~0 (NOLA violated)")
    return env


@functools.lru_cache(maxsize=64)
def device_window(name: str, n: int, device: torch.device) -> torch.Tensor:
    """The float32 window ``name`` of ``n`` samples on ``device``, built
    once: a copy from the host in every call would wait for the card."""
    return torch.from_numpy(get_window(name, n)).to(device)


@functools.lru_cache(maxsize=128)
def device_envelope(
    name: str, n_fft: int, hop_length: int, n_frames: int, device: torch.device
) -> torch.Tensor:
    """:func:`_ola_envelope` of the window ``name`` as a float32 tensor on
    ``device``, built once (the ``env`` of :func:`istft`)."""
    env = _ola_envelope(tuple(get_window(name, n_fft).tolist()), n_fft, hop_length, n_frames)
    return torch.as_tensor(env, dtype=torch.float32, device=device)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (..., T, n_fft) frames -> (..., (T-1)*hop + n_fft)."""
    *batch, t, n_fft = frames.shape
    total = (t - 1) * hop_length + n_fft
    if n_fft % hop_length == 0:
        r = n_fft // hop_length
        chunks = frames.reshape(*batch, t, r, hop_length)
        out = sum(
            F.pad(chunks[..., :, k, :], (0, 0, k, r - 1 - k)) for k in range(r)
        )
        return out.reshape(*batch, (t + r - 1) * hop_length)[..., :total]
    idx = (
        torch.arange(t, device=frames.device)[:, None] * hop_length
        + torch.arange(n_fft, device=frames.device)[None, :]
    ).reshape(-1)
    out = frames.new_zeros(*batch, total)
    return out.index_add(-1, idx, frames.reshape(*batch, t * n_fft))


def istft_synthesis(
    wframes: torch.Tensor, n_fft: int, hop_length: int, window, env=None
) -> torch.Tensor:
    """OLA + center-crop + envelope division of already-windowed frames
    (..., T, n_fft) — the back half of :func:`istft`.  ``env``, where
    given, is the envelope as a ((T-1)*hop,) tensor on the frames' device
    (the solver builds it once); else it is built from ``window``."""
    t = wframes.shape[-2]
    y = overlap_add(wframes, hop_length)
    pad = n_fft // 2
    y = y[..., pad : pad + istft_length(t, hop_length)]
    if env is None:
        env = _ola_envelope(tuple(np.asarray(window).tolist()), n_fft, hop_length, t)
        env = torch.as_tensor(env, dtype=y.dtype, device=y.device)
    return y / env


def istft(
    spec: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    window="hann",
    win_length: int | None = None,
    env: torch.Tensor | None = None,
) -> torch.Tensor:
    """Centered inverse STFT of complex (..., F, T) -> (..., (T-1)*hop).
    ``window`` may be a tensor on the device where ``env`` is given (see
    :func:`istft_synthesis`)."""
    if isinstance(window, str):
        window = get_window(window, win_length or n_fft)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    return istft_synthesis(frames * _window(window, frames), n_fft, hop_length, window, env)


@functools.lru_cache(maxsize=8)
def rfft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rFFT basis matrices (n_fft, n_fft//2+1), float32."""
    m = np.fft.rfft(np.eye(n_fft), axis=-1)
    return (
        np.ascontiguousarray(m.real, dtype=np.float32),
        np.ascontiguousarray(m.imag, dtype=np.float32),
    )


@functools.lru_cache(maxsize=8)
def irfft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse basis (n_fft//2+1, n_fft): ``Re @ A + Im @ B`` == irfft(Z)."""
    f = n_fft // 2 + 1
    a = np.fft.irfft(np.eye(f), n=n_fft, axis=-1)
    b = np.fft.irfft(1j * np.eye(f), n=n_fft, axis=-1)
    return (
        np.ascontiguousarray(a, dtype=np.float32),
        np.ascontiguousarray(b, dtype=np.float32),
    )


def peak_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / (max|x| + 1e-8) over the last axis (each clip on its own).

    The reference computes ``max(|x| + eps)``, which equals
    ``max|x| + eps``.
    """
    return x / (x.abs().amax(dim=-1, keepdim=True) + 1e-8)


class _SafeMagnitude(torch.autograd.Function):
    """sqrt(re² + im²) with value 0 and gradient 0 at exactly-zero bins
    (torch's sgn(0) = 0).  Silence regions round-trip to bit-zero frames,
    and a NaN gradient there would poison the whole embed trajectory."""

    @staticmethod
    def forward(ctx, re, im):
        sq = re * re + im * im
        zero = sq == 0
        mag = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))
        ctx.save_for_backward(re, im, mag)
        return mag

    @staticmethod
    def backward(ctx, g):
        re, im, mag = ctx.saved_tensors
        zero = mag == 0
        scale = torch.where(zero, 0.0, g / torch.where(zero, 1.0, mag))
        return scale * re, scale * im


def safe_magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """|re + i·im| with gradient 0 at exactly-zero bins."""
    return _SafeMagnitude.apply(re, im)


def safe_angle(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """atan2(im, re) with angle 0 and gradient 0 at exactly-zero bins."""
    zero = (re == 0) & (im == 0)
    re_s = torch.where(zero, 1.0, re)
    im_s = torch.where(zero, 0.0, im)
    return torch.where(zero, 0.0, torch.atan2(im_s, re_s))


def magphase(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex STFT -> (magnitude, phase); the magnitude is
    :func:`safe_magnitude`."""
    return safe_magnitude(spec.real, spec.imag), torch.angle(spec)


def polar(magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """(magnitude, phase) -> complex STFT, built from cos/sin."""
    return torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
