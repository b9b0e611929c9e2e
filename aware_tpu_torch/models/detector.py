"""The keyed AWARE detector CNN in PyTorch.

The port of ``aware_tpu/models/detector.py``.  For a batch of magnitudes
``mag`` (B, F=513, T):

    mel     = mel_basis @ mag            # (B, 128, T).  The reference
                                         # computes global_norm1(mag) and
                                         # then DISCARDS it, feeding the raw
                                         # magnitude to the mel layer; the
                                         # dead normalization is not computed.
    x = instance_norm(mel)               # per channel over time, eps 1e-5
    x = global_standardize(x)            # per clip, unbiased std, 1e-8
    x = avg_pool_1d(x, 2, 2)             # (B, 128, T//2)
    4x: x = leaky_relu_0.2(instance_norm(W_i @ x + b_i))  # 128-512-1024-1024-40
    out = tanh(mean_t(x)[0::2] - mean_t(x)[1::2])          # BRH, (B, 20)

Every normalization is per clip, as under ``vmap`` in the JAX package.
The 1x1 convolutions are batched matmuls in float32; the callers turn
TF32 off (``service.api.load``) so that they match the JAX package.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
from torch import nn

from aware_tpu_torch.config import DetectorNetConfig, in_band_bins
from aware_tpu_torch.ops.mel import mel_filter_bank
from aware_tpu_torch.ops.stft import magphase, peak_normalize, stft
from aware_tpu_torch.ops.windows import get_window

# the key bundles live with the JAX package; they are data, read by path
KEY_DIR = pathlib.Path(__file__).resolve().parents[2] / "aware_tpu" / "models" / "_key"
KEY_FILE = KEY_DIR / "aware_key_v1.npz"


def load_key_params(key_file: str | pathlib.Path = "") -> dict[str, np.ndarray]:
    """A key bundle's detector weights as numpy: ``key_file`` as
    ``DetectorNetConfig.key_file`` names it (a file name under KEY_DIR, or
    an absolute path), or with none the golden key (seeded torch xavier
    weights)."""
    path = pathlib.Path(key_file or KEY_FILE)
    if not path.is_absolute():
        path = KEY_DIR / path
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "seed"}


def params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's detector params (``conv{i}_w`` (C_out, C_in),
    ``conv{i}_b`` (C_out,)) as float32 torch tensors, same names and
    layout."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in params.items()
    }


def global_standardize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps) over each clip's (C, T), unbiased std."""
    n = x.shape[-1] * x.shape[-2]
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).sum(dim=(-2, -1), keepdim=True) / (n - 1)
    return (x - mean) / (torch.sqrt(var) + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-channel normalization over time, biased variance. x: (..., C, T)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def avg_pool_1d(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """AvgPool1d over the last axis."""
    t = x.shape[-1]
    if size == stride:
        t_out = t // size
        return x[..., : t_out * size].reshape(*x.shape[:-1], t_out, size).mean(-1)
    t_out = (t - size) // stride + 1
    idx = torch.arange(t_out, device=x.device)[:, None] * stride
    idx = idx + torch.arange(size, device=x.device)[None, :]
    return x[..., idx].mean(-1)


class DetectorNet(nn.Module):
    """The frozen keyed detector: the mel basis and the conv weights are
    buffers, so nothing in it is trained."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: DetectorNetConfig):
        super().__init__()
        self.cfg = cfg
        basis = mel_filter_bank(cfg.sample_rate, cfg.n_fft, cfg.n_mels)
        self.register_buffer("mel_basis", torch.from_numpy(basis.copy()))
        ch = cfg.channels
        for i in range(cfg.num_blocks + 1):
            w, b = params[f"conv{i}_w"], params[f"conv{i}_b"]
            if tuple(w.shape) != (ch[i + 1], ch[i]):
                raise ValueError(f"conv{i}_w has shape {tuple(w.shape)}")
            self.register_buffer(f"conv{i}_w", w.float())
            self.register_buffer(f"conv{i}_b", b.float())

    def _stack(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = instance_norm(mel)
        x = global_standardize(x)
        x = avg_pool_1d(x, cfg.initial_pool_size, cfg.initial_pool_stride)
        for i in range(cfg.num_blocks + 1):
            w = getattr(self, f"conv{i}_w")
            b = getattr(self, f"conv{i}_b")
            x = instance_norm(torch.matmul(w, x) + b[:, None])
            x = torch.where(x >= 0, x, 0.2 * x)
        pooled = x.mean(dim=-1)
        return torch.tanh(pooled[..., 0::2] - pooled[..., 1::2])

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        """Magnitude (..., F, T) -> bit values (..., output_length)."""
        return self._stack(torch.matmul(self.mel_basis, mag))

    def forward_banded(self, band_mag: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Forward from the in-band rows (..., hi-lo, T) alone: identical to
        :meth:`forward` on the band-zeroed magnitude, since out-of-band rows
        add nothing to the mel projection.  The embed solver's entry."""
        return self._stack(torch.matmul(self.mel_basis[:, lo:hi], band_mag))


def preprocess_magnitude(
    audio: torch.Tensor, n_fft: int, hop_length: int, window, lo: int, hi: int
) -> torch.Tensor:
    """Waveform (..., L) -> band-limited STFT magnitude (..., F, T):
    peak-normalize -> STFT -> |.| -> zero the out-of-band bins."""
    mag, _ = magphase(stft(peak_normalize(audio), n_fft, hop_length, window))
    keep = torch.zeros(mag.shape[-2], 1, dtype=mag.dtype, device=mag.device)
    keep[lo:hi] = 1.0
    return mag * keep


def detect_values_batch(
    net: DetectorNet,
    audios: torch.Tensor,
    hop_length: int = 256,
    window: str = "hann",
    win_length: int | None = None,
    embedding_bands: tuple[float, float] = (500.0, 4000.0),
) -> torch.Tensor:
    """Waveforms (B, L) -> detector values (B, output_length)."""
    cfg = net.cfg
    w = get_window(window, win_length or cfg.n_fft)
    lo, hi = in_band_bins(cfg.sample_rate, cfg.n_fft, embedding_bands)
    with torch.no_grad():
        return net(preprocess_magnitude(audios, cfg.n_fft, hop_length, w, lo, hi))


def detect_values(net: DetectorNet, audio: torch.Tensor, **kwargs) -> torch.Tensor:
    """One waveform (L,) -> detector values (output_length,)."""
    return detect_values_batch(net, audio[None], **kwargs)[0]
