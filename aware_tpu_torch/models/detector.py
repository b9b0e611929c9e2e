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
The mel projection and the 1x1 convolutions are batched matmuls at the
card's ``matmul_precision`` (:func:`matmul`): float32 for "high" and
"highest", one bf16 pass for "default"; the callers turn TF32 off
(``service.api.load``) so that they match the JAX package.
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


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), kept in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Bf16Matmul(torch.autograd.Function):
    """a @ b as ``jax.lax.Precision.DEFAULT`` computes it on a TPU, both
    ways: each operand rounded to bf16, the products exact in float32,
    float32 accumulation and result; the VJP's products likewise (the
    cotangent rounded too).  ``torch.matmul`` of two bf16 tensors would
    round the result to bf16 as well: a different function.  The rounded
    operands are saved for the VJP as bf16, which holds them exactly."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(a16.to(a.dtype), b16.to(b.dtype))

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        ar, br = a16.to(g.dtype), b16.to(g.dtype)
        gr = _bf16_round(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(gr, br.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(ar.transpose(-1, -2), gr).sum_to_size(ctx.shapes[1])
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """a @ b at a JAX matmul precision: "default" is one bf16 pass
    (:class:`_Bf16Matmul`); "high" and "highest" multiply in float32 (with
    TF32 off, as ``service.api.load`` sets it).  The one place of the
    port's plain paths where the precision is applied."""
    if precision == "default":
        return _Bf16Matmul.apply(a, b)
    return torch.matmul(a, b)


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

    def _stack(self, mel: torch.Tensor, precision: str) -> torch.Tensor:
        cfg = self.cfg
        x = instance_norm(mel)
        x = global_standardize(x)
        x = avg_pool_1d(x, cfg.initial_pool_size, cfg.initial_pool_stride)
        for i in range(cfg.num_blocks + 1):
            w = getattr(self, f"conv{i}_w")
            b = getattr(self, f"conv{i}_b")
            x = instance_norm(matmul(w, x, precision) + b[:, None])
            x = torch.where(x >= 0, x, 0.2 * x)
        pooled = x.mean(dim=-1)
        return torch.tanh(pooled[..., 0::2] - pooled[..., 1::2])

    def forward(self, mag: torch.Tensor, precision: str = "highest") -> torch.Tensor:
        """Magnitude (..., F, T) -> bit values (..., output_length), every
        product at ``precision`` (:func:`matmul`)."""
        return self._stack(matmul(self.mel_basis, mag, precision), precision)

    def forward_banded(self, band_mag: torch.Tensor, lo: int, hi: int,
                       precision: str = "highest") -> torch.Tensor:
        """Forward from the in-band rows (..., hi-lo, T) alone: identical to
        :meth:`forward` on the band-zeroed magnitude, since out-of-band rows
        add nothing to the mel projection.  The embed solver's entry."""
        return self._stack(matmul(self.mel_basis[:, lo:hi], band_mag, precision), precision)

    def forward_masked(self, mag: torch.Tensor, mask: torch.Tensor,
                       precision: str = "highest") -> torch.Tensor:
        """Forward over zero-padded magnitudes (H, F, T) with frame-validity
        masks: (H, T) -> values (H, output_length), or (H, K, T) -> (H, K,
        output_length), one readout a mask of the same magnitude.  Equal,
        to float tolerance, to :meth:`forward` on each lane's valid frames
        alone: every statistic and the readout's mean ignore masked frames,
        and the initial pool keeps only the windows with no masked frame,
        as the unpadded forward's floor division drops the rest.  The port
        of ``detector_apply_masked``, which lets lanes of different lengths
        run as one batch."""
        cfg = self.cfg
        size = cfg.initial_pool_size
        if size != cfg.initial_pool_stride:
            raise ValueError("masked forward supports size==stride pooling only")
        mel = matmul(self.mel_basis, mag, precision)  # (H, C, T)
        if mask.dim() == mag.dim():  # (H, K, T): K readouts of each lane
            mel = mel.unsqueeze(-3)
        m = mask.to(mel.dtype).unsqueeze(-2)  # (..., 1, T)
        x = mel * m
        n = m.sum(-1, keepdim=True)
        # masked InstanceNorm1d (biased variance over the valid frames)
        mean = (x * m).sum(-1, keepdim=True) / n
        var = (((x - mean) * m) ** 2).sum(-1, keepdim=True) / n
        x = (x - mean) * torch.rsqrt(var + 1e-5) * m
        # masked GlobalStandardize (unbiased over C * n_valid elements)
        n_el = x.shape[-2] * n
        gmean = (x * m).sum((-2, -1), keepdim=True) / n_el
        gvar = (((x - gmean) * m) ** 2).sum((-2, -1), keepdim=True) / (n_el - 1.0)
        x = (x - gmean) / (torch.sqrt(gvar) + 1e-8) * m

        t_out = x.shape[-1] // size
        x = x[..., : t_out * size].reshape(*x.shape[:-1], t_out, size).mean(-1)
        mp = m[..., : t_out * size].reshape(*m.shape[:-1], t_out, size).prod(-1)
        x = x * mp
        n_pool = mp.sum(-1, keepdim=True)
        for i in range(cfg.num_blocks + 1):
            w = getattr(self, f"conv{i}_w")
            b = getattr(self, f"conv{i}_b")
            x = (matmul(w, x, precision) + b[:, None]) * mp
            mean = (x * mp).sum(-1, keepdim=True) / n_pool
            var = (((x - mean) * mp) ** 2).sum(-1, keepdim=True) / n_pool
            x = (x - mean) * torch.rsqrt(var + 1e-5) * mp
            x = torch.where(x >= 0, x, 0.2 * x) * mp
        pooled = (x * mp).sum(-1) / n_pool[..., 0]
        return torch.tanh(pooled[..., 0::2] - pooled[..., 1::2])


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
    precision: str = "highest",
) -> torch.Tensor:
    """Waveforms (B, L) -> detector values (B, output_length), the
    detector's products at ``precision`` (:func:`matmul`)."""
    cfg = net.cfg
    w = get_window(window, win_length or cfg.n_fft)
    lo, hi = in_band_bins(cfg.sample_rate, cfg.n_fft, embedding_bands)
    with torch.no_grad():
        return net(preprocess_magnitude(audios, cfg.n_fft, hop_length, w, lo, hi), precision)


def detect_values(net: DetectorNet, audio: torch.Tensor, **kwargs) -> torch.Tensor:
    """One waveform (L,) -> detector values (output_length,)."""
    return detect_values_batch(net, audio[None], **kwargs)[0]
