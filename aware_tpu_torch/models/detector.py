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
    4x: x = act(norm(W_i @ x + b_i))     # channels 128-512-1024-1024-40
    out = final_act(mean_t(x)[0::2] - mean_t(x)[1::2])     # BRH, (B, 20)

The default card's architecture is instance norm, leaky ReLU 0.2 and
tanh; every architecture of ``DetectorNetConfig`` runs, with the JAX
package's tables (``block_activation``, ``final_activation``) and its
initial parameters (``init_params``: the key bundle, the golden key, or a
fresh xavier init from ``jax.random``'s threefry bits, written here in
numpy).  Every normalization is per clip, as under ``vmap`` in the JAX
package.
The mel projection and the 1x1 convolutions are batched matmuls at the
card's ``matmul_precision`` (:func:`matmul`): float32 for "high" and
"highest", one bf16 pass for "default"; the callers turn TF32 off
(``service.api.load``) so that they match the JAX package.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
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


# threefry2x32's rotations and key-schedule constant (jax.random's PRNG)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash (20 rounds) of the counter pairs (x0, x1)
    (uint32 arrays) under ``key`` (two uint32), as ``jax.random`` computes
    it; uint32 array arithmetic wraps."""
    k = np.asarray(key, np.uint32).reshape(2, 1)
    ks = (k[0], k[1], k[0] ^ k[1] ^ np.uint32(_KS_PARITY))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[1] ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_2x32(n: int) -> tuple[np.ndarray, np.ndarray]:
    """A uint64 iota of n as its high and low uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed as an
    int32, so the key is (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def prng_split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` under ``jax_threefry_partitionable`` (JAX's
    default): key i is the hash of the 64-bit counter i.  (num, 2)."""
    bits1, bits2 = _threefry2x32(key, *_iota_2x32(num))
    return np.stack([bits1, bits2], axis=1)


def prng_uniform(key: np.ndarray, shape: tuple[int, ...], minval: float,
                 maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` under
    ``jax_threefry_partitionable``: 32 bits per element (the two hash
    words xor-ed), their top 23 as the mantissa of a float in [1, 2),
    then scaled and shifted as one fused multiply-add into float32, as
    XLA's CPU backend contracts it."""
    bits1, bits2 = _threefry2x32(key, *_iota_2x32(int(np.prod(shape))))
    bits = bits1 ^ bits2
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # exact in float64 (a 23-bit fraction times a float32, plus a float32 of
    # the product's exponent range), so one rounding: the fused result
    fused = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fused).reshape(shape)


def init_params(cfg: DetectorNetConfig) -> dict[str, np.ndarray]:
    """The detector's parameters as numpy, chosen as the JAX package's
    ``init_params`` chooses them: the bundle ``cfg.key_file`` names; with
    none, the golden key for the default configuration (its seed
    included); otherwise a fresh xavier-uniform init keyed by ``cfg.seed``
    through ``jax.random`` (the same bits: ``prng_split``,
    ``prng_uniform``), the fan counting ``kernel_size``, biases zero."""
    if cfg.key_file:
        return load_key_params(cfg.key_file)
    if cfg == DetectorNetConfig() and KEY_FILE.exists():
        return load_key_params()
    rng = prng_key(cfg.seed)
    params: dict[str, np.ndarray] = {}
    ch = cfg.channels
    for i in range(cfg.num_blocks + 1):
        rng, sub = prng_split(rng)
        fan_in, fan_out = ch[i] * cfg.kernel_size, ch[i + 1] * cfg.kernel_size
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        params[f"conv{i}_w"] = prng_uniform(sub, (ch[i + 1], ch[i]), -bound, bound)
        params[f"conv{i}_b"] = np.zeros(ch[i + 1], dtype=np.float32)
    return params


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


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


# the readout activations (the JAX package's table, reference:
# multibit_detector_net.py:82-96); gelu is jax.nn.gelu's default, the tanh
# approximation
_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "leaky_relu": _leaky_relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def block_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The conv blocks' activation: leaky_relu (slope 0.2), gelu (tanh
    approximation), swish (silu), and relu for any other name, silently,
    as the JAX package's ``_block_activation``."""
    name = name.lower()
    return _ACTIVATIONS[name] if name in ("leaky_relu", "gelu", "swish") else torch.relu


def final_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The readout's activation; an unknown name raises ValueError."""
    name = name.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f"Invalid activation: {name}")
    return _ACTIVATIONS[name]


def _check_norm(norm_layer: str) -> None:
    if norm_layer not in ("instance", "none"):
        raise ValueError(f"Invalid norm layer: {norm_layer}")


class DetectorNet(nn.Module):
    """The frozen keyed detector: the mel basis and the conv weights are
    buffers, so nothing in it is trained.  The weights' shapes are not
    checked here: a key bundle of another architecture raises at the first
    product, as in the JAX package."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: DetectorNetConfig):
        super().__init__()
        self.cfg = cfg
        basis = mel_filter_bank(cfg.sample_rate, cfg.n_fft, cfg.n_mels)
        self.register_buffer("mel_basis", torch.from_numpy(basis.copy()))
        for i in range(cfg.num_blocks + 1):
            self.register_buffer(f"conv{i}_w", params[f"conv{i}_w"].float())
            self.register_buffer(f"conv{i}_b", params[f"conv{i}_b"].float())

    def _stack(self, mel: torch.Tensor, precision: str) -> torch.Tensor:
        cfg = self.cfg
        act = block_activation(cfg.activation)
        _check_norm(cfg.norm_layer)
        x = instance_norm(mel)
        x = global_standardize(x)
        x = avg_pool_1d(x, cfg.initial_pool_size, cfg.initial_pool_stride)
        for i in range(cfg.num_blocks + 1):
            w = getattr(self, f"conv{i}_w")
            b = getattr(self, f"conv{i}_b")
            x = matmul(w, x, precision) + b[:, None]
            if cfg.norm_layer == "instance":
                x = instance_norm(x)
            x = act(x)
        pooled = x.mean(dim=-1)
        return final_activation(cfg.final_activation)(pooled[..., 0::2] - pooled[..., 1::2])

    def forward(self, mag: torch.Tensor, precision: str = "highest") -> torch.Tensor:
        """Magnitude (..., F, T) -> bit values (..., output_length), every
        product at ``precision`` (:func:`matmul`)."""
        return self._stack(matmul(self.mel_basis, mag, precision), precision)

    def forward_with(self, params: dict[str, torch.Tensor], mag: torch.Tensor,
                     precision: str = "highest") -> torch.Tensor:
        """:meth:`forward` with the conv weights of ``params`` (the JAX
        package's names) in place of the module's frozen ones, through
        ``torch.func.functional_call``: differentiable w.r.t. them, for
        training the detector jointly.  The serving path keeps the
        buffers."""
        return torch.func.functional_call(self, params, (mag, precision))

    def forward_banded(self, band_mag: torch.Tensor, lo: int, hi: int,
                       precision: str = "highest") -> torch.Tensor:
        """Forward from the in-band rows (..., hi-lo, T) alone: identical to
        :meth:`forward` on the band-zeroed magnitude, since out-of-band rows
        add nothing to the mel projection.  The embed solver's entry."""
        return self._stack(matmul(self.mel_basis[:, lo:hi], band_mag, precision), precision)

    def forward_masked(self, mag: torch.Tensor, mask: torch.Tensor,
                       precision: str = "highest",
                       reduce: Callable[[torch.Tensor], torch.Tensor] | None = None
                       ) -> torch.Tensor:
        """Forward over zero-padded magnitudes (H, F, T) with frame-validity
        masks: (H, T) -> values (H, output_length), or (H, K, T) -> (H, K,
        output_length), one readout a mask of the same magnitude.  Equal,
        to float tolerance, to :meth:`forward` on each lane's valid frames
        alone: every statistic and the readout's mean ignore masked frames,
        and the initial pool keeps only the windows with no masked frame,
        as the unpadded forward's floor division drops the rest.  The port
        of ``detector_apply_masked``, which lets lanes of different lengths
        run as one batch.

        ``reduce``, where given, completes each sum over frames (the frame
        counts, the statistics' sums, the readout's) before it is used: the
        sequence-parallel forward (``parallel/streaming.py``) passes an
        all-reduce over the ranks that hold the other frames, whose sums
        are the JAX package's ``psum``."""
        cfg = self.cfg
        size = cfg.initial_pool_size
        if size != cfg.initial_pool_stride:
            raise ValueError("masked forward supports size==stride pooling only")
        act = block_activation(cfg.activation)
        _check_norm(cfg.norm_layer)

        def tsum(t: torch.Tensor, dims=-1) -> torch.Tensor:
            out = t.sum(dims, keepdim=True)
            return out if reduce is None else reduce(out)

        mel = matmul(self.mel_basis, mag, precision)  # (H, C, T)
        if mask.dim() == mag.dim():  # (H, K, T): K readouts of each lane
            mel = mel.unsqueeze(-3)
        m = mask.to(mel.dtype).unsqueeze(-2)  # (..., 1, T)
        x = mel * m
        n = tsum(m)
        # masked InstanceNorm1d (biased variance over the valid frames)
        mean = tsum(x * m) / n
        var = tsum(((x - mean) * m) ** 2) / n
        x = (x - mean) * torch.rsqrt(var + 1e-5) * m
        # masked GlobalStandardize (unbiased over C * n_valid elements)
        n_el = x.shape[-2] * n
        gmean = tsum(x * m, (-2, -1)) / n_el
        gvar = tsum(((x - gmean) * m) ** 2, (-2, -1)) / (n_el - 1.0)
        x = (x - gmean) / (torch.sqrt(gvar) + 1e-8) * m

        t_out = x.shape[-1] // size
        x = x[..., : t_out * size].reshape(*x.shape[:-1], t_out, size).mean(-1)
        mp = m[..., : t_out * size].reshape(*m.shape[:-1], t_out, size).prod(-1)
        x = x * mp
        n_pool = tsum(mp)
        for i in range(cfg.num_blocks + 1):
            w = getattr(self, f"conv{i}_w")
            b = getattr(self, f"conv{i}_b")
            x = (matmul(w, x, precision) + b[:, None]) * mp
            if cfg.norm_layer == "instance":
                mean = tsum(x * mp) / n_pool
                var = tsum(((x - mean) * mp) ** 2) / n_pool
                x = (x - mean) * torch.rsqrt(var + 1e-5) * mp
            x = act(x) * mp
        pooled = (tsum(x * mp) / n_pool)[..., 0]
        return final_activation(cfg.final_activation)(pooled[..., 0::2] - pooled[..., 1::2])


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
    detector's products at ``precision`` (:func:`matmul`).  The frames are
    the net's n_fft long and the window the card's ``win_length``, as in
    the JAX package's ``detect_values``: a card whose frame length is not
    the net's n_fft raises ValueError here, as the JAX package's broadcast
    of the window over the frames does."""
    cfg = net.cfg
    w = get_window(window, win_length or cfg.n_fft)
    if len(w) != cfg.n_fft:
        raise ValueError(
            f"Incompatible shapes for broadcasting: frames (T, {cfg.n_fft}) of the detector's "
            f"n_fft and a window of {len(w)} (the card's win_length)")
    lo, hi = in_band_bins(cfg.sample_rate, cfg.n_fft, embedding_bands)
    with torch.no_grad():
        return net(preprocess_magnitude(audios, cfg.n_fft, hop_length, w, lo, hi), precision)


def detect_values(net: DetectorNet, audio: torch.Tensor, **kwargs) -> torch.Tensor:
    """One waveform (L,) -> detector values (output_length,)."""
    return detect_values_batch(net, audio[None], **kwargs)[0]
