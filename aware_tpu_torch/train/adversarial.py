"""Adversarial training of the amortized embedder against the keyed detector.

The port of ``aware_tpu/train/adversarial.py``.  An amortized embedder
network predicts the in-band magnitude perturbation of a clip in one
forward pass, inside the solver's +/- tolerance_db box, and is trained
through a random differentiable attack against the detector:

    mag --E(mag, pattern)--> perturbed band --ISTFT--> audio
    --random differentiable attack--> attacked audio --STFT-->
    --D (the keyed CNN)--> bit values
    loss = detection loss + lambda_percept * in-band log-magnitude MSE

Everything here is plain torch with autograd, on the card unless the
caller passes ``device="cpu"``: the JAX package computes it in XLA, with no
Pallas kernel (its convolutions and products are ``lax.conv`` and
``jnp.matmul``, here ``F.conv1d`` and ``torch.matmul``).  The one-shot
embed's serving path is ``service/fast.py``.

What the port keeps of the JAX package, line for line: the embedder's
parameter names, shapes, bounds and identity temporal taps (drawn from a
``torch.Generator(seed)``, whose bits are not JAX's; tests carry JAX's
parameters across); both convolution helpers flip their taps, a true
convolution, where ``F.conv1d`` correlates; ``jax.nn.gelu``'s tanh
approximation; the population std of the log-magnitude; the U-Net's
nearest x2 upsample, right zero pad and crop; the attacks' formulas
(``_attack_lowpass`` with the symmetric ``np.hanning(129)``); the
training patterns from ``np.random.default_rng(seed)``; and the optimizer
of ``optax.apply_if_finite(chain(clip_by_global_norm(1), adamw(lr,
wd)))`` (no epsilon in the clip; weight decay on every leaf, biases too;
with ``detector_lr`` a separate clip, AdamW state and rate for the
detector at wd 0, as ``optax.multi_transform``; a non-finite gradient
leaves the parameters and the inner state as they were and is counted,
and after 100 in a row the update is applied).

Each attack is split into a draw from an explicit generator (a CPU
``torch.Generator``: the draws are a few host numbers and one noise
vector) and a deterministic application, so that the tests can feed the
values JAX drew.  Checkpoints are the port's own (``torch.save`` of the
state in ``step_{n}/state.pt``), in the JAX package's directory layout
with its choice of the latest step; no orbax checkpoint is read.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from aware_tpu_torch.config import AwareConfig, DetectorNetConfig, in_band_bins
from aware_tpu_torch.device import float32_products, resolve_device
from aware_tpu_torch.models.detector import DetectorNet
from aware_tpu_torch.ops.stft import istft, magphase, peak_normalize, polar, stft
from aware_tpu_torch.ops.windows import get_window

Params = dict[str, torch.Tensor]


# ---------------------------------------------------------------- model ---

@dataclasses.dataclass(frozen=True)
class AmortizedEmbedderConfig:
    hidden: tuple[int, ...] = (256, 256)
    # depthwise temporal conv width between the 1x1 layers (0 disables)
    temporal_kernel: int = 9
    # condition on the in-band phase (cos / sin channels)
    phase_conditioned: bool = False
    # "mlp": per-frame 1x1 mixing + depthwise temporal convs; "unet": a
    # time-downsampled encoder / decoder with skip connections
    arch: str = "mlp"
    unet_channels: tuple[int, ...] = (96, 192, 384)
    unet_kernel: int = 5
    seed: int = 77

    def feature_dim(self, n_band: int, n_bits: int) -> int:
        return (3 if self.phase_conditioned else 1) * n_band + n_bits


# the init gain of convs feeding gelu (aware_tpu/train/adversarial.py:94-103)
_GELU_GAIN = 1.53


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _xavier_conv(gen: torch.Generator, o: int, i: int, k: int, gain: float = 1.0) -> torch.Tensor:
    return _uniform(gen, (o, i, k), float(gain * np.sqrt(6.0 / (i * k + o * k))))


def init_unet_params(ecfg: AmortizedEmbedderConfig, n_band: int, n_bits: int) -> Params:
    """The U-Net's parameters ("u_" keys), xavier-uniform with the gelu
    gain, zero biases, from ``torch.Generator().manual_seed(ecfg.seed)``."""
    gen = torch.Generator().manual_seed(ecfg.seed)
    ch, k = ecfg.unet_channels, ecfg.unet_kernel
    params = {"u_stem_w": _xavier_conv(gen, ch[0], ecfg.feature_dim(n_band, n_bits), k,
                                       _GELU_GAIN),
              "u_stem_b": torch.zeros(ch[0])}
    for i in range(len(ch) - 1):
        params[f"u_enc{i}_w"] = _xavier_conv(gen, ch[i + 1], ch[i], k, _GELU_GAIN)
        params[f"u_enc{i}_b"] = torch.zeros(ch[i + 1])
    params["u_mid_w"] = _xavier_conv(gen, ch[-1], ch[-1], k, _GELU_GAIN)
    params["u_mid_b"] = torch.zeros(ch[-1])
    for i in range(len(ch) - 2, -1, -1):
        params[f"u_dec{i}_w"] = _xavier_conv(gen, ch[i], ch[i + 1], k, _GELU_GAIN)
        params[f"u_dec{i}_b"] = torch.zeros(ch[i])
        params[f"u_mrg{i}_w"] = _xavier_conv(gen, ch[i], 2 * ch[i], 1, _GELU_GAIN)
        params[f"u_mrg{i}_b"] = torch.zeros(ch[i])
    params["u_head_w"] = _xavier_conv(gen, n_band, ch[0], 1)
    params["u_head_b"] = torch.zeros(n_band)
    return params


def init_embedder_params(ecfg: AmortizedEmbedderConfig, n_band: int, n_bits: int) -> Params:
    """(n_band + n_bits) -> hidden... -> n_band 1x1 layers, xavier-uniform,
    zero biases, each hidden layer with an identity depthwise temporal
    kernel; or the U-Net's (``arch == "unet"``)."""
    if ecfg.arch == "unet":
        return init_unet_params(ecfg, n_band, n_bits)
    gen = torch.Generator().manual_seed(ecfg.seed)
    dims = (ecfg.feature_dim(n_band, n_bits), *ecfg.hidden, n_band)
    params: Params = {}
    for i in range(len(dims) - 1):
        params[f"w{i}"] = _uniform(gen, (dims[i + 1], dims[i]),
                                   float(np.sqrt(6.0 / (dims[i] + dims[i + 1]))))
        params[f"b{i}"] = torch.zeros(dims[i + 1])
        if ecfg.temporal_kernel and i < len(dims) - 2:
            tk = torch.zeros(dims[i + 1], ecfg.temporal_kernel)
            tk[:, ecfg.temporal_kernel // 2] = 1.0
            params[f"t{i}"] = tk
    return params


def _same_pad(x: torch.Tensor, kw: int) -> torch.Tensor:
    return F.pad(x, (kw // 2, kw - 1 - kw // 2))


def _depthwise_time_conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, C, T) x (C, K) same-padded depthwise convolution along time
    (the taps flipped: ``F.conv1d`` correlates)."""
    return F.conv1d(_same_pad(x, k.shape[-1]), k.flip(-1)[:, None, :], groups=x.shape[1])


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(B, C_in, T) x (C_out, C_in, K) same-padded convolution along time,
    then + b."""
    return F.conv1d(_same_pad(x, w.shape[-1]), w.flip(-1), stride=stride) + b[:, None]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _unet_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, features, T) -> (B, n_band, T) through the time-downsampled U-Net."""
    n_levels = len([k for k in params if k.startswith("u_enc") and k.endswith("_w")])
    h = _gelu(_conv1d(x, params["u_stem_w"], params["u_stem_b"]))
    skips = []
    for i in range(n_levels):
        skips.append(h)
        h = _gelu(_conv1d(h, params[f"u_enc{i}_w"], params[f"u_enc{i}_b"], stride=2))
    h = _gelu(_conv1d(h, params["u_mid_w"], params["u_mid_b"]))
    for i in range(n_levels - 1, -1, -1):
        h = h.repeat_interleave(2, dim=-1)  # nearest x2 upsample
        skip = skips[i]
        t = skip.shape[-1]
        if h.shape[-1] < t:
            h = F.pad(h, (0, t - h.shape[-1]))
        h = _gelu(_conv1d(h[..., :t], params[f"u_dec{i}_w"], params[f"u_dec{i}_b"]))
        h = _gelu(_conv1d(torch.cat([h, skip], dim=1), params[f"u_mrg{i}_w"],
                          params[f"u_mrg{i}_b"]))
    return _conv1d(h, params["u_head_w"], params["u_head_b"])


def embedder_apply(
    params: Mapping[str, torch.Tensor],
    band_mag: torch.Tensor,
    pattern: torch.Tensor,
    tolerance_db: float,
    band_phase: torch.Tensor | None = None,
) -> torch.Tensor:
    """In-band magnitudes (B, n_band, T) + bipolar patterns (B, n_bits) ->
    perturbed magnitudes inside the solver's box, clip by clip.  The
    architecture is read off the bundle as the JAX package reads it: a
    U-Net where it has ``u_stem_w``, phase-conditioned where the first
    layer takes 3 n_band + n_bits inputs (then ``band_phase`` (B, n_band,
    T) is needed)."""
    b, n_band, t = band_mag.shape
    logmag = torch.log1p(band_mag)
    mean = logmag.mean(dim=(1, 2), keepdim=True)
    std = logmag.std(dim=(1, 2), keepdim=True, correction=0)
    logmag = (logmag - mean) / (std + 1e-6)
    pat = pattern[:, :, None].expand(b, pattern.shape[1], t)
    is_unet = "u_stem_w" in params
    in_w = params["u_stem_w" if is_unet else "w0"].shape[1]
    if in_w == 3 * n_band + pattern.shape[1]:
        if band_phase is None:
            raise ValueError("phase-conditioned amortized bundle needs band_phase")
        x = torch.cat([logmag, torch.cos(band_phase), torch.sin(band_phase), pat], dim=1)
    else:
        x = torch.cat([logmag, pat], dim=1)
    if is_unet:
        x = _unet_apply(params, x)
    else:
        n_layers = len([k for k in params if k.startswith("w")])
        for i in range(n_layers):
            x = torch.matmul(params[f"w{i}"], x) + params[f"b{i}"][:, None]
            if f"t{i}" in params:
                x = _depthwise_time_conv(x, params[f"t{i}"])
            if i < n_layers - 1:
                x = _gelu(x)
    delta_max = band_mag * (10.0 ** (-tolerance_db / 20.0))
    return torch.clamp(band_mag + torch.tanh(x) * delta_max, min=0.0)


# ------------------------------------------------- differentiable attacks ---

class Attack(NamedTuple):
    """A differentiable attack as a draw from a generator, ``draw(gen,
    length) -> values``, and a deterministic application, ``apply(audio
    (..., L), *values)``; calling it does both."""

    name: str
    draw: Callable
    apply: Callable

    def __call__(self, audio: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return self.apply(audio, *self.draw(gen, audio.shape[-1]))


def _draw_none(gen, length):
    return ()


def _apply_none(audio):
    return audio


def _draw_noise(gen, length):
    """(snr_db in [20, 40), a standard normal vector of ``length``)."""
    snr_db = 20.0 + 20.0 * float(torch.rand((), generator=gen))
    return snr_db, torch.randn(length, generator=gen)


def _apply_noise(audio, snr_db, noise):
    p = torch.mean(audio**2)
    sigma = torch.sqrt(p / (10.0 ** (snr_db / 10.0)))
    return audio + sigma * noise.to(audio)


def _draw_quantize(gen, length):
    """(8 or 16 bits, each with probability 1/2)."""
    return (8.0 + 8.0 * float(torch.rand((), generator=gen) < 0.5),)


def _apply_quantize(audio, bits):
    """PCM quantization with a straight-through rounding."""
    scale = 2.0 ** (bits - 1.0) - 1.0
    a = audio / (audio.abs().amax(dim=-1, keepdim=True) + 1e-8)
    q = a * scale
    q = q + (torch.round(q) - q).detach()
    return q / scale


LOWPASS_TAPS = 129


def _draw_lowpass(gen, length):
    """(the cutoff over 16 kHz, from [3.5, 5) kHz)."""
    return ((3500.0 + 1500.0 * float(torch.rand((), generator=gen))) / 16000.0,)


@functools.lru_cache(maxsize=4)
def _hanning(n: int, device: torch.device) -> torch.Tensor:
    # jnp.hanning: the symmetric window, not the periodic one of the STFT
    return torch.as_tensor(np.hanning(n).astype(np.float32), device=device)


def _apply_lowpass(audio, fc):
    """FIR lowpass: a windowed sinc of 129 taps, normalized to unit DC gain."""
    n = LOWPASS_TAPS
    t = torch.arange(n, dtype=torch.float32, device=audio.device) - (n - 1) / 2.0
    h = 2.0 * fc * torch.sinc(2.0 * fc * t) * _hanning(n, audio.device)
    h = h / h.sum()
    x = audio.reshape(-1, 1, audio.shape[-1])
    y = F.conv1d(F.pad(x, (n // 2, n // 2)), h.flip(0)[None, None])
    return y.reshape(audio.shape)


def _draw_dropout(gen, length):
    """(the start of a window of length // 20 samples, in [0, L - L // 20))."""
    d = length // 20
    return (int(torch.randint(0, length - d, (), generator=gen)),)


def _apply_dropout(audio, start):
    """Zero a 5 % window from ``start``."""
    n = audio.shape[-1]
    idx = torch.arange(n, device=audio.device)
    mask = ((idx < start) | (idx >= start + n // 20)).to(audio.dtype)
    return audio * mask


_attack_none = Attack("none", _draw_none, _apply_none)
_attack_noise = Attack("noise", _draw_noise, _apply_noise)
_attack_quantize = Attack("quantize", _draw_quantize, _apply_quantize)
_attack_lowpass = Attack("lowpass", _draw_lowpass, _apply_lowpass)
_attack_dropout = Attack("dropout", _draw_dropout, _apply_dropout)

DIFFERENTIABLE_ATTACKS: tuple[Attack, ...] = (
    _attack_none,
    _attack_noise,
    _attack_quantize,
    _attack_lowpass,
    _attack_dropout,
)

# the eval suite's desync rows (ts_0.8..1.2) and near-unity rates that
# mimic ps_5's vocoder smearing
DESYNC_STRETCH_RATES: tuple[float, ...] = (0.8, 0.9, 0.95, 0.997, 1.05, 1.1, 1.2)


def _cropped(attack: Attack, l_out: int) -> Attack:
    return Attack(attack.name, attack.draw,
                  lambda a, *v, f=attack.apply: f(a, *v)[..., :l_out])


def make_attack_list(
    length: int,
    desync: bool = False,
    stretch_rates: tuple[float, ...] = DESYNC_STRETCH_RATES,
    compression: bool = False,
) -> tuple[list[Attack], int]:
    """The attack branches, each cropped to the shortest branch's output
    (the vocoder stretches change the length): ``(attacks, out_length)``.
    ``desync`` adds a vocoder time stretch per rate, ``compression`` the
    codec channel models (mp3_approx q10 and q11, celp_approx nb8k)."""
    from aware_tpu_torch.attacks.celp import celp_approx
    from aware_tpu_torch.attacks.codec import mp3_approx
    from aware_tpu_torch.attacks.vocoder import stretched_length, time_stretch

    attacks = list(DIFFERENTIABLE_ATTACKS)
    out_lens = [length] * len(attacks)
    if desync:
        for r in stretch_rates:
            attacks.append(Attack(f"time_stretch {r}", _draw_none,
                                  lambda a, r=r: time_stretch(a, r)))
            out_lens.append(stretched_length(length, r))
    if compression:
        attacks += [
            Attack("mp3_approx 10", _draw_none, lambda a: mp3_approx(a, 16000, 10)),
            Attack("mp3_approx 11", _draw_none, lambda a: mp3_approx(a, 16000, 11)),
            Attack("celp_approx nb8k", _draw_none, lambda a: celp_approx(a, 16000, "nb8k")),
        ]
        out_lens += [length] * 3
    l_out = min(out_lens)
    return [_cropped(a, l_out) for a in attacks], l_out


def draw_attack(gen: torch.Generator, attacks: list, length: int) -> tuple[int, tuple]:
    """One clip's draw: the branch (uniform over ``attacks``) and its values."""
    idx = int(torch.randint(0, len(attacks), (), generator=gen))
    return idx, attacks[idx].draw(gen, length)


def apply_random_attack(audio: torch.Tensor, gen: torch.Generator,
                        attacks: list | None = None) -> torch.Tensor:
    """One differentiable attack picked at random, drawn and applied."""
    fns = list(DIFFERENTIABLE_ATTACKS) if attacks is None else attacks
    idx, values = draw_attack(gen, fns, audio.shape[-1])
    return fns[idx].apply(audio, *values)


# ------------------------------------------------------------- training ---

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    learning_rate: float = 3e-4
    lambda_percept: float = 1.0
    train_detector: bool = False
    # vocoder time-stretch branches in the attack mix
    desync_attacks: bool = False
    stretch_rates: tuple = DESYNC_STRETCH_RATES
    # the codec channel models in the attack mix
    compression_attacks: bool = False
    # the detection loss on both the clean and the attacked view
    dual_view: bool = False
    # the detector's own rate in joint training (None: the embedder's)
    detector_lr: float | None = None
    # "push_extremes" (the solver's default-card objective) or "margin"
    # (squared hinge on the per-bit agreement)
    det_loss: str = "push_extremes"
    margin_target: float = 0.5
    steps: int = 1000
    embedder: AmortizedEmbedderConfig = dataclasses.field(
        default_factory=AmortizedEmbedderConfig
    )


class TrainState(NamedTuple):
    e_params: Any
    d_params: Any
    opt_state: Any
    step: int


class AdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=wd))``
    over groups of parameter dicts, each group with its own clip, moments
    and rate (``optax.multi_transform``), optionally inside
    ``optax.apply_if_finite(max_consecutive_errors)``.  ``groups`` maps a
    group's name to (the names of its dicts, lr, wd)."""

    def __init__(self, groups: dict, max_consecutive_errors: int | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, max_norm: float = 1.0):
        self.groups = groups
        self.max_errors = max_consecutive_errors
        self.b1, self.b2, self.eps, self.max_norm = b1, b2, eps, max_norm

    def init(self, trainable: dict) -> dict:
        state = {"groups": {
            g: {"count": 0,
                "mu": {n: {k: torch.zeros_like(v) for k, v in trainable[n].items()} for n in names},
                "nu": {n: {k: torch.zeros_like(v) for k, v in trainable[n].items()} for n in names}}
            for g, (names, _, _) in self.groups.items()}}
        if self.max_errors is not None:
            state.update(notfinite_count=0, total_notfinite=0, last_finite=True)
        return state

    def update(self, grads: dict, state: dict, trainable: dict) -> dict:
        """Apply one step to ``trainable`` ({name: params dict}, whose
        entries it replaces) from ``grads`` of the same structure; returns
        the new state."""
        state = dict(state)
        if self.max_errors is not None:
            finite = all(bool(torch.isfinite(g).all()) for d in grads.values() for g in d.values())
            count = 0 if finite else state["notfinite_count"] + 1
            state.update(notfinite_count=count, last_finite=finite,
                         total_notfinite=state["total_notfinite"] + (not finite))
            if not (finite or count > self.max_errors):
                return state  # parameters and inner state as they were
        groups = {}
        for g, (names, lr, wd) in self.groups.items():
            gs = state["groups"][g]
            leaves = [(n, k) for n in names for k in trainable[n]]
            norm = torch.sqrt(sum(torch.sum(grads[n][k] ** 2) for n, k in leaves))
            clip = ~(norm < self.max_norm)  # a NaN norm clips, as optax's select
            count = gs["count"] + 1
            # float32 powers, as optax's bias correction takes them
            c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** count
            c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** count
            mu = {n: dict(gs["mu"][n]) for n in names}
            nu = {n: dict(gs["nu"][n]) for n in names}
            for n, k in leaves:
                p, gr = trainable[n][k], grads[n][k]
                gr = torch.where(clip, gr / norm * self.max_norm, gr)
                mu[n][k] = (1.0 - self.b1) * gr + self.b1 * mu[n][k]
                nu[n][k] = (1.0 - self.b2) * gr * gr + self.b2 * nu[n][k]
                u = mu[n][k] / c1.to(p.device)
                u = u / (torch.sqrt(nu[n][k] / c2.to(p.device)) + self.eps)
                trainable[n][k] = p + (-lr) * (u + wd * p)
            groups[g] = {"count": count, "mu": mu, "nu": nu}
        state["groups"] = groups
        return state


def _optimizer(tcfg: TrainConfig) -> AdamW:
    """The training optimizer (aware_tpu/train/adversarial.py:434-454)."""
    if tcfg.train_detector and tcfg.detector_lr is not None:
        groups = {"e": (("e",), tcfg.learning_rate, 1e-5), "d": (("d",), tcfg.detector_lr, 0.0)}
    elif tcfg.train_detector:
        groups = {"e": (("e", "d"), tcfg.learning_rate, 1e-5)}
    else:
        groups = {"e": (("e",), tcfg.learning_rate, 1e-5)}
    return AdamW(groups, max_consecutive_errors=100)


def _trainable(state: TrainState, tcfg: TrainConfig) -> dict:
    return {"e": state.e_params, "d": state.d_params} if tcfg.train_detector else {
        "e": state.e_params}


def _as_params(params, device) -> Params:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               dtype=torch.float32).to(device).clone()
            for k, v in params.items()}


def init_train_state(cfg: AwareConfig, tcfg: TrainConfig, d_params,
                     device: str | torch.device | None = None) -> TrainState:
    """A fresh state on ``device`` (the card unless "cpu"): the embedder's
    initial parameters, the detector's (``d_params``, numpy or torch, the
    JAX package's names), the optimizer's state and step 0."""
    dev = resolve_device(device)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, cfg.frame_length, cfg.embedding_bands)
    e_params = _as_params(init_embedder_params(tcfg.embedder, hi - lo,
                                               cfg.detection_net.output_length), dev)
    state = TrainState(e_params, _as_params(d_params, dev), None, 0)
    return state._replace(opt_state=_optimizer(tcfg).init(_trainable(state, tcfg)))


@functools.lru_cache(maxsize=8)
def _detector(net_cfg: DetectorNetConfig, device: torch.device) -> DetectorNet:
    """The detector's module (its mel basis and structure); its weights
    come from the caller's params dict in every call (``detector_apply``)."""
    ch = net_cfg.channels
    zeros = {}
    for i in range(net_cfg.num_blocks + 1):
        zeros[f"conv{i}_w"] = torch.zeros(ch[i + 1], ch[i])
        zeros[f"conv{i}_b"] = torch.zeros(ch[i + 1])
    return DetectorNet(zeros, net_cfg).to(device)


def detector_apply(d_params: Params, mag: torch.Tensor, net_cfg: DetectorNetConfig,
                   precision: str) -> torch.Tensor:
    """The detector's forward over a params dict, differentiable w.r.t. it:
    magnitudes (B, F, T) -> values (B, n_bits)."""
    return _detector(net_cfg, mag.device).forward_with(d_params, mag, precision)


def _push_extremes(pred, pattern):
    return torch.mean((pred - pattern) ** 2, dim=-1) - 0.1 * torch.mean(pred.abs(), dim=-1)


def _margin(pred, pattern, margin_target):
    return torch.mean(torch.relu(margin_target - pred * pattern) ** 2, dim=-1)


def _clip_loss(cfg: AwareConfig, e_params, d_params, audio, pattern, draws, attacks,
               dual_view=False, det_loss_kind="push_extremes", margin_target=0.5):
    """Per-clip (det_loss, percept, soft_ber, hard_ber), each (B,), of clips
    (B, L) and patterns (B, n_bits), clip b attacked by ``attacks[i]``
    with the values of ``draws[b] = (i, values)``."""
    n_fft, hop = cfg.frame_length, cfg.hop_length
    window = get_window(cfg.window, cfg.win_length)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, n_fft, cfg.embedding_bands)
    mag, phase = magphase(stft(peak_normalize(audio), n_fft, hop, window))
    band = mag[:, lo:hi]
    band_new = embedder_apply(e_params, band, pattern, cfg.tolerance_db,
                              band_phase=phase[:, lo:hi])
    wmag = torch.cat([mag[:, :lo], band_new, mag[:, hi:]], dim=1)
    wm_audio = peak_normalize(istft(polar(wmag, phase), n_fft, hop, window))
    attacked = torch.stack([attacks[i].apply(wm_audio[b], *values)
                            for b, (i, values) in enumerate(draws)])

    def detect(x):
        m2, _ = magphase(stft(peak_normalize(x), n_fft, hop, window))
        m2 = torch.cat([torch.zeros_like(m2[:, :lo]), m2[:, lo:hi],
                        torch.zeros_like(m2[:, hi:])], dim=1)
        return detector_apply(d_params, m2, cfg.detection_net, cfg.matmul_precision)

    def objective(pred):
        if det_loss_kind == "margin":
            return _margin(pred, pattern, margin_target)
        return _push_extremes(pred, pattern)

    pred = detect(attacked)
    det_loss = objective(pred)
    if dual_view:
        det_loss = 0.5 * (det_loss + objective(detect(wm_audio)))
    percept = torch.mean((torch.log1p(band_new) - torch.log1p(band)) ** 2, dim=(1, 2))
    soft_ber = torch.mean(torch.sigmoid(-4.0 * pred * pattern), dim=-1)
    hard_ber = torch.mean((pred * pattern <= 0).float(), dim=-1)
    return det_loss, percept, soft_ber, hard_ber


def make_train_step(cfg: AwareConfig, tcfg: TrainConfig, group=None):
    """``step(state, audios, patterns, gen=None, draws=None) -> (state,
    metrics)``: one adversarial step on clips (B, L) and bipolar patterns
    (B, n_bits) on the state's device.  Each clip's attack is drawn from
    the CPU generator ``gen``, or given in ``draws`` (one (branch, values)
    a clip, as ``draw_attack`` returns them).  The new state holds new
    parameter dicts; the old state's are left as they were.

    With ``group`` (the ``data`` axis's process group), the clips are this
    rank's rows of a batch split evenly over the group: the gradients
    (the detector's too, when it trains) and the metrics are averaged over
    the group before the clip and the optimizer, so that every rank takes
    the step of the whole batch and the parameters stay replicated."""
    opt = _optimizer(tcfg)

    def mean_over_group(tensors: list) -> list:
        if group is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        flat = flat / dist.get_world_size(group)
        return list(torch.split(flat, [t.numel() for t in tensors]))

    def step(state: TrainState, audios, patterns, gen=None, draws=None):
        trainable = {n: dict(d) for n, d in _trainable(state, tcfg).items()}
        dev = state.e_params[next(iter(state.e_params))].device
        audios = torch.as_tensor(audios, dtype=torch.float32, device=dev)
        patterns = torch.as_tensor(patterns, dtype=torch.float32, device=dev)
        length = (audios.shape[-1] // cfg.hop_length) * cfg.hop_length
        attacks, _ = make_attack_list(length, desync=tcfg.desync_attacks,
                                      stretch_rates=tcfg.stretch_rates,
                                      compression=tcfg.compression_attacks)
        if draws is None:
            draws = [draw_attack(gen, attacks, length) for _ in range(audios.shape[0])]
        leaves = {n: {k: v.detach().requires_grad_(True) for k, v in d.items()}
                  for n, d in trainable.items()}
        with torch.enable_grad():
            det, percept, soft_ber, hard_ber = _clip_loss(
                cfg, leaves["e"], leaves.get("d", state.d_params), audios, patterns, draws,
                attacks, dual_view=tcfg.dual_view, det_loss_kind=tcfg.det_loss,
                margin_target=tcfg.margin_target)
            loss = det.mean() + tcfg.lambda_percept * percept.mean()
            flat = [v for d in leaves.values() for v in d.values()]
            grads_flat = torch.autograd.grad(loss, flat)
        grads_flat = mean_over_group(list(grads_flat))
        it = iter(grads_flat)
        grads = {n: {k: next(it).reshape(v.shape) for k, v in d.items()}
                 for n, d in leaves.items()}
        with torch.no_grad():
            opt_state = opt.update(grads, state.opt_state, trainable)
        names = ("loss", "det_loss", "percept", "soft_ber", "hard_ber")
        values = mean_over_group([t.detach().reshape(1) for t in (
            loss, det.mean(), percept.mean(), soft_ber.mean(), hard_ber.mean())])
        metrics = {k: v.reshape(()) for k, v in zip(names, values)}
        return TrainState(trainable["e"], trainable.get("d", state.d_params), opt_state,
                          state.step + 1), metrics

    return step


train_step = make_train_step  # the JAX package's exported alias


def training_patterns(rng: np.random.Generator, batch: int, n_bits: int) -> np.ndarray:
    """One step's bipolar patterns from the numpy generator, bit for bit
    the JAX package's (aware_tpu/train/adversarial.py:620-627)."""
    return (rng.integers(0, 2, (batch, n_bits)) * 2 - 1).astype(np.float32)


def train_amortized_embedder(
    cfg: AwareConfig,
    tcfg: TrainConfig,
    d_params,
    clip_sampler: Callable[[int], np.ndarray],
    seed: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 200,
    mesh=None,
    init_e_params=None,
    device: str | torch.device | None = None,
) -> tuple[TrainState, list[dict[str, float]]]:
    """The adversarial training loop on ``device`` (the card unless "cpu").
    ``clip_sampler(step) -> (batch_size, L)`` supplies audio;
    ``init_e_params`` warm-starts the embedder.  The patterns come from
    ``np.random.default_rng(seed)`` as in the JAX package, the attacks'
    draws from ``torch.Generator().manual_seed(seed)``.

    With ``mesh`` (an ``aware_tpu_torch.parallel`` mesh; every rank calls
    this with the same arguments), the batch is split over its ``data``
    axis, on each rank's device: every rank draws the patterns and every
    clip's attack for the whole batch from the same seed and takes its own
    rows, so the run is the unsharded run's; the gradients and the
    history's metrics are averaged over ``data``, and only rank 0 writes
    checkpoints."""
    from aware_tpu_torch.utils.logger import logger

    group = None
    if mesh is not None:
        from aware_tpu_torch.parallel import Mesh
        from aware_tpu_torch.parallel.batch import local_rows

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be an aware_tpu_torch.parallel Mesh, not {mesh!r}")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        device, group = mesh.device, mesh.group("data")
    writer = mesh is None or dist.get_rank() == 0
    float32_products()
    state = init_train_state(cfg, tcfg, d_params, device)
    dev = state.e_params["w0" if "w0" in state.e_params else "u_stem_w"].device
    if init_e_params is not None:
        state = state._replace(e_params=_as_params(init_e_params, dev))
        state = state._replace(opt_state=_optimizer(tcfg).init(_trainable(state, tcfg)))
    step_fn = make_train_step(cfg, tcfg, group)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    history: list[dict[str, float]] = []
    n_bits = cfg.detection_net.output_length
    for i in range(tcfg.steps):
        audios = np.asarray(clip_sampler(i), np.float32)
        patterns = training_patterns(rng, audios.shape[0], n_bits)
        # every clip's attack, drawn for the whole batch in the batch's order
        length = (audios.shape[-1] // cfg.hop_length) * cfg.hop_length
        attacks, _ = make_attack_list(length, desync=tcfg.desync_attacks,
                                      stretch_rates=tcfg.stretch_rates,
                                      compression=tcfg.compression_attacks)
        draws = [draw_attack(gen, attacks, length) for _ in range(audios.shape[0])]
        if mesh is None:
            x, rows = torch.as_tensor(audios, device=dev), slice(None)
        else:
            x = local_rows(audios, mesh, "data")
            rows = slice(mesh.index("data") * len(x), (mesh.index("data") + 1) * len(x))
        state, metrics = step_fn(state, x, patterns[rows], draws=draws[rows])
        history.append({k: float(v) for k, v in metrics.items()})
        if i % 50 == 0:
            logger.info("train step %d: loss=%.4f soft_ber=%.4f hard_ber=%.4f percept=%.5f",
                        i, history[-1]["loss"], history[-1]["soft_ber"],
                        history[-1]["hard_ber"], history[-1]["percept"])
        if writer and checkpoint_dir and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state)
    if writer and checkpoint_dir:
        save_checkpoint(checkpoint_dir, state)
    return state, history


# ------------------------------------------------------------ inference ---

def amortized_embed(
    state_or_eparams,
    d_params,
    audio: np.ndarray,
    pattern: np.ndarray,
    cfg: AwareConfig,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """One-shot embed of one clip (L,) with a bipolar pattern (n_bits,)
    by the trained network, on ``device`` (the card unless "cpu"): the
    peak-normalized output of (T-1)*hop samples, as the solver's.
    ``d_params`` is unused, as in the JAX package."""
    e_params = (state_or_eparams.e_params if isinstance(state_or_eparams, TrainState)
                else state_or_eparams)
    dev = resolve_device(device)
    float32_products()
    ep = _as_params(e_params, dev)
    n_fft, hop = cfg.frame_length, cfg.hop_length
    window = get_window(cfg.window, cfg.win_length)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, n_fft, cfg.embedding_bands)
    with torch.no_grad():
        a = torch.as_tensor(np.asarray(audio, np.float32), device=dev)[None]
        p = torch.as_tensor(np.asarray(pattern, np.float32), device=dev)[None]
        mag, phase = magphase(stft(peak_normalize(a), n_fft, hop, window))
        band_new = embedder_apply(ep, mag[:, lo:hi], p, cfg.tolerance_db,
                                  band_phase=phase[:, lo:hi])
        wmag = torch.cat([mag[:, :lo], band_new, mag[:, hi:]], dim=1)
        out = peak_normalize(istft(polar(wmag, phase), n_fft, hop, window))
    return out[0].cpu().numpy()


# ---------------------------------------------------------- checkpoints ---

def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str | pathlib.Path, state: TrainState) -> None:
    """The whole train state in ``path/step_{n}/state.pt`` (overwritten)."""
    out = pathlib.Path(path).absolute() / f"step_{int(state.step)}"
    out.mkdir(parents=True, exist_ok=True)
    torch.save(_to_host(state._asdict()), out / "state.pt")


def restore_checkpoint(path: str | pathlib.Path, step: int | None = None,
                       device: str | torch.device | None = None) -> TrainState:
    """The state saved at ``step`` (the latest ``step_{n}`` where None),
    on ``device`` (the card unless "cpu")."""
    path = pathlib.Path(path).absolute()
    if step is None:
        steps = sorted(int(p.name.split("_")[1]) for p in path.glob("step_*") if p.is_dir())
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    tree = torch.load(path / f"step_{step}" / "state.pt", weights_only=True)
    tree = _to_device(tree, resolve_device(device))
    return TrainState(tree["e_params"], tree["d_params"], tree["opt_state"], int(tree["step"]))
