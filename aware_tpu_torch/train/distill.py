"""Solver-distilled training of the amortized embedder.

The port of ``aware_tpu/train/distill.py``: the batched solver's optimized
in-band coefficients become regression targets over a diverse clip corpus.

* ``diverse_clip``: the mixed-family speech-like generator, numpy, bit
  for bit the JAX package's;
* ``generate_targets``: the port's batched solver (``embed_batch``: on the
  default card the whole-step kernel, row 11 of the TPU kernel table,
  once an iteration) over the corpus;
* ``make_distill_step``: box-normalized regression onto the targets plus a
  small detection term on the (no round trip) band; and
  ``make_distill_step_visible``: the round-tripped (detector-visible)
  regression with the phase-conditioned net.  Both are plain torch with
  autograd, through ``distill_optimizer`` (the JAX package's
  ``chain(clip_by_global_norm(1), adamw(lr, 1e-5))``, without
  ``apply_if_finite``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from aware_tpu_torch.config import AwareConfig, in_band_bins
from aware_tpu_torch.device import resolve_device
from aware_tpu_torch.embed.solver import embed_batch
from aware_tpu_torch.models.detector import DetectorNet, params_from_jax
from aware_tpu_torch.ops.stft import istft, magphase, peak_normalize, polar, stft
from aware_tpu_torch.ops.windows import get_window
from aware_tpu_torch.train.adversarial import (
    AdamW,
    TrainConfig,
    TrainState,
    detector_apply,
    embedder_apply,
)


# ----------------------------------------------------- clip distribution ---

def diverse_clip(seed: int, seconds: float = 2.0, sr: int = 16000) -> np.ndarray:
    """A clip of one of four speech-like families (bright harmonic voice,
    formant-weighted vowel, buzzy pulse train, voiced + aspiration noise),
    picked by ``seed % 4``, peak-normalized, float32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    family = seed % 4

    f0 = (80.0 + 160.0 * rng.random()) * (
        1.0 + 0.15 * np.sin(2 * np.pi * (0.5 + 3.0 * rng.random()) * t)
    )
    phase = np.cumsum(2 * np.pi * f0 / sr)
    x = np.zeros(n)

    if family == 0:  # 1/k harmonic comb
        for k in range(1, 25):
            x += np.cos(k * phase + rng.random() * 6.28) / k
    elif family == 1:  # formant-weighted harmonics
        formants = 300.0 + 3000.0 * rng.random(3)
        for k in range(1, 40):
            fk = k * np.mean(f0)
            w = sum(np.exp(-0.5 * ((fk - fm) / 200.0) ** 2) for fm in formants)
            x += (w + 0.05) * np.cos(k * phase + rng.random() * 6.28)
    elif family == 2:  # pulse train through a decaying spectrum
        for k in range(1, 60):
            x += np.cos(k * phase) / np.sqrt(k)
    else:  # voiced + strong aspiration noise
        for k in range(1, 15):
            x += np.cos(k * phase + rng.random() * 6.28) / k
        x += 0.5 * rng.standard_normal(n) * np.abs(np.sin(phase / 8.0))

    env_rate = 1.5 + 4.0 * rng.random()
    env = 0.3 + 0.7 * np.clip(np.sin(2 * np.pi * env_rate * t + rng.random() * 6), 0, None)
    x = x * env + 0.02 * rng.standard_normal(n)
    return (x / (np.max(np.abs(x)) + 1e-9)).astype(np.float32)


# --------------------------------------------------------- target dataset ---

def generate_targets(
    d_params,
    cfg: AwareConfig,
    n_clips: int,
    batch: int = 32,
    seed: int = 0,
    clip_fn: Callable[[int], np.ndarray] = diverse_clip,
    solver_iterations: int = 400,
    device: str | torch.device | None = None,
):
    """The solver over a diverse corpus: numpy (clips (N, L), band
    magnitudes (N, nb, T), patterns (N, bits), targets (N, nb, T)).
    ``d_params`` is the detector's weights (the JAX package's names) or a
    ``DetectorNet`` (a handle's ``net``, on its own device); the solve runs
    on ``device`` (the card unless "cpu") or the net's.  The clips and
    patterns are the JAX package's for the same seed."""
    if isinstance(d_params, DetectorNet):
        net = d_params
    else:
        net = DetectorNet(params_from_jax({k: np.asarray(v) for k, v in d_params.items()}),
                          cfg.detection_net).to(resolve_device(device))
    rng = np.random.default_rng(seed)
    scfg = cfg.replace(num_iterations=solver_iterations)
    dev = net.mel_basis.device
    window = get_window(cfg.window, cfg.win_length)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, cfg.frame_length, cfg.embedding_bands)
    all_clips, bands, patterns, targets = [], [], [], []
    n_bits = cfg.detection_net.output_length
    for start in range(0, n_clips, batch):
        b = min(batch, n_clips - start)
        clips = np.stack([clip_fn(seed * 131071 + start + i) for i in range(b)])
        pats = (rng.integers(0, 2, (b, n_bits)) * 2 - 1).astype(np.float32)
        x = torch.as_tensor(clips, device=dev)
        res = embed_batch(net, x, torch.as_tensor(pats, device=dev), scfg)
        mags, _ = magphase(stft(peak_normalize(x), cfg.frame_length, cfg.hop_length, window))
        all_clips.append(clips)
        bands.append(mags[:, lo:hi].cpu().numpy())
        patterns.append(pats)
        targets.append(res.coeffs.cpu().numpy())
    return (np.concatenate(all_clips), np.concatenate(bands), np.concatenate(patterns),
            np.concatenate(targets))


# ------------------------------------------------------------ distillation ---

def distill_optimizer(tcfg: TrainConfig) -> AdamW:
    """The optimizer of both distill steps; their ``opt_state`` is this
    one's ``init({"e": e_params})``, not the adversarial optimizer's."""
    return AdamW({"e": (("e",), tcfg.learning_rate, 1e-5)})


def _band_zeroed(band: torch.Tensor, lo: int, hi: int, n_freq: int) -> torch.Tensor:
    b, _, t = band.shape
    return torch.cat([band.new_zeros(b, lo, t), band, band.new_zeros(b, n_freq - hi, t)], dim=1)


def _push_extremes(out, p):
    return torch.mean((out - p) ** 2, dim=-1) - 0.1 * torch.mean(out.abs(), dim=-1)


def _step(opt, state: TrainState, loss_fn, *batch):
    """One optimizer step of the embedder on ``loss_fn(e_params, *batch)
    -> (loss, metrics)``, the batch's arrays moved to the embedder's device."""
    dev = next(iter(state.e_params.values())).device
    batch = [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                             dtype=torch.float32, device=dev) for a in batch]
    leaves = {k: v.detach().requires_grad_(True) for k, v in state.e_params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    e_params = dict(state.e_params)
    with torch.no_grad():
        opt_state = opt.update({"e": dict(zip(leaves, grads))}, state.opt_state,
                               {"e": e_params})
    metrics = {k: v.detach() for k, v in metrics.items()}
    return TrainState(e_params, state.d_params, opt_state, state.step + 1), metrics


def make_distill_step(cfg: AwareConfig, tcfg: TrainConfig, lambda_det: float = 0.1):
    """``step(state, band, pattern, target, key=None) -> (state, metrics)``
    on band magnitudes (B, nb, T), patterns (B, bits) and targets (B, nb,
    T): the mean of the box-normalized squared error ((pred - target) /
    delta) plus lambda_det x the detection loss of the band-zeroed
    prediction (no round trip)."""
    opt = distill_optimizer(tcfg)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, cfg.frame_length, cfg.embedding_bands)
    n_freq = cfg.frame_length // 2 + 1

    def loss_fn(e_params, d_params, band, pattern, target):
        pred = embedder_apply(e_params, band, pattern, cfg.tolerance_db)
        delta = band * (10.0 ** (-cfg.tolerance_db / 20.0)) + 1e-6
        reg = torch.mean(((pred - target) / delta) ** 2, dim=(1, 2))
        out = detector_apply(d_params, _band_zeroed(pred, lo, hi, n_freq), cfg.detection_net,
                             cfg.matmul_precision)
        det = _push_extremes(out, pattern)
        soft_ber = torch.mean(torch.sigmoid(-4.0 * out * pattern), dim=-1)
        loss = reg.mean() + lambda_det * det.mean()
        return loss, {"loss": loss, "reg": reg.mean(), "det_loss": det.mean(),
                      "soft_ber": soft_ber.mean()}

    def step(state: TrainState, band, pattern, target, key=None):
        return _step(opt, state, lambda e, *b: loss_fn(e, state.d_params, *b),
                     band, pattern, target)

    return step


def make_distill_step_visible(cfg: AwareConfig, tcfg: TrainConfig, lambda_det: float = 0.3):
    """``step(state, clips, patterns, targets) -> (state, metrics)`` on
    clips (B, L): the prediction (phase-conditioned where the bundle is)
    and the target pushed through the ISTFT -> STFT round trip, the share
    of the solver's visible signal the net has not reproduced,
    sum (vp - vt)^2 / sum (vt - v0)^2, plus lambda_det x the detection
    loss of the round-tripped prediction."""
    opt = distill_optimizer(tcfg)
    lo, hi = in_band_bins(cfg.detection_net.sample_rate, cfg.frame_length, cfg.embedding_bands)
    n_fft, hop = cfg.frame_length, cfg.hop_length
    n_freq = n_fft // 2 + 1
    window = get_window(cfg.window, cfg.win_length)

    def loss_fn(e_params, d_params, clips, patterns, targets):
        mag, phase = magphase(stft(peak_normalize(clips), n_fft, hop, window))
        band = mag[:, lo:hi]

        def visible(band_coeffs):
            wmag = torch.cat([mag[:, :lo], band_coeffs, mag[:, hi:]], dim=1)
            y = peak_normalize(istft(polar(wmag, phase), n_fft, hop, window))
            m2, _ = magphase(stft(peak_normalize(y), n_fft, hop, window))
            return m2[:, lo:hi]

        pred = embedder_apply(e_params, band, patterns, cfg.tolerance_db,
                              band_phase=phase[:, lo:hi])
        vp, vt, v0 = visible(pred), visible(targets), visible(band)
        reg = torch.sum((vp - vt) ** 2, dim=(1, 2)) / (torch.sum((vt - v0) ** 2, dim=(1, 2))
                                                       + 1e-12)
        out = detector_apply(d_params, _band_zeroed(vp, lo, hi, n_freq), cfg.detection_net,
                             cfg.matmul_precision)
        det = _push_extremes(out, patterns)
        soft_ber = torch.mean(torch.sigmoid(-4.0 * out * patterns), dim=-1)
        hard_ber = torch.mean((out * patterns <= 0).float(), dim=-1)
        loss = reg.mean() + lambda_det * det.mean()
        return loss, {"loss": loss, "reg": reg.mean(), "det_loss": det.mean(),
                      "soft_ber": soft_ber.mean(), "hard_ber": hard_ber.mean()}

    def step(state: TrainState, clips, patterns, targets):
        return _step(opt, state, lambda e, *b: loss_fn(e, state.d_params, *b),
                     clips, patterns, targets)

    return step
