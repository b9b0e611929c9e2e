"""The batched adversarial embed solver.

The port of ``aware_tpu/embed/solver.py`` on the path it takes with
``use_pallas_roundtrip=True, use_pallas_detector=False`` (its
``build_problem`` slab-kernel geometry, ``embed_core``, ``embed_batch``
and ``_reconstruct``).  Each of ``num_iterations`` steps, for all B clips
at once, in the padded time-major (B, T, P) coefficient layout:

    synth_norm (kernel)   coeffs -> slab synthesis -> OLA -> envelope
                          -> + out-of-band waveform -> double peak-norm -> y2
    band_analysis (kernel) y2 -> zero-pad framing -> in-band Re/Im
    + edge_corrections    the reflect-pad rows the kernel leaves out
    safe_magnitude -> banded detector -> push_extremes loss (per clip)
    backward through the same chain (the kernels' VJPs)
    NAdam step at the lr from before this step's scheduler tick,
    scheduler tick, clamp to the +/- tolerance_db box, best snapshot.

Reference quirks kept: the best snapshot pairs iteration t's loss with the
post-step, post-clamp coefficients; the box comes from the initial
magnitudes with the lower bound clipped at 0; the output is rebuilt from
the original magnitude with the best coefficients written in, and is
(T-1)*hop samples long.  The padding columns of the (T, P) layout have
zero bounds and zero gradients, so they stay 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from aware_tpu_torch.config import AwareConfig, in_band_bins
from aware_tpu_torch.embed.losses import push_extremes
from aware_tpu_torch.embed.optim import nadam
from aware_tpu_torch.embed.schedulers import reduce_lr_on_plateau
from aware_tpu_torch.models.detector import DetectorNet
from aware_tpu_torch.ops.kernels.roundtrip import (
    R,
    band_analysis,
    edge_corrections,
    synth_norm,
)
from aware_tpu_torch.ops.stft import (
    _ola_envelope,
    irfft_basis,
    istft,
    istft_synthesis,
    magphase,
    peak_normalize,
    polar,
    rfft_basis,
    safe_magnitude,
    stft,
)
from aware_tpu_torch.ops.windows import get_window

# the whole-clip kernels' reach; longer clips take the JAX package's
# time-tiled kernels (ops/pallas/roundtrip_tiled.py), not ported yet
MAX_FRAMES = 1024


class EmbedResult(NamedTuple):
    audio: torch.Tensor       # (B, (T-1)*hop) watermarked waveforms
    best_loss: torch.Tensor   # (B,) best objective seen
    final_loss: torch.Tensor  # (B,) objective at the last iteration
    coeffs: torch.Tensor      # (B, n_band, T) best in-band magnitudes


def check_supported(cfg: AwareConfig) -> None:
    """Raise for a configuration that would need a path not ported."""
    unported = []
    if not cfg.use_pallas_roundtrip:
        unported.append("use_pallas_roundtrip=False (the XLA slab path)")
    if cfg.use_pallas_detector:
        unported.append("use_pallas_detector=True (the fused detector kernels)")
    if cfg.optimizer_name != "nadam":
        unported.append(f"optimizer {cfg.optimizer_name!r}")
    if cfg.loss != "push_extremes":
        unported.append(f"loss {cfg.loss!r}")
    if cfg.scheduler_name != "reduce_lr_on_plateau":
        unported.append(f"scheduler {cfg.scheduler_name!r}")
    if cfg.frame_length != R * cfg.hop_length or cfg.hop_length % 128:
        unported.append(
            f"frame geometry {cfg.frame_length}/{cfg.hop_length} "
            "(the kernels need n_fft == 4 * hop, hop % 128 == 0)"
        )
    if cfg.win_length != cfg.frame_length:
        unported.append("win_length != frame_length")
    if cfg.vad != "spectral":
        unported.append(f"vad {cfg.vad!r}")
    if unported:
        raise NotImplementedError(
            "not ported to aware_tpu_torch: " + "; ".join(unported)
        )


@dataclasses.dataclass
class Problem:
    """A batch's embed problem in the kernels' padded (B, T, P) layout."""

    ct0: torch.Tensor       # (B, T, P) initial coefficients
    lower: torch.Tensor     # (B, T, P) box
    upper: torch.Tensor
    wm: torch.Tensor        # (B, n_bits) bipolar targets
    csin: torch.Tensor      # (B, T, 2P) bf16 [cos | sin] of the in-band phase
    y_const: torch.Tensor   # (B, T-1, hop) envelope-divided out-of-band waveform
    env: torch.Tensor       # (T-1, hop) OLA envelope
    ab: torch.Tensor        # (2P, n_fft) bf16 synthesis basis, window folded
    abt: torch.Tensor
    csw: torch.Tensor       # (n_fft, 2P) bf16 windowed analysis basis
    cswt: torch.Tensor
    csw_k: list             # R float32 (hop, 2P) slabs of csw
    mag: torch.Tensor       # (B, F, T) original magnitude
    phase: torch.Tensor     # (B, F, T)
    lo: int
    hi: int

    @property
    def nb(self) -> int:
        return self.hi - self.lo


def build_problem(
    audios: torch.Tensor, watermarks: torch.Tensor, cfg: AwareConfig
) -> Problem:
    """Preprocess B equal-length clips (B, L) and build the kernels'
    constants (peak-norm -> STFT -> magnitude/phase -> bases)."""
    n_fft, hop = cfg.frame_length, cfg.hop_length
    dev = audios.device
    window = get_window(cfg.window, cfg.win_length)
    net_cfg = cfg.detection_net
    lo, hi = in_band_bins(net_cfg.sample_rate, n_fft, cfg.embedding_bands)
    nb = hi - lo

    x = peak_normalize(audios)
    mag, phase = magphase(stft(x, n_fft, hop, window))  # (B, F, T)
    t_frames = mag.shape[-1]
    if t_frames > MAX_FRAMES:
        raise NotImplementedError(
            f"clips over {MAX_FRAMES} frames need the time-tiled round-trip "
            "kernels (aware_tpu/ops/pallas/roundtrip_tiled.py), which are "
            "not ported yet"
        )
    coeffs0 = mag[:, lo:hi]
    delta = coeffs0 * (10.0 ** (-cfg.tolerance_db / 20.0))
    lower = torch.clamp(coeffs0 - delta, min=0.0)
    upper = coeffs0 + delta
    cos_ph, sin_ph = torch.cos(phase), torch.sin(phase)

    a_np, b_np = irfft_basis(n_fft)
    c_np, s_np = rfft_basis(n_fft)
    wvec = window.astype(np.float32)
    aw = torch.from_numpy(a_np * wvec[None, :]).to(dev)
    bw = torch.from_numpy(b_np * wvec[None, :]).to(dev)
    re_full, im_full = mag * cos_ph, mag * sin_ph
    # the constant (out-of-band) part of the windowed ISTFT frames
    frames_const = (
        re_full[:, :lo].transpose(1, 2) @ aw[:lo]
        + re_full[:, hi:].transpose(1, 2) @ aw[hi:]
        + im_full[:, :lo].transpose(1, 2) @ bw[:lo]
        + im_full[:, hi:].transpose(1, 2) @ bw[hi:]
    )
    y_const = istft_synthesis(frames_const, n_fft, hop, window).reshape(
        -1, t_frames - 1, hop
    )
    env = torch.as_tensor(
        _ola_envelope(tuple(window.tolist()), n_fft, hop, t_frames),
        dtype=torch.float32,
        device=dev,
    ).reshape(t_frames - 1, hop)

    # band padded to a multiple of 128 columns; Re block at [0, P), Im
    # block at [P, 2P) in both bases and in the analysis output
    p = -(-nb // 128) * 128
    ab_np = np.zeros((2 * p, n_fft), np.float32)
    ab_np[:nb] = (a_np * wvec[None, :])[lo:hi]
    ab_np[p : p + nb] = (b_np * wvec[None, :])[lo:hi]
    csw_np = np.zeros((n_fft, 2 * p), np.float32)
    csw_np[:, :nb] = c_np[:, lo:hi] * wvec[:, None]
    csw_np[:, p : p + nb] = s_np[:, lo:hi] * wvec[:, None]

    def bf16(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.bfloat16)

    csin = torch.zeros(mag.shape[0], t_frames, 2 * p, device=dev)
    csin[..., :nb] = cos_ph[:, lo:hi].transpose(1, 2)
    csin[..., p : p + nb] = sin_ph[:, lo:hi].transpose(1, 2)

    def to_carry(c: torch.Tensor) -> torch.Tensor:
        out = c.new_zeros(c.shape[0], t_frames, p)
        out[..., :nb] = c.transpose(1, 2)
        return out

    return Problem(
        ct0=to_carry(coeffs0),
        lower=to_carry(lower),
        upper=to_carry(upper),
        wm=watermarks.to(dev, torch.float32),
        csin=csin.to(torch.bfloat16),
        y_const=y_const.contiguous(),
        env=env,
        ab=bf16(ab_np),
        abt=bf16(ab_np.T),
        csw=bf16(csw_np),
        cswt=bf16(csw_np.T),
        csw_k=[
            torch.from_numpy(csw_np[k * hop : (k + 1) * hop].copy()).to(dev)
            for k in range(R)
        ],
        mag=mag,
        phase=phase,
        lo=lo,
        hi=hi,
    )


def objective(ct: torch.Tensor, pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """Per-clip loss (B,) of the coefficients ct (B, T, P)."""
    t_frames, p = ct.shape[1], ct.shape[2]
    y2 = synth_norm(ct, pb.csin, pb.y_const, pb.env, pb.ab, pb.abt)
    cs2 = band_analysis(y2, pb.csw, pb.cswt) + edge_corrections(
        y2.reshape(y2.shape[0], -1), pb.csw_k, cfg.frame_length,
        cfg.hop_length, t_frames,
    )
    m2 = safe_magnitude(cs2[..., : pb.nb], cs2[..., p : p + pb.nb])
    pred = net.forward_banded(m2.transpose(1, 2), pb.lo, pb.hi)
    return push_extremes(pred, pb.wm)


def _reconstruct(pb: Problem, best_coeffs: torch.Tensor, cfg: AwareConfig):
    """Output waveforms from the original magnitude + best coefficients."""
    window = get_window(cfg.window, cfg.win_length)
    wmag = torch.cat([pb.mag[:, : pb.lo], best_coeffs, pb.mag[:, pb.hi :]], dim=1)
    return peak_normalize(
        istft(polar(wmag, pb.phase), cfg.frame_length, cfg.hop_length, window)
    )


def embed_batch(
    net: DetectorNet,
    audios: torch.Tensor,
    watermarks: torch.Tensor,
    cfg: AwareConfig,
) -> EmbedResult:
    """Embed B bipolar patterns (B, n_bits) into B equal-length clips
    (B, L), all on ``audios.device``."""
    check_supported(cfg)
    pb = build_problem(audios, watermarks, cfg)
    opt = nadam(**{k: v for k, v in cfg.opt_params.items() if k != "lr"})
    sched = reduce_lr_on_plateau(**cfg.sched_params)
    batch = audios.shape[0]

    ct = pb.ct0
    opt_state = opt.init(ct)
    sched_state = sched.init(float(cfg.opt_params.get("lr", 0.1)), batch, audios.device)
    best_loss = torch.full((batch,), float("inf"), device=audios.device)
    best = ct
    loss = best_loss
    for _ in range(cfg.num_iterations):
        leaf = ct.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = objective(leaf, pb, net, cfg)
            (g,) = torch.autograd.grad(loss.sum(), leaf)
        with torch.no_grad():
            loss = loss.detach()
            lr = sched_state["lr"]  # the lr from before this step's tick
            ct, opt_state = opt.update(g, opt_state, ct, lr)
            sched_state = sched.step(sched_state, loss)
            ct = torch.clamp(ct, pb.lower, pb.upper)
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best = torch.where(better[:, None, None], ct, best)

    with torch.no_grad():
        best_coeffs = best[..., : pb.nb].transpose(1, 2)
        audio = _reconstruct(pb, best_coeffs, cfg)
    return EmbedResult(audio, best_loss, loss, best_coeffs)

