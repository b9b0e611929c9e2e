"""The batched adversarial embed solver.

The port of ``aware_tpu/embed/solver.py`` on its kernel paths
(``use_pallas_roundtrip=True``: its ``build_problem`` slab-kernel geometry
and path selection, ``embed_core``, ``embed_batch`` and ``_reconstruct``).
Each of ``num_iterations`` steps, for all B clips at once, in the padded
time-major (B, T, P) coefficient layout, on one of four paths that
``build_problem`` selects as the JAX package does
(``aware_tpu/embed/solver.py:451-511``) and records in ``Problem.path``:

    "iteration_step" (the default card: use_pallas_iteration, the fused
        detector's gate, push_extremes + NAdam without weight decay):
        the whole step is the iteration_step kernel (ops/kernels/iteration.py):
        synthesis -> double peak-norm -> reflect-pad analysis -> the fused
        detector -> push_extremes loss and gradient -> backward -> NAdam at
        the lr from before this step's scheduler tick -> clamp to the
        +/- tolerance_db box -> best snapshot; then the scheduler tick.
        Only the NAdam schedule's per-clip scalars and the tick are torch
        ops, with no host sync;
    "iteration_forward" (use_pallas_iteration otherwise; in the port, NAdam
        with weight decay): the iteration_forward kernel and its VJP
        through autograd, then the generic step below;
    "analysis_detector" (use_pallas_iteration=False, the fused detector's
        gate): synth_norm (kernel) coeffs -> slab synthesis -> OLA ->
        envelope -> + out-of-band waveform -> double peak-norm -> y2, then
        analysis_detector (kernels) y2 -> exact reflect-pad framing ->
        in-band Re/Im -> |.| -> the fused conv/norm detector -> bits;
    "band_analysis" (use_pallas_detector=False, or off the gate): synth_norm,
        then band_analysis (kernel) y2 -> zero-pad framing -> in-band Re/Im
        + edge_corrections (the reflect-pad rows the kernel leaves out) ->
        safe_magnitude -> banded detector (plain torch).

The generic step of the last three: push_extremes loss (per clip),
backward through the same chain (the kernels' VJPs), NAdam step at the lr
from before this step's scheduler tick, scheduler tick, clamp to the box,
best snapshot.

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
from aware_tpu_torch.embed.optim import nadam, nadam_schedule
from aware_tpu_torch.embed.schedulers import reduce_lr_on_plateau
from aware_tpu_torch.models.detector import DetectorNet
from aware_tpu_torch.ops.kernels.analysis_detector import (
    MIN_FRAMES,
    AnalysisDetConsts,
    analysis_detector,
)
from aware_tpu_torch.ops.kernels.detector import (
    CH,
    P_BAND,
    fused_detector_consts,
    fused_detector_supported,
)
from aware_tpu_torch.ops.kernels.iteration import (
    IterConsts,
    iteration_forward,
    iteration_step,
    nadam_coefs,
    step_buffers,
)
from aware_tpu_torch.ops.kernels.roundtrip import (
    R,
    band_analysis,
    edge_corrections,
    synth_norm,
)
from aware_tpu_torch.ops.mel import mel_filter_bank
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
    # the merged analysis + detector kernels' constants where they run
    # this problem, else None
    fused: AnalysisDetConsts | None = None
    # the whole-iteration kernels' constants where they run it, else None
    iteration: IterConsts | None = None
    # the solver path (module docstring): "iteration_step",
    # "iteration_forward", "analysis_detector" or "band_analysis"
    path: str = "band_analysis"

    @property
    def nb(self) -> int:
        return self.hi - self.lo


def build_problem(
    net: DetectorNet, audios: torch.Tensor, watermarks: torch.Tensor, cfg: AwareConfig
) -> Problem:
    """Preprocess B equal-length clips (B, L) and build the kernels'
    constants (peak-norm -> STFT -> magnitude/phase -> bases), and select
    the solver path.  With ``cfg.use_pallas_detector``, where the JAX
    package's gate holds (``aware_tpu/embed/solver.py:451-457``), also the
    merged analysis + detector kernels' constants from the keyed ``net``,
    and with ``cfg.use_pallas_iteration`` the whole-iteration kernels'
    (``aware_tpu/embed/solver.py:483-511``)."""
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

    csw, cswt = bf16(csw_np), bf16(csw_np.T)
    fused = None
    if (
        cfg.use_pallas_detector
        and p == P_BAND
        and t_frames >= MIN_FRAMES
        and fused_detector_supported(net_cfg, nb, t_frames, n_fft)
    ):
        params = {k: v for k, v in net.named_buffers() if k.startswith("conv")}
        fused = AnalysisDetConsts(
            csw=csw,
            cswt=cswt,
            det=fused_detector_consts(
                params,
                mel_filter_bank(net_cfg.sample_rate, n_fft, net_cfg.n_mels),
                lo, hi, dev,
            ),
        )

    ab, abt = bf16(ab_np), bf16(ab_np.T)
    csin = csin.to(torch.bfloat16)
    y_const = y_const.contiguous()
    iteration, path = None, "band_analysis" if fused is None else "analysis_detector"
    if fused is not None and cfg.use_pallas_iteration:
        iteration = IterConsts(csin=csin, y_const=y_const, env=env, ab=ab, abt=abt,
                               csw=csw, cswt=cswt, det=fused.det)
        step_whole = (
            cfg.loss == "push_extremes"
            and cfg.optimizer_name == "nadam"
            and not cfg.opt_params.get("weight_decay", 0.0)
        )
        path = "iteration_step" if step_whole else "iteration_forward"

    return Problem(
        ct0=to_carry(coeffs0),
        lower=to_carry(lower),
        upper=to_carry(upper),
        wm=watermarks.to(dev, torch.float32),
        csin=csin,
        y_const=y_const,
        env=env,
        ab=ab,
        abt=abt,
        csw=csw,
        cswt=cswt,
        csw_k=[
            torch.from_numpy(csw_np[k * hop : (k + 1) * hop].copy()).to(dev)
            for k in range(R)
        ],
        mag=mag,
        phase=phase,
        lo=lo,
        hi=hi,
        fused=fused,
        iteration=iteration,
        path=path,
    )


def objective(ct: torch.Tensor, pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """Per-clip loss (B,) of the coefficients ct (B, T, P)."""
    t_frames, p = ct.shape[1], ct.shape[2]
    if pb.iteration is not None:
        return push_extremes(iteration_forward(ct, pb.iteration), pb.wm)
    y2 = synth_norm(ct, pb.csin, pb.y_const, pb.env, pb.ab, pb.abt)
    if pb.fused is not None:
        return push_extremes(analysis_detector(y2, pb.fused), pb.wm)
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


def _solve_steps(pb: Problem, cfg: AwareConfig):
    """The "iteration_step" path's loop: one iteration_step call per
    iteration, updating ct, m, v, best and best_loss in place, then the
    scheduler tick on its loss.  NAdam's schedule comes from the same
    float32 mu-product recursion as ``embed.optim.nadam``, per clip where
    the lr is, on the device.  Returns (best, best_loss, final loss)."""
    params = cfg.opt_params
    b1, b2 = params.get("betas", (0.9, 0.999))
    psi = params.get("momentum_decay", 4e-3)
    coefs = nadam_coefs((b1, b2), params.get("eps", 1e-8))
    sched = reduce_lr_on_plateau(**cfg.sched_params)
    batch, t_frames, p = pb.ct0.shape
    dev = pb.ct0.device

    ct = pb.ct0.clone()
    m, v = torch.zeros_like(ct), torch.zeros_like(ct)
    best = ct.clone()
    best_loss = torch.full((batch,), float("inf"), device=dev)
    wm = torch.zeros(batch, CH[4], device=dev)
    wm[:, : pb.wm.shape[1]] = pb.wm
    step, mu_prod = torch.zeros((), device=dev), torch.ones((), device=dev)
    sched_state = sched.init(float(params.get("lr", 0.1)), batch, dev)
    bufs = None
    if dev.type == "cuda":
        bufs = step_buffers(batch, t_frames, 2 * p, cfg.hop_length, dev)
    loss = best_loss
    for _ in range(cfg.num_iterations):
        lr = sched_state["lr"]  # the lr from before this step's tick
        step, mu_t, mu_next, mu_prod = nadam_schedule(step, mu_prod, b1, psi)
        s1 = lr * (1.0 - mu_t) / (1.0 - mu_prod)
        s2 = lr * mu_next / (1.0 - mu_prod * mu_next)
        d2 = (1.0 - b2**step).reshape(1)
        loss = iteration_step(ct, m, v, best, best_loss, pb.lower, pb.upper, wm, s1, s2, d2,
                              pb.iteration, coefs, bufs)
        sched_state = sched.step(sched_state, loss)
    return best, best_loss, loss.clone()


def _solve_autograd(pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """The other paths' loop: the objective's gradient by autograd through
    the kernels' VJPs, then NAdam, the tick, the clamp and the best
    snapshot in torch (under the caller's no_grad).  Returns (best,
    best_loss, final loss)."""
    opt = nadam(**{k: v for k, v in cfg.opt_params.items() if k != "lr"})
    sched = reduce_lr_on_plateau(**cfg.sched_params)
    batch = pb.ct0.shape[0]
    dev = pb.ct0.device

    ct = pb.ct0
    opt_state = opt.init(ct)
    sched_state = sched.init(float(cfg.opt_params.get("lr", 0.1)), batch, dev)
    best_loss = torch.full((batch,), float("inf"), device=dev)
    best = ct
    loss = best_loss
    for _ in range(cfg.num_iterations):
        leaf = ct.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = objective(leaf, pb, net, cfg)
            (g,) = torch.autograd.grad(loss.sum(), leaf)
        loss = loss.detach()
        lr = sched_state["lr"]  # the lr from before this step's tick
        ct, opt_state = opt.update(g, opt_state, ct, lr)
        sched_state = sched.step(sched_state, loss)
        ct = torch.clamp(ct, pb.lower, pb.upper)
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        best = torch.where(better[:, None, None], ct, best)
    return best, best_loss, loss


def solve(pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """The solver loop on ``pb.path``: (best (B, T, P), best_loss (B,),
    final loss (B,))."""
    with torch.no_grad():
        if pb.path == "iteration_step":
            return _solve_steps(pb, cfg)
        return _solve_autograd(pb, net, cfg)


def embed_batch(
    net: DetectorNet,
    audios: torch.Tensor,
    watermarks: torch.Tensor,
    cfg: AwareConfig,
) -> EmbedResult:
    """Embed B bipolar patterns (B, n_bits) into B equal-length clips
    (B, L), all on ``audios.device``."""
    check_supported(cfg)
    pb = build_problem(net, audios, watermarks, cfg)
    best, best_loss, loss = solve(pb, net, cfg)
    with torch.no_grad():
        best_coeffs = best[..., : pb.nb].transpose(1, 2)
        audio = _reconstruct(pb, best_coeffs, cfg)
    return EmbedResult(audio, best_loss, loss, best_coeffs)
