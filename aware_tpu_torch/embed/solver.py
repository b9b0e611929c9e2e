"""The batched adversarial embed solver.

The port of ``aware_tpu/embed/solver.py`` (``build_problem`` with its
path selection, ``embed_core``, ``embed_batch``, ``embed_lbfgs`` and
``_reconstruct``).
Each of ``num_iterations`` steps, for all B clips at once, in the padded
time-major (B, T, P) coefficient layout, on one of the paths that
``build_problem`` selects as the JAX package's gate does
(``aware_tpu/embed/solver.py:318``, ``:352-357``, ``:383-397``,
``:451-511``) and records in ``Problem.path``:

    "fft" (use_matmul_dft=False): the band written into the magnitude ->
        polar -> ISTFT -> peak-norm twice -> STFT -> |.| -> zero the
        out-of-band bins -> the whole detector, plain float32 torch
        (cuFFT on the card);
    "ola" (use_pallas_ola): the frames round trip below with the
        ola_normalize kernel (ops/kernels/ola_norm.py) in place of
        OLA -> crop -> envelope -> double peak-norm;
    "frames" (use_slab_dft=False): frames = out-of-band frames + [Re; Im]
        in-band coefficients @ the windowed synthesis basis -> OLA ->
        crop -> envelope -> peak-norm twice -> reflect-pad framing ->
        @ the analysis basis -> safe_magnitude -> banded detector, plain
        float32 torch;
    "slab" (the slab decomposition without the kernels:
        use_pallas_roundtrip=False, or matmul_precision "highest", as the
        default card file pins): four shifted (T, 2nb) @ (2nb, hop)
        products and row adds -> envelope -> + out-of-band waveform ->
        the double peak-norm as one scale -> reflect-pad -> four shifted
        (T, hop) @ (hop, 2nb) analysis products -> safe_magnitude ->
        banded detector, plain float32 torch;

and, where the slab decomposition and the kernels' geometry both hold
(use_pallas_roundtrip, matmul_precision "high"), the kernel paths:

    "iteration_step" (the default: use_pallas_iteration, the fused
        detector's gate, push_extremes + NAdam without weight decay):
        the whole step is the iteration_step kernel (ops/kernels/iteration.py):
        synthesis -> double peak-norm -> reflect-pad analysis -> the fused
        detector -> push_extremes loss and gradient -> backward -> NAdam at
        the lr from before this step's scheduler tick -> clamp to the
        +/- tolerance_db box -> best snapshot; then the scheduler tick.
        Only the NAdam schedule's per-clip scalars and the tick are torch
        ops, with no host sync;
    "iteration_forward" (use_pallas_iteration otherwise: any other loss
        or optimizer, or NAdam with weight decay): the iteration_forward
        kernel and its VJP through autograd, then the generic step below;
    "analysis_detector" (use_pallas_iteration=False, the fused detector's
        gate): synth_norm (kernel) coeffs -> slab synthesis -> OLA ->
        envelope -> + out-of-band waveform -> double peak-norm -> y2, then
        analysis_detector (kernels) y2 -> exact reflect-pad framing ->
        in-band Re/Im -> |.| -> the fused conv/norm detector -> bits;
    "band_analysis" (use_pallas_detector=False, or off the gate): synth_norm,
        then band_analysis (kernel) y2 -> zero-pad framing -> in-band Re/Im
        + edge_corrections (the reflect-pad rows the kernel leaves out) ->
        safe_magnitude -> banded detector (plain torch);
    "tiled" (clips over 1024 frames, whatever the detector and iteration
        flags say: the JAX package's time-tiled kernels):
        synth_tiled_fwd (kernel) coeffs with the float32 phase -> u and m1
        -> the peak-norm in torch, then band_analysis_tiled (the shift_mm
        kernel) y2 -> zero-pad framing -> in-band Re/Im, then the
        "band_analysis" path's tail; the VJPs are shift_mm twice more
        (ops/kernels/roundtrip_tiled.py).

EOT views (``cfg.eot_*``, the robust, desync, compression and voice
cards; the port of ``aware_tpu/embed/solver.py:180-316``): each iteration
also scores the live waveform y2 of the round trip after an edit
(attacks/: vocoder time stretch "ts", pitch shift "ps", mp3_approx "mp3",
celp_approx "celp", differentiable; or the voice card's real codec "ste",
``opus_<k>k`` or ``gsm_fr``, run on the host lane by lane with a
straight-through gradient, ``StraightThroughHost``, its host seconds in
``HOST_VIEW_TIMES``), then peak-norm -> STFT -> |.| of the band -> the
float32 banded detector -> the card's loss, and adds eot_weight x that loss
to each clip's; "cycle" takes view it % n_views in iteration it, "all" the
mean over the views.  The views need y2, so that, as in the JAX package's
gate (``:483``), a problem with views never takes "iteration_step" or
"iteration_forward": by default it lands on "analysis_detector".  The
best snapshot then compares the totals of different views (the JAX
package's "known bias", kept).

The generic step of all but "iteration_step": the card's loss (per clip,
``embed/losses.py``), backward through the same chain (autograd, and the
kernels' VJPs; a loss with no gradient graph, "ber", gives a zero
gradient, as JAX's is), the card's optimizer step (``embed/optim.py``) at
the lr from before this step's scheduler tick, the card's scheduler tick
(``embed/schedulers.py``), clamp to the box, best snapshot.  The
schedulers tick on "iteration_step" too: only the loss and the optimizer
select the path.  L-BFGS (``optimizer_name == "lbfgs"``) is a host loop
over one clip, ``embed_lbfgs``, with one value and gradient an iteration
through the problem's path.  The plain paths' products (the
set-up's out-of-band frames, the float32 round trips, the plain-torch
detector and the views' detector) take the card's matmul_precision as
XLA's do in the JAX package: float32 for "high" and "highest" (TF32 is
off), one bf16 pass for "default", the turbo card's
(``models.detector.matmul``).  The kernels are bf16 on every precision;
"highest" alone keeps a problem off them ("slab").

Reference quirks kept: the best snapshot pairs iteration t's loss with the
post-step, post-clamp coefficients; the box comes from the initial
magnitudes with the lower bound clipped at 0; the output is rebuilt from
the original magnitude with the best coefficients written in, and is
(T-1)*hop samples long.  The padding columns of the (T, P) layout have
zero bounds and zero gradients, so they stay 0.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.attacks.celp import celp_approx
from aware_tpu_torch.attacks.codec import mp3_approx
from aware_tpu_torch.attacks.vocoder import pitch_shift, time_stretch
from aware_tpu_torch.attacks.voice_codecs import (
    gsm_available,
    gsm_roundtrip,
    opus_available,
    opus_roundtrip,
)
from aware_tpu_torch.config import MATMUL_PRECISIONS, AwareConfig, in_band_bins
from aware_tpu_torch.embed.lbfgs import HISTORY_SIZE, LBFGSMemory, lbfgs_update
from aware_tpu_torch.embed.losses import get_loss_fn
from aware_tpu_torch.embed.optim import get_optimizer, nadam_schedule
from aware_tpu_torch.embed.schedulers import get_scheduler
from aware_tpu_torch.models.detector import DetectorNet, matmul
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
from aware_tpu_torch.ops.kernels.ola_norm import ola_normalize
from aware_tpu_torch.ops.kernels.ola_norm import slabs as ola_slabs
from aware_tpu_torch.ops.kernels.roundtrip import (
    R,
    band_analysis,
    edge_corrections,
    synth_norm,
)
from aware_tpu_torch.ops.kernels.roundtrip_tiled import (
    band_analysis_tiled,
    build_tiled_bases,
    make_csinp,
    synth_norm_tiled,
)
from aware_tpu_torch.ops.mel import mel_filter_bank
from aware_tpu_torch.ops.stft import (
    _ola_envelope,
    device_window,
    irfft_basis,
    istft,
    istft_synthesis,
    magphase,
    peak_normalize,
    polar,
    rfft_basis,
    safe_magnitude,
    stft,
    stft_frames,
)
from aware_tpu_torch.ops.windows import get_window

# the whole-clip kernels' reach; longer clips take the time-tiled kernels
MAX_FRAMES = 1024


class EmbedResult(NamedTuple):
    audio: torch.Tensor       # (B, (T-1)*hop) watermarked waveforms
    best_loss: torch.Tensor   # (B,) best objective seen
    final_loss: torch.Tensor  # (B,) objective at the last iteration
    coeffs: torch.Tensor      # (B, n_band, T) best in-band magnitudes


def check_supported(cfg: AwareConfig) -> None:
    """Raise ValueError for a configuration that the JAX package cannot run
    either, NotImplementedError for one that would need a path not ported,
    and RuntimeError, naming the library, for a voice-card codec view
    (``eot_ste_codecs``) whose system library does not load here.  The JAX
    package fails there only at its first host callback, inside the solve;
    the port fails before any device work, its one difference on this card."""
    n_fft, hop = cfg.frame_length, cfg.hop_length
    if cfg.win_length != n_fft:
        raise ValueError(
            f"win_length {cfg.win_length} != frame_length {n_fft}: the window is not padded "
            "to the frame, and the JAX package's STFT raises there too (a (T, n_fft) by "
            "(win_length,) broadcast)")
    if cfg.use_pallas_ola and cfg.use_matmul_dft:
        try:
            ola_slabs(n_fft, hop)
        except ValueError as err:
            raise ValueError(f"use_pallas_ola at {n_fft}/{hop}: {err}") from None
    if cfg.matmul_precision not in MATMUL_PRECISIONS:
        raise NotImplementedError(
            f"not ported to aware_tpu_torch: matmul_precision {cfg.matmul_precision!r}")
    missing = []
    for name in cfg.eot_ste_codecs:
        lib, loads = _ste_library(name)
        if not loads():
            missing.append(f"{name} needs {lib}, which does not load here")
    if missing:
        raise RuntimeError(
            "the card's real-codec views (eot_ste_codecs) run the system codec libraries on "
            "the host each iteration: " + "; ".join(missing))


def eot_views(cfg: AwareConfig) -> tuple[tuple[str, object], ...]:
    """The EOT views as (kind, value) pairs, in the JAX package's order:
    stretch rates, pitch shifts in cents, mp3 qualities, celp modes, the
    real codecs ("ste")."""
    return (
        tuple(("ts", r) for r in cfg.eot_stretch_rates)
        + tuple(("ps", c) for c in cfg.eot_pitch_cents)
        + tuple(("mp3", q) for q in cfg.eot_mp3_qualities)
        + tuple(("celp", m) for m in cfg.eot_celp_modes)
        + tuple(("ste", s) for s in cfg.eot_ste_codecs)
    )


def _ste_library(name: str):
    """(the system library, its probe) of a real-codec view: ``gsm_fr``
    libgsm, ``opus_<k>k`` libopus; ValueError for another name."""
    if name == "gsm_fr":
        return "libgsm", gsm_available
    if name.startswith("opus_") and name.endswith("k") and name[5:-1].isdigit():
        return "libopus", opus_available
    raise ValueError(f"unknown eot_ste_codecs view {name!r}: opus_<k>k or gsm_fr")


def ste_codec(name: str, sr: int):
    """The host round trip of a real-codec view, (L,) float32 -> (L,):
    ``gsm_roundtrip`` for ``gsm_fr``, ``opus_roundtrip`` at k kb/s for
    ``opus_<k>k``, at the detector's rate ``sr``."""
    lib, _ = _ste_library(name)
    if lib == "libgsm":
        return functools.partial(gsm_roundtrip, sr=sr)
    return functools.partial(opus_roundtrip, sr=sr, bitrate_bps=int(name[5:-1]) * 1000)


@dataclasses.dataclass
class HostViewTimes:
    """Host seconds of the straight-through views since ``reset``: waiting
    for the device's queue before the copy out, the copies out and back,
    and the host function (the codec)."""

    calls: int = 0
    lanes: int = 0
    wait_s: float = 0.0
    copy_s: float = 0.0
    host_s: float = 0.0

    def reset(self) -> None:
        self.__init__()


HOST_VIEW_TIMES = HostViewTimes()


class StraightThroughHost(torch.autograd.Function):
    """A host function on each lane with a straight-through gradient: the
    forward copies y (B, L) to the host as float32, runs ``host`` on each
    lane in lane order and copies the result back to y's device and dtype;
    the backward returns the incoming gradient unchanged (the JAX
    package's ``custom_jvp`` around ``pure_callback``, ``vmap_method=
    "sequential"``: its tangent passes straight through)."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, host) -> torch.Tensor:
        times = HOST_VIEW_TIMES
        t0 = time.perf_counter()
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        t1 = time.perf_counter()
        lanes = y.detach().to("cpu", torch.float32).numpy()
        t2 = time.perf_counter()
        out = np.stack([np.asarray(host(lane), np.float32) for lane in lanes])
        t3 = time.perf_counter()
        res = torch.from_numpy(out).to(y.device, y.dtype)
        t4 = time.perf_counter()
        times.calls += 1
        times.lanes += len(lanes)
        times.wait_s += t1 - t0
        times.copy_s += (t2 - t1) + (t4 - t3)
        times.host_s += t3 - t2
        return res

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _view(y: torch.Tensor, kind: str, value, sr: int) -> torch.Tensor:
    """The edit of one view on waveforms (B, L): differentiable, or the
    real codec with a straight-through gradient ("ste")."""
    if kind == "ts":
        return time_stretch(y, value)
    if kind == "ps":  # cents -> semitones, as the eval suite's ps_5 attack
        return pitch_shift(y, value / 100.0)
    if kind == "mp3":
        return mp3_approx(y, sr, int(value))
    if kind == "ste":
        return StraightThroughHost.apply(y, ste_codec(str(value), sr))
    return celp_approx(y, sr, str(value))


def _view_loss(y: torch.Tensor, kind: str, value, pb: "Problem", net: DetectorNet,
               cfg: AwareConfig) -> torch.Tensor:
    """Per-clip loss (B,) of one view of the live waveforms y (B, L): the
    edit, peak-norm, STFT, |.| of the band, the float32 banded detector
    (``detector_apply_banded`` at the card's precision), the card's loss."""
    yr = _view(y, kind, value, cfg.detection_net.sample_rate)
    window = device_window(cfg.window, cfg.win_length, y.device)
    z = stft(peak_normalize(yr), cfg.frame_length, cfg.hop_length, window)[..., pb.lo : pb.hi, :]
    pred = net.forward_banded(safe_magnitude(z.real, z.imag), pb.lo, pb.hi, cfg.matmul_precision)
    return get_loss_fn(cfg.loss)(pred, pb.wm)


def eot_loss(y: torch.Tensor, pb: "Problem", net: DetectorNet, cfg: AwareConfig,
             it: int) -> torch.Tensor:
    """The views' loss (B,) of iteration ``it``: "cycle" view it % n_views
    (the same view for every clip), "all" the mean over the views."""
    views = eot_views(cfg)
    if cfg.eot_mode == "cycle":
        kind, value = views[it % len(views)]
        return _view_loss(y, kind, value, pb, net, cfg)
    return sum(_view_loss(y, k, v, pb, net, cfg) for k, v in views) / len(views)


class TiledConsts(NamedTuple):
    """The long-clip kernels' constants (ops/kernels/roundtrip_tiled.py)."""

    csinp: torch.Tensor  # (B, T+3, 2P) float32 [cos | sin], row m+1 = frame m
    w_sf: torch.Tensor   # (4, 2P, hop) bf16 slab weights of the synthesis
    w_sb: torch.Tensor   # (4, hop, 2P) of its VJP
    w_af: torch.Tensor   # (4, hop, 2P) of the analysis
    w_ab: torch.Tensor   # (4, 2P, hop) of its VJP


class PlainConsts(NamedTuple):
    """The float32 round trips' constants ("slab", "frames", "ola", "fft"),
    over the nb in-band bins without padding."""

    cos: torch.Tensor     # (B, T, nb) cos of the in-band phase; on "fft" (B, F, T), all bins
    sin: torch.Tensor
    window: torch.Tensor  # (n_fft,) float32
    ab: torch.Tensor | None  # (2nb, n_fft) windowed synthesis basis, Re rows then Im
    cs: torch.Tensor | None  # (n_fft, 2nb) analysis basis [C | S], windowed on "slab"
    frames_const: torch.Tensor | None  # (B, T, n_fft) out-of-band windowed frames
    #                                    ("frames", "ola")


@dataclasses.dataclass
class Problem:
    """A batch's embed problem in the padded (B, T, P) layout, with the
    constants of its path and no others."""

    ct0: torch.Tensor       # (B, T, P) initial coefficients
    lower: torch.Tensor     # (B, T, P) box
    upper: torch.Tensor
    wm: torch.Tensor        # (B, n_bits) bipolar targets
    env: torch.Tensor       # (T-1, hop) OLA envelope
    mag: torch.Tensor       # (B, F, T) original magnitude
    phase: torch.Tensor     # (B, F, T)
    lo: int
    hi: int
    # the solver path (module docstring): "fft", "ola", "frames", "slab",
    # "iteration_step", "iteration_forward", "analysis_detector",
    # "band_analysis" or "tiled"
    path: str
    y_const: torch.Tensor | None = None  # (B, T-1, hop) envelope-divided
    #                                      out-of-band waveform (slab paths)
    # the kernel paths' constants: bf16 [cos | sin] of the in-band phase
    # (B, T, 2P) (None on "tiled", which has tiled.csinp), the bf16
    # synthesis basis (2P, n_fft) with the window folded in, the bf16
    # windowed analysis basis (n_fft, 2P), their transposes, and the R
    # float32 (hop, 2P) slabs of the analysis basis (edge corrections)
    csin: torch.Tensor | None = None
    ab: torch.Tensor | None = None
    abt: torch.Tensor | None = None
    csw: torch.Tensor | None = None
    cswt: torch.Tensor | None = None
    csw_k: list | None = None
    # the merged analysis + detector kernels' constants where they run
    # this problem, else None
    fused: AnalysisDetConsts | None = None
    # the whole-iteration kernels' constants where they run it, else None
    iteration: IterConsts | None = None
    # the long-clip kernels' constants on the "tiled" path, else None
    tiled: TiledConsts | None = None
    # the float32 round trips' constants on "slab", "frames", "ola", "fft"
    plain: PlainConsts | None = None

    @property
    def nb(self) -> int:
        return self.hi - self.lo


def build_problem(
    net: DetectorNet, audios: torch.Tensor, watermarks: torch.Tensor, cfg: AwareConfig
) -> Problem:
    """Preprocess B equal-length clips (B, L) (peak-norm -> STFT ->
    magnitude/phase -> box), select the solver path as the JAX package's
    gate does, and build that path's constants alone:

    * not ``use_matmul_dft``: "fft" (``aware_tpu/embed/solver.py:638-652``);
    * else the out-of-band windowed frames; without the slab decomposition
      (``use_pallas_ola``, not ``use_slab_dft``, or a hop that divides
      neither n_fft nor n_fft / 2, ``:352-357``) "ola" or "frames"
      (``:578-600``);
    * else the out-of-band waveform; without the kernels' geometry
      (``use_pallas_roundtrip=False``, ``matmul_precision == "highest"``,
      n_fft != 4 hop or hop % 128, ``:383-390``) "slab" over its r =
      n_fft / hop slabs (``:540-576``);
    * else past ``MAX_FRAMES`` frames the time-tiled kernels' constants
      (``:434-443``), and up to it the whole-clip kernels': with
      ``cfg.use_pallas_detector``, where the JAX package's gate holds
      (``:451-457``), also the merged analysis + detector kernels'
      constants from the keyed ``net``, and with ``cfg.use_pallas_iteration``
      and no EOT view the whole-iteration kernels' (``:483-511``).

    The kernel paths are those of n_fft == 4 hop with hop % 128 == 0 (the
    default card's 1024 / 256, and 2048 / 512 with its 512 padded band
    columns), as the JAX gate's."""
    n_fft, hop = cfg.frame_length, cfg.hop_length
    dev = audios.device
    window = get_window(cfg.window, cfg.win_length)
    net_cfg = cfg.detection_net
    lo, hi = in_band_bins(net_cfg.sample_rate, n_fft, cfg.embedding_bands)
    nb = hi - lo

    x = peak_normalize(audios)
    mag, phase = magphase(stft(x, n_fft, hop, window))  # (B, F, T)
    t_frames = mag.shape[-1]
    coeffs0 = mag[:, lo:hi]
    delta = coeffs0 * (10.0 ** (-cfg.tolerance_db / 20.0))
    lower = torch.clamp(coeffs0 - delta, min=0.0)
    upper = coeffs0 + delta
    cos_ph, sin_ph = torch.cos(phase), torch.sin(phase)
    env = torch.as_tensor(
        _ola_envelope(tuple(window.tolist()), n_fft, hop, t_frames),
        dtype=torch.float32,
        device=dev,
    ).reshape(t_frames - 1, hop)
    wvec = window.astype(np.float32)
    window_t = torch.from_numpy(wvec).to(dev)
    # band padded to a multiple of 128 columns: the kernels' layout, and
    # the solver's carry on every path
    p = -(-nb // 128) * 128

    def to_carry(c: torch.Tensor) -> torch.Tensor:
        out = c.new_zeros(c.shape[0], t_frames, p)
        out[..., :nb] = c.transpose(1, 2)
        return out

    problem = functools.partial(
        Problem,
        ct0=to_carry(coeffs0),
        lower=to_carry(lower),
        upper=to_carry(upper),
        wm=watermarks.to(dev, torch.float32),
        env=env,
        mag=mag,
        phase=phase,
        lo=lo,
        hi=hi,
    )
    if not cfg.use_matmul_dft:
        return problem(path="fft", plain=PlainConsts(cos_ph, sin_ph, window_t, None, None, None))

    a_np, b_np = irfft_basis(n_fft)
    c_np, s_np = rfft_basis(n_fft)
    aw = torch.from_numpy(a_np * wvec[None, :]).to(dev)
    bw = torch.from_numpy(b_np * wvec[None, :]).to(dev)
    re_full, im_full = mag * cos_ph, mag * sin_ph
    prec = cfg.matmul_precision
    # the constant (out-of-band) part of the windowed ISTFT frames
    frames_const = (
        matmul(re_full[:, :lo].transpose(1, 2), aw[:lo], prec)
        + matmul(re_full[:, hi:].transpose(1, 2), aw[hi:], prec)
        + matmul(im_full[:, :lo].transpose(1, 2), bw[:lo], prec)
        + matmul(im_full[:, hi:].transpose(1, 2), bw[hi:], prec)
    )
    cos_in = cos_ph[:, lo:hi].transpose(1, 2).contiguous()  # (B, T, nb)
    sin_in = sin_ph[:, lo:hi].transpose(1, 2).contiguous()
    ab_in = torch.cat([aw[lo:hi], bw[lo:hi]], dim=0)  # (2nb, n_fft)
    cs_np = np.concatenate([c_np[:, lo:hi], s_np[:, lo:hi]], axis=1)  # (n_fft, 2nb)

    slab_ok = n_fft % hop == 0 and (n_fft // 2) % hop == 0
    if cfg.use_pallas_ola or not cfg.use_slab_dft or not slab_ok:
        return problem(
            path="ola" if cfg.use_pallas_ola else "frames",
            plain=PlainConsts(cos_in, sin_in, window_t, ab_in,
                              torch.from_numpy(cs_np).to(dev), frames_const),
        )

    y_const = istft_synthesis(frames_const, n_fft, hop, window).reshape(
        -1, t_frames - 1, hop
    ).contiguous()
    kernel_geometry = n_fft == R * hop and hop % 128 == 0
    if not cfg.use_pallas_roundtrip or cfg.matmul_precision == "highest" or not kernel_geometry:
        # the kernels are single-pass bf16: "highest" keeps the float32 slabs
        return problem(
            path="slab",
            y_const=y_const,
            plain=PlainConsts(cos_in, sin_in, window_t, ab_in,
                              torch.from_numpy(cs_np * wvec[:, None]).to(dev), None),
        )

    # Re block at [0, P), Im block at [P, 2P) in both bases and in the
    # analysis output
    ab_np = np.zeros((2 * p, n_fft), np.float32)
    ab_np[:nb] = (a_np * wvec[None, :])[lo:hi]
    ab_np[p : p + nb] = (b_np * wvec[None, :])[lo:hi]
    csw_np = np.zeros((n_fft, 2 * p), np.float32)
    csw_np[:, :nb] = c_np[:, lo:hi] * wvec[:, None]
    csw_np[:, p : p + nb] = s_np[:, lo:hi] * wvec[:, None]
    csw_k = [torch.from_numpy(csw_np[k * hop : (k + 1) * hop].copy()).to(dev) for k in range(R)]
    if t_frames > MAX_FRAMES:
        return problem(
            path="tiled",
            y_const=y_const,
            csw_k=csw_k,
            tiled=TiledConsts(
                csinp=make_csinp(cos_ph[:, lo:hi], sin_ph[:, lo:hi], p),
                **build_tiled_bases(ab_np, csw_np, dev),
            ),
        )

    def bf16(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.bfloat16)

    csw, cswt = bf16(csw_np), bf16(csw_np.T)
    ab, abt = bf16(ab_np), bf16(ab_np.T)
    csin = torch.zeros(mag.shape[0], t_frames, 2 * p, device=dev)
    csin[..., :nb] = cos_in
    csin[..., p : p + nb] = sin_in
    csin = csin.to(torch.bfloat16)
    fused = iteration = None
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

    path = "band_analysis" if fused is None else "analysis_detector"
    if fused is not None and cfg.use_pallas_iteration and not eot_views(cfg):
        iteration = IterConsts(csin=csin, y_const=y_const, env=env, ab=ab, abt=abt,
                               csw=csw, cswt=cswt, det=fused.det)
        step_whole = (
            cfg.loss == "push_extremes"
            and cfg.optimizer_name == "nadam"
            and not cfg.opt_params.get("weight_decay", 0.0)
        )
        path = "iteration_step" if step_whole else "iteration_forward"

    return problem(
        path=path,
        y_const=y_const,
        csin=csin,
        ab=ab,
        abt=abt,
        csw=csw,
        cswt=cswt,
        csw_k=csw_k,
        fused=fused,
        iteration=iteration,
    )


def _plain_pred(ct: torch.Tensor, pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """The float32 round trip and detector of the "slab", "frames", "ola"
    and "fft" paths: bits (B, n_bits) of the coefficients ct (B, T, P),
    and the live waveforms (B, L) that the detector's STFT reads."""
    n_fft, hop = cfg.frame_length, cfg.hop_length
    prec = cfg.matmul_precision
    c = pb.plain
    batch, t_frames = ct.shape[0], ct.shape[1]
    coeffs = ct[..., : pb.nb]  # (B, T, nb)
    if pb.path == "fft":
        m = torch.cat([pb.mag[:, : pb.lo], coeffs.transpose(1, 2), pb.mag[:, pb.hi :]], dim=1)
        z = torch.complex(m * c.cos, m * c.sin)
        y = peak_normalize(peak_normalize(istft(z, n_fft, hop, c.window, env=pb.env.reshape(-1))))
        band = stft(y, n_fft, hop, c.window)[:, pb.lo : pb.hi]
        m2 = safe_magnitude(band.real, band.imag)
        # the whole detector on the band-zeroed magnitude, as the JAX path
        return net(F.pad(m2, (0, 0, pb.lo, m.shape[1] - pb.hi)), prec), y
    reim = torch.cat([coeffs * c.cos, coeffs * c.sin], dim=-1)  # (B, T, 2nb)
    if pb.path == "slab":
        # OLA as r shifted row adds of hop-wide slabs; the out-of-band
        # part enters after the envelope as a waveform
        r, pad = n_fft // hop, n_fft // 2 // hop
        yd = sum(
            F.pad(matmul(reim, c.ab[:, k * hop : (k + 1) * hop], prec), (0, 0, k, r - 1 - k))
            for k in range(r)
        )
        u = yd[:, pad : pad + t_frames - 1] / pb.env + pb.y_const
        # the double peak-norm as one scale: the second max is
        # m1 / (m1 + e) exactly
        m1 = u.abs().amax(dim=(1, 2), keepdim=True)
        y2 = (u / ((m1 + 1e-8) * (m1 / (m1 + 1e-8) + 1e-8))).reshape(batch, -1)
        half = n_fft // 2
        yp = torch.cat(
            [y2[:, 1 : half + 1].flip(-1), y2, y2[:, -half - 1 : -1].flip(-1)], dim=-1
        ).reshape(batch, t_frames + r - 1, hop)
        cs2 = sum(matmul(yp[:, k : k + t_frames], c.cs[k * hop : (k + 1) * hop], prec)
                  for k in range(r))
    else:
        frames = c.frames_const + matmul(reim, c.ab, prec)  # (B, T, n_fft)
        if pb.path == "ola":
            y2 = ola_normalize(frames, pb.env).reshape(batch, -1)
        else:
            y2 = peak_normalize(peak_normalize(
                istft_synthesis(frames, n_fft, hop, None, env=pb.env.reshape(-1))))
        cs2 = matmul(stft_frames(y2, n_fft, hop, c.window), c.cs, prec)
    m2 = safe_magnitude(cs2[..., : pb.nb], cs2[..., pb.nb :])
    return net.forward_banded(m2.transpose(1, 2), pb.lo, pb.hi, prec), y2


def _kernel_pred(ct: torch.Tensor, pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """The kernel paths' bits (B, n_bits) of the coefficients ct (B, T, P),
    and the live waveforms y2 (B, (T-1)*hop) (None on the whole-iteration
    kernels, which keep y2 to themselves)."""
    t_frames, p = ct.shape[1], ct.shape[2]
    if pb.iteration is not None:
        return iteration_forward(ct, pb.iteration), None
    if pb.tiled is not None:
        tc = pb.tiled
        y2 = synth_norm_tiled(ct, tc.csinp, pb.y_const, pb.env, tc.w_sf, tc.w_sb)
        cs2 = band_analysis_tiled(y2, tc.w_af, tc.w_ab)
    else:
        y2 = synth_norm(ct, pb.csin, pb.y_const, pb.env, pb.ab, pb.abt)
        if pb.fused is not None:
            return analysis_detector(y2, pb.fused), y2.reshape(y2.shape[0], -1)
        cs2 = band_analysis(y2, pb.csw, pb.cswt)
    y2 = y2.reshape(y2.shape[0], -1)
    cs2 = cs2 + edge_corrections(y2, pb.csw_k, cfg.frame_length, cfg.hop_length, t_frames)
    m2 = safe_magnitude(cs2[..., : pb.nb], cs2[..., p : p + pb.nb])
    return net.forward_banded(m2.transpose(1, 2), pb.lo, pb.hi, cfg.matmul_precision), y2


def objective(ct: torch.Tensor, pb: Problem, net: DetectorNet, cfg: AwareConfig, it: int = 0):
    """Per-clip loss (B,) of the coefficients ct (B, T, P) in iteration
    ``it``: the card's loss of the detector's bits, plus eot_weight x the
    EOT views' loss of the live waveforms where the config has views."""
    pred, y2 = (_plain_pred if pb.plain is not None else _kernel_pred)(ct, pb, net, cfg)
    loss = get_loss_fn(cfg.loss)(pred, pb.wm)
    if eot_views(cfg):
        loss = loss + cfg.eot_weight * eot_loss(y2, pb, net, cfg, it)
    return loss


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
    card's scheduler tick on its loss.  NAdam's schedule comes from the
    same float32 mu-product recursion as ``embed.optim.nadam``, per clip
    where the lr is, on the device.  Returns (best, best_loss, final loss)."""
    params = cfg.opt_params
    b1, b2 = params.get("betas", (0.9, 0.999))
    psi = params.get("momentum_decay", 4e-3)
    coefs = nadam_coefs((b1, b2), params.get("eps", 1e-8))
    sched = get_scheduler(cfg.scheduler_name, **cfg.sched_params)
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


def value_and_grad(ct: torch.Tensor, pb: Problem, net: DetectorNet, cfg: AwareConfig,
                   it: int = 0):
    """The objective (B,) of ct (B, T, P) in iteration ``it`` and its
    gradient, by autograd through the kernels' VJPs.  A loss with no
    gradient graph ("ber") has a zero gradient, as in JAX."""
    leaf = ct.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = objective(leaf, pb, net, cfg, it)
        if loss.requires_grad:
            (g,) = torch.autograd.grad(loss.sum(), leaf)
        else:
            g = torch.zeros_like(leaf)
    return loss.detach(), g


def _solve_autograd(pb: Problem, net: DetectorNet, cfg: AwareConfig):
    """The other paths' loop: the objective's gradient by autograd through
    the kernels' VJPs, then the card's optimizer, scheduler tick, clamp and
    best snapshot in torch (under the caller's no_grad).  Returns (best,
    best_loss, final loss)."""
    opt = get_optimizer(cfg.optimizer_name, **cfg.opt_params)
    sched = get_scheduler(cfg.scheduler_name, **cfg.sched_params)
    batch = pb.ct0.shape[0]
    dev = pb.ct0.device

    ct = pb.ct0
    opt_state = opt.init(ct)
    sched_state = sched.init(float(cfg.opt_params.get("lr", 0.1)), batch, dev)
    best_loss = torch.full((batch,), float("inf"), device=dev)
    best = ct
    loss = best_loss
    for it in range(cfg.num_iterations):
        loss, g = value_and_grad(ct, pb, net, cfg, it)
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


def warm_start(pb: Problem, init_coeffs: torch.Tensor | None) -> None:
    """Start the solve at ``init_coeffs`` (B, n_band, T) instead of the
    unperturbed magnitudes: mapped into the carry layout first, then
    clipped into the box, as ``aware_tpu/embed/solver.py:797-802``; the
    solvers' best snapshot (and on "iteration_step" the kernel's state)
    start there."""
    if init_coeffs is None:
        return
    warm = torch.zeros_like(pb.ct0)
    warm[..., : pb.nb] = init_coeffs.to(pb.ct0).transpose(1, 2)
    pb.ct0 = torch.minimum(torch.maximum(warm, pb.lower), pb.upper)


def embed_batch(
    net: DetectorNet,
    audios: torch.Tensor,
    watermarks: torch.Tensor,
    cfg: AwareConfig,
    init_coeffs: torch.Tensor | None = None,
) -> EmbedResult:
    """Embed B bipolar patterns (B, n_bits) into B equal-length clips
    (B, L), all on ``audios.device``; ``init_coeffs`` (B, n_band, T)
    warm-starts the solve (``warm_start``)."""
    if cfg.optimizer_name == "lbfgs":
        raise ValueError(
            "lbfgs is a host-loop optimizer over one clip and cannot run in the batched "
            "solver; call embed_lbfgs (the service's single-clip embed dispatches there)."
        )
    check_supported(cfg)
    pb = build_problem(net, audios, watermarks, cfg)
    warm_start(pb, init_coeffs)
    best, best_loss, loss = solve(pb, net, cfg)
    with torch.no_grad():
        best_coeffs = best[..., : pb.nb].transpose(1, 2)
        audio = _reconstruct(pb, best_coeffs, cfg)
    return EmbedResult(audio, best_loss, loss, best_coeffs)


def embed_lbfgs(
    net: DetectorNet,
    audio: torch.Tensor,
    watermark: torch.Tensor,
    cfg: AwareConfig,
    init_coeffs: torch.Tensor | None = None,
) -> EmbedResult:
    """L-BFGS embed of one clip (L,) with a bipolar pattern (n_bits,), on
    ``audio.device``: the port of ``aware_tpu/embed/solver.py:825-883``;
    ``init_coeffs`` (n_band, T) warm-starts it, clipped into the box.

    One quasi-Newton iteration (``embed/lbfgs.py``) per solver iteration,
    on the flat (T, P) carry, with one value and gradient of the objective
    through the problem's path (on the default card rows 9-10, the
    iteration_forward kernels); then the scheduler tick on the loss, the
    clamp to the box and the best snapshot.  The lr defaults to torch's
    LBFGS default, 1.0, where the card's params give none; history_size
    comes from them.  The padding columns of the carry have zero
    gradients, so they stay 0.  Returns the unbatched result: audio
    ((T-1)*hop,), scalar losses, coeffs (n_band, T)."""
    check_supported(cfg)
    pb = build_problem(net, audio[None], watermark[None], cfg)
    warm_start(pb, None if init_coeffs is None else init_coeffs[None])
    params = cfg.opt_params
    mem = LBFGSMemory(history_size=int(params.get("history_size", HISTORY_SIZE)))
    sched = get_scheduler(cfg.scheduler_name, **cfg.sched_params)
    sched_state = sched.init(float(params.get("lr", 1.0)), 1, audio.device)
    shape = pb.ct0.shape
    x = pb.ct0.reshape(-1)
    lower, upper = pb.lower.reshape(-1), pb.upper.reshape(-1)
    best, best_loss, last_loss = x, float("inf"), float("inf")
    with torch.no_grad():
        for it in range(cfg.num_iterations):
            loss, g = value_and_grad(x.reshape(shape), pb, net, cfg, it)
            lr = float(sched_state["lr"][0])  # the lr from before this step's tick
            x = lbfgs_update(mem, x, g, lr)
            sched_state = sched.step(sched_state, loss)
            x = torch.clamp(x, lower, upper)
            # the best snapshot pairs loss t with the post-step, post-clamp x
            last_loss = float(loss[0])
            if last_loss < best_loss:
                best_loss, best = last_loss, x
        best_coeffs = best.reshape(shape)[..., : pb.nb].transpose(1, 2)
        out = _reconstruct(pb, best_coeffs, cfg)
    return EmbedResult(out[0], torch.tensor(best_loss), torch.tensor(last_loss), best_coeffs[0])
