"""The whole-iteration kernels: iteration_forward (forward and VJP) and
iteration_step.

The port of ``aware_tpu/ops/pallas/iteration.py``: the embed solver's
whole differentiable iteration for a batch of B clips, in the padded
time-major coefficient layout,

    ct (B, T, P) -> synthesis u (B, T-1, hop), m1 = max |u|, y2 = u / cden
       -> reflect-pad slab analysis -> the fused detector -> pred (B, 128)

(``synth_norm`` then ``analysis_detector`` in one chain), its VJP back to
the coefficients, and the solver's whole step on top of them: the
push_extremes loss and gradient, the backward, torch's NAdam update, the
clamp to the box and the best snapshot.  Three CUDA entries, each a fixed
chain of launches on the current stream (their launches are listed in
the sources):

* ``iteration_forward_fwd`` replaces ``_iter_fwd_kernel``
  (aware_tpu/ops/pallas/iteration.py:72, pallas_call :173): ct (B, T, P)
  f32 -> pred (B, 128) f32 and ``IterResiduals`` (the detector's 16, u and
  m1); the forward half of the step chain (``aw_iteration_fwd_sm90``, 20
  launches), its 7 GEMMs' tiles planned here (``fwd_tiles``, the step's
  own tiles for them);
* ``iteration_forward_bwd`` replaces ``_iter_bwd_kernel`` (:193,
  pallas_call :285): g (B, 128) -> dct (B, T, P) f32; the backward half of
  the step chain from g, then the phase fold (19 launches), its 7 GEMMs'
  tiles planned here (``bwd_tiles``);
* ``iteration_step`` replaces ``_step_kernel`` (:341, pallas_call :513):
  ct, m, v, best (B, T, P) and best_loss (B,) updated in place, loss (B,)
  out; the step chain of ``csrc/iteration_sm90.cu`` (40 launches: its
  forward half, its backward half, the NAdam epilogue), its 14 GEMMs'
  tiles planned here (``step_tiles``).

The first WMMA chains of the three stay in the library as
``aw_iteration_fwd_wmma`` (``csrc/iteration.cu``, 13 launches),
``aw_iteration_bwd_wmma`` and ``aw_iteration_step_wmma``, which no path
reaches (``chip_smoke.py`` times each beside its sm90 chain in turns).

Each wrapper checks its operands, counts its own launches in
``launches``, and on CUDA tensors launches its kernel or raises; on CPU
tensors it runs its plain version (``*_plain``), built from the plain
versions of ``roundtrip.py`` and ``analysis_detector.py``, which the CPU
tests hold against the JAX kernels and the chip check holds the kernels
against.

The backward's residual is u, the synthesis before the peak-norm, never
y2: every consumer forms y2 = u / cden (cden = m1 (1 + 1e-8) + 1e-16)
itself, the same float as the forward's.  ``_IterationForward`` is the
``torch.autograd.Function`` over the two directions (``iteration_forward``
returns (B, 20)); the solver's step path calls ``iteration_step`` with
buffers allocated once per solve (``step_buffers``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from aware_tpu_torch.embed.losses import mse
from aware_tpu_torch.ops.kernels.analysis_detector import (
    MIN_FRAMES,
    AnalysisDetConsts,
    analysis_detector_bwd_plain,
    analysis_detector_fwd_plain,
    reflect_gemm_bwd,
    reflect_gemm_fwd,
)
from aware_tpu_torch.ops.kernels.detector import (
    CH,
    N_BITS,
    P_BAND,
    DetConsts,
    DetResiduals,
    _check_consts,
    _residual_shapes,
    det_bwd_weights,
    det_gemms_bwd,
    det_gemms_fwd,
)
from aware_tpu_torch.ops.kernels.roundtrip import (
    FOLD_CHUNK,
    PAD,
    PART_LD,
    R,
    _check,
    _check_fold,
    _check_geometry,
    _run,
    _sms,
    check_dense_gemm,
    check_slab_gemm,
    check_weights_aligned,
    peak_den,
    phase_fold_plain,
    plan_gemms,
    synth_gemm,
    synth_norm_bwd_plain,
    synth_u_plain,
    synth_vjp_gemm,
    tile_array,
)

_BF16 = torch.bfloat16
_F32 = torch.float32


class IterConsts(NamedTuple):
    """The constants of every iteration, batched over B where per clip
    (the solver's ``Problem`` holds them).  The JAX kernels' reflect-pad
    flip matrices are built by the plain versions where they need them."""

    csin: torch.Tensor     # (B, T, 2P) bf16 [cos | sin] of the in-band phase
    y_const: torch.Tensor  # (B, T-1, hop) f32 envelope-divided out-of-band wave
    env: torch.Tensor      # (T-1, hop) f32 OLA envelope
    ab: torch.Tensor       # (2P, n_fft) bf16 synthesis basis, window folded
    abt: torch.Tensor      # (n_fft, 2P) bf16
    csw: torch.Tensor      # (n_fft, 2P) bf16 windowed analysis basis
    cswt: torch.Tensor     # (2P, n_fft) bf16
    det: DetConsts

    @property
    def analysis(self) -> AnalysisDetConsts:
        return AnalysisDetConsts(csw=self.csw, cswt=self.cswt, det=self.det)


class IterResiduals(NamedTuple):
    """What the forward keeps for the VJP."""

    det: DetResiduals  # the detector's 16 (pred first)
    u: torch.Tensor    # (B, T-1, hop) f32 synthesis before the peak-norm
    m1: torch.Tensor   # (B,) f32 max |u|

    @property
    def y2(self) -> torch.Tensor:
        """The peak-normalized signal rows, u / cden."""
        return self.u / peak_den(self.m1)


class NadamCoefs(NamedTuple):
    """torch.optim.NAdam's constants of the step's epilogue."""

    c_m: float  # 1 - b1
    b2: float
    c_v: float  # 1 - b2
    eps: float


def nadam_coefs(betas=(0.9, 0.999), eps: float = 1e-8) -> NadamCoefs:
    b1, b2 = betas
    return NadamCoefs(1.0 - b1, b2, 1.0 - b2, eps)


class Scratch(NamedTuple):
    """The chains' scratch (csrc/iteration.cu ``IterScratch``), all f32."""

    big: torch.Tensor    # (B, T, 2P): cs2, then dcs, then dreim
    mel32: torch.Tensor  # (B, T, 128)
    ha: torch.Tensor     # (B, T2, 1024)
    hb: torch.Tensor     # (B, T2, 1024)
    mu: torch.Tensor     # (B, 1024)
    m2: torch.Tensor     # (B, 1024)
    small: torch.Tensor  # (B, 128)
    clip2: torch.Tensor  # (B, 2)
    gy2: torch.Tensor    # (B, T-1, hop)
    gpad: torch.Tensor   # (B, 4, hop)
    scal: torch.Tensor   # (B, 4)


class StepOps(NamedTuple):
    """The sm90 step's own buffers (csrc/iteration_sm90.cu ``StepOps``)."""

    a16: torch.Tensor   # (B, max(T2 1024, T P)) bf16: the detector GEMMs' A operands
    rows: torch.Tensor  # (B, T+3, hop) f32: the reflect-padded y2, then gcrop
    part: torch.Tensor  # (B, 4096) f32: the chunked reductions' partial sums


class StepBuffers(NamedTuple):
    """What ``iteration_step`` writes besides the state: the forward's
    residuals, the scratch, the loss and its own operands; allocated once
    per solve."""

    res: IterResiduals
    scratch: Scratch
    loss: torch.Tensor  # (B,) f32, the last step's loss
    ops: StepOps


def _scratch_shapes(b: int, t: int, p2: int, hop: int) -> tuple:
    t2 = t // 2
    return ((b, t, p2), (b, t, CH[0]), (b, t2, CH[2]), (b, t2, CH[2]), (b, CH[2]), (b, CH[2]),
            (b, CH[4]), (b, 2), (b, t - 1, hop), (b, 2 * PAD, hop), (b, 4))


def _scratch(b: int, t: int, p2: int, hop: int, dev) -> Scratch:
    return Scratch(*(torch.empty(s, dtype=_F32, device=dev)
                     for s in _scratch_shapes(b, t, p2, hop)))


def _residuals(b: int, t: int, p2: int, hop: int, dev) -> IterResiduals:
    det = DetResiduals(**{
        k: torch.empty(shape, dtype=dtype, device=dev)
        for k, (shape, dtype) in _residual_shapes(b, t, p2).items()
    })
    return IterResiduals(det, torch.empty(b, t - 1, hop, device=dev), torch.empty(b, device=dev))


def _ops_shapes(b: int, t: int, p2: int, hop: int) -> tuple:
    return ((b, max((t // 2) * CH[2], t * (p2 // 2))), (b, t + 2 * PAD - 1, hop), (b, PART_LD))


def step_buffers(b: int, t: int, p2: int, hop: int, device) -> StepBuffers:
    """The buffers of ``iteration_step`` for B clips of T frames (CUDA;
    the plain version needs none)."""
    return StepBuffers(_residuals(b, t, p2, hop, device), _scratch(b, t, p2, hop, device),
                       torch.empty(b, device=device), step_ops(b, t, p2, hop, device))


def step_gemms_fwd(b: int, t: int, p: int, hop: int) -> list:
    """The forward half's GEMMs (the iteration_forward forward's) in the
    order of csrc/detector_sm90.cuh's ``FwdGemm``: the round trip's two,
    then the detector's five."""
    return [synth_gemm(t, p, hop), reflect_gemm_fwd(t, 2 * p, hop), *det_gemms_fwd(b, t, p)]


def step_gemms_bwd(b: int, t: int, p: int, hop: int) -> list:
    """The backward half's GEMMs (the iteration_forward VJP's) in the order
    of csrc/detector_sm90.cuh's ``BwdGemm``: the detector's five (the
    detector_fused VJP's), then the round trip's two."""
    return [*det_gemms_bwd(b, t, p), reflect_gemm_bwd(t, 2 * p, hop), synth_vjp_gemm(t, p, hop)]


def step_gemms(b: int, t: int, p: int, hop: int) -> list:
    """The step's 14 GEMMs in launch order: the two halves'."""
    return step_gemms_fwd(b, t, p, hop) + step_gemms_bwd(b, t, p, hop)


def plan_step(b: int, t: int, p: int, hop: int, sms: int) -> list:
    """The planned tile of each of the step's GEMMs (``step_gemms``)."""
    return plan_gemms(step_gemms(b, t, p, hop), b, sms)


def plan_fwd(b: int, t: int, p: int, hop: int, sms: int) -> list:
    """The planned tile of each of the forward half's GEMMs
    (``step_gemms_fwd``): the step's own tiles for them."""
    return plan_gemms(step_gemms_fwd(b, t, p, hop), b, sms)


def plan_bwd(b: int, t: int, p: int, hop: int, sms: int) -> list:
    """The planned tile of each of the backward half's GEMMs
    (``step_gemms_bwd``): the step's own tiles for them."""
    return plan_gemms(step_gemms_bwd(b, t, p, hop), b, sms)


@functools.lru_cache(maxsize=64)
def step_tiles(b: int, t: int, p: int, hop: int, sms: int):
    """``plan_step`` as the host array of (bm, bn) pairs the C entry takes."""
    return tile_array(plan_step(b, t, p, hop, sms))


@functools.lru_cache(maxsize=64)
def fwd_tiles(b: int, t: int, p: int, hop: int, sms: int):
    """``plan_fwd`` as the host array of (bm, bn) pairs aw_iteration_fwd_sm90 takes."""
    return tile_array(plan_fwd(b, t, p, hop, sms))


@functools.lru_cache(maxsize=64)
def bwd_tiles(b: int, t: int, p: int, hop: int, sms: int):
    """``plan_bwd`` as the host array of (bm, bn) pairs aw_iteration_bwd takes."""
    return tile_array(plan_bwd(b, t, p, hop, sms))


# ---------------------------------------------------------- plain versions ---

def iteration_forward_fwd_plain(ct: torch.Tensor, c: IterConsts):
    """ct (B, T, P) -> (pred (B, 128), IterResiduals): ``synth_norm`` then
    ``analysis_detector``.  Differentiable w.r.t. ct by autograd."""
    u = synth_u_plain(ct, c.csin, c.y_const, c.env, c.ab)
    m1 = u.abs().amax(dim=(1, 2))
    pred, det = analysis_detector_fwd_plain(u / peak_den(m1), c.analysis)
    return pred, IterResiduals(det, u, m1)


def iteration_forward_bwd_plain(g: torch.Tensor, res: IterResiduals, c: IterConsts):
    """VJP of :func:`iteration_forward_fwd_plain` w.r.t. ct: g (B, 128) ->
    dct (B, T, P), from the forward's residuals."""
    gy2 = analysis_detector_bwd_plain(g, res.det, c.analysis)
    return synth_norm_bwd_plain(gy2, res.y2, res.m1, c.csin, c.env, c.abt)


def push_extremes_grad(pred: torch.Tensor, wm: torch.Tensor):
    """The push_extremes loss of the first 20 lanes of pred (B, 128) against
    wm (B, 128), per clip (B,), and its gradient on pred (B, 128), 0 on the
    other lanes: (2 (pred - wm) - 0.1 sgn(pred)) / 20, with sgn(0) = 0 as
    the kernels (and the JAX step kernel) take it, by autograd of
    ``embed.losses.push_extremes``'s expression with torch's ``abs`` (whose
    gradient at 0 is 0), so that off pred == 0 it is the float the
    autograd paths of the solver get."""
    with torch.enable_grad():
        p = pred[:, :N_BITS].detach().requires_grad_(True)
        loss = mse(p, wm[:, :N_BITS]) - 0.1 * p.abs().mean(dim=-1)
        (dp,) = torch.autograd.grad(loss.sum(), p)
    dpred = torch.zeros_like(pred)
    dpred[:, :N_BITS] = dp
    return loss.detach(), dpred


def step_epilogue_plain(g, ct, m, v, best, best_loss, lower, upper, loss, s1, s2, d2,
                        k: NadamCoefs) -> None:
    """The step's epilogue, in place on ct, m, v, best and best_loss:
    torch's NAdam update with the per-clip s1, s2 (B,) and the shared d2,
    the clamp to [lower, upper], then best = new ct and best_loss = loss
    where loss < best_loss.  The same operations in the same order as
    ``embed.optim.nadam`` and the solver's generic loop."""
    m_new = m + k.c_m * (g - m)
    v_new = k.b2 * v + k.c_v * (g * g)
    denom = torch.sqrt(v_new / d2) + k.eps
    new = ct - s1[:, None, None] * g / denom
    new = new - s2[:, None, None] * m_new / denom
    new = torch.clamp(new, lower, upper)
    better = loss < best_loss
    best.copy_(torch.where(better[:, None, None], new, best))
    best_loss.copy_(torch.where(better, loss, best_loss))
    ct.copy_(new)
    m.copy_(m_new)
    v.copy_(v_new)


def iteration_step_plain(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2,
                         c: IterConsts, k: NadamCoefs) -> torch.Tensor:
    """One whole solver step, in place on ct, m, v, best and best_loss;
    returns the pre-step ct's loss (B,)."""
    pred, res = iteration_forward_fwd_plain(ct, c)
    loss, dpred = push_extremes_grad(pred, wm)
    g = iteration_forward_bwd_plain(dpred, res, c)
    step_epilogue_plain(g, ct, m, v, best, best_loss, lower, upper, loss, s1, s2, d2, k)
    return loss


# ---------------------------------------------------------------- wrappers ---

_DET_FWD = ("melb", "w0t", "w1t", "w2t", "w3t", "biases", "eo")
_DET_BWD = ("w0", "w1", "w2", "w3", "eot", "melbt")


def _run_table(entry: str, device, tensors, *args) -> None:
    """Launch a C entry that takes a host array of device pointers."""
    table = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
    _run(entry, device, table, len(tensors), *args)


def _check_iter(c: IterConsts, b: int, t: int, p: int, dev) -> int:
    """Check the constants for B clips of T frames; returns hop."""
    hop = c.env.shape[-1]
    p2 = 2 * p
    _check_geometry(p, hop, c.ab.shape[-1])
    if p != P_BAND:
        raise ValueError(f"the whole-iteration kernels need P == {P_BAND} (got {p})")
    if not MIN_FRAMES <= t:
        raise ValueError(f"the whole-iteration kernels need T >= {MIN_FRAMES} frames (got {t})")
    _check("csin", c.csin, (b, t, p2), _BF16, dev)
    _check("y_const", c.y_const, (b, t - 1, hop), _F32, dev)
    _check("env", c.env, (t - 1, hop), _F32, dev)
    _check("ab", c.ab, (p2, R * hop), _BF16, dev)
    _check("abt", c.abt, (R * hop, p2), _BF16, dev)
    _check("csw", c.csw, (R * hop, p2), _BF16, dev)
    _check("cswt", c.cswt, (p2, R * hop), _BF16, dev)
    _check_consts(c.det, p, dev)
    return hop


def _check_residuals(res: IterResiduals, b: int, t: int, p2: int, hop: int, dev) -> None:
    for name, (shape, dtype) in _residual_shapes(b, t, p2).items():
        _check(name, getattr(res.det, name), shape, dtype, dev)
    _check("u", res.u, (b, t - 1, hop), _F32, dev)
    _check("m1", res.m1, (b,), _F32, dev)


def _check_scratch(ws: Scratch, b: int, t: int, p2: int, hop: int, dev) -> None:
    for name, x, shape in zip(Scratch._fields, ws, _scratch_shapes(b, t, p2, hop)):
        _check(name, x, shape, _F32, dev)


def check_iteration_fwd(ct: torch.Tensor, c: IterConsts) -> tuple:
    """What the sm90 forward's chain cannot take: raise, before any launch.  The
    constants and ct; T >= 8 (``_check_iter``); the forward GEMMs' weights
    as their tensor maps take them.  Returns (B, T, P, hop)."""
    b, t, p = ct.shape
    dev = ct.device
    hop = _check_iter(c, b, t, p, dev)
    _check("ct", ct, (b, t, p), _F32, dev)
    check_weights_aligned(step_gemms_fwd(b, t, p, hop), _fwd_weights(c))
    return b, t, p, hop


def _fwd_tensors(ct, c: IterConsts, res: IterResiduals, ws: Scratch) -> list:
    """The forward's pointer table (csrc/iteration.cuh ``FwdArgs``), as
    both forward entries take it."""
    return [ct, c.csin, c.y_const, c.env, c.ab, c.csw,
            *(getattr(c.det, k) for k in _DET_FWD), *res.det, res.u, res.m1, *ws]


def iteration_forward_fwd(ct: torch.Tensor, c: IterConsts):
    """ct (B, T, P) -> (pred (B, 128), IterResiduals): the sm90 step's
    forward half (csrc/iteration_sm90.cu ``aw_iteration_fwd_sm90``, 20
    launches).  Replaces the TPU kernel ``_iter_fwd_kernel``
    (aware_tpu/ops/pallas/iteration.py:173)."""
    if ct.device.type == "cpu":
        return iteration_forward_fwd_plain(ct, c)
    b, t, p, hop = check_iteration_fwd(ct, c)
    dev = ct.device
    res = _residuals(b, t, 2 * p, hop, dev)
    ws = _scratch(b, t, 2 * p, hop, dev)
    ops = step_ops(b, t, 2 * p, hop, dev)
    tiles = fwd_tiles(b, t, p, hop, _sms(dev.index or 0))
    _run_table("aw_iteration_fwd_sm90", dev, [*_fwd_tensors(ct, c, res, ws), *ops],
               tiles, len(tiles), b, t, p, hop)
    iteration_forward_fwd.launches += 1
    return res.det.pred, res


def _iteration_forward_fwd_wmma(ct: torch.Tensor, c: IterConsts):
    """The forward's first chain, ``aw_iteration_fwd_wmma`` (the WMMA template,
    13 launches), on the CUDA tensors ``iteration_forward_fwd`` takes: no
    path reaches it; the chip check times it beside the sm90 chain.  Not
    counted in ``iteration_forward_fwd.launches``."""
    b, t, p, hop = check_iteration_fwd(ct, c)
    dev = ct.device
    res = _residuals(b, t, 2 * p, hop, dev)
    _run_table("aw_iteration_fwd_wmma", dev,
               _fwd_tensors(ct, c, res, _scratch(b, t, 2 * p, hop, dev)), b, t, p, hop)
    return res.det.pred, res


def _bwd_tensors(g, res: IterResiduals, c: IterConsts, dct, ws: Scratch) -> list:
    """The VJP's pointer table (csrc/iteration.cuh ``BwdArgs``), as both
    VJP entries take it."""
    return [g, *res.det, res.u, res.m1, c.csin, c.env, c.abt, c.cswt,
            *(getattr(c.det, k) for k in _DET_BWD), dct, *ws]


def step_ops(b: int, t: int, p2: int, hop: int, device) -> StepOps:
    """The sm90 chains' own buffers (``StepOps``) for B clips of T frames."""
    a16, rows, part = _ops_shapes(b, t, p2, hop)
    return StepOps(torch.empty(a16, dtype=_BF16, device=device),
                   torch.empty(rows, dtype=_F32, device=device),
                   torch.empty(part, dtype=_F32, device=device))


def check_iteration_bwd(g, res: IterResiduals, c: IterConsts) -> tuple:
    """What the VJP's chain cannot take: raise, before any launch.  The
    constants, g and the residuals; T >= 8 (``_check_iter``) and the fold's
    room for the partial sums; the backward GEMMs' weights as their tensor
    maps take them.  Returns (B, T, P, hop)."""
    b, t, p2 = res.det.nph.shape
    p = p2 // 2
    dev = g.device
    hop = _check_iter(c, b, t, p, dev)
    _check("g", g, (b, CH[4]), _F32, dev)
    _check_residuals(res, b, t, p2, hop, dev)
    _check_fold(t, hop)
    check_weights_aligned(step_gemms_bwd(b, t, p, hop), _bwd_weights(c))
    return b, t, p, hop


def iteration_forward_bwd(g: torch.Tensor, res: IterResiduals, c: IterConsts):
    """g (B, 128) -> dct (B, T, P): the sm90 step's backward half from g,
    then the phase fold (csrc/iteration_sm90.cu ``aw_iteration_bwd``, 19
    launches).  Replaces the TPU kernel ``_iter_bwd_kernel``
    (aware_tpu/ops/pallas/iteration.py:285)."""
    if g.device.type == "cpu":
        return iteration_forward_bwd_plain(g, res, c)
    b, t, p, hop = check_iteration_bwd(g, res, c)
    dev = g.device
    dct = torch.empty(b, t, p, device=dev)
    ws = _scratch(b, t, 2 * p, hop, dev)
    ops = step_ops(b, t, 2 * p, hop, dev)
    tiles = bwd_tiles(b, t, p, hop, _sms(dev.index or 0))
    _run_table("aw_iteration_bwd", dev, [*_bwd_tensors(g, res, c, dct, ws), *ops],
               tiles, len(tiles), b, t, p, hop)
    iteration_forward_bwd.launches += 1
    return dct


def _iteration_forward_bwd_wmma(g: torch.Tensor, res: IterResiduals, c: IterConsts):
    """The VJP's first chain, ``aw_iteration_bwd_wmma`` (the WMMA
    template), on the CUDA tensors ``iteration_forward_bwd`` takes: no path
    reaches it; the chip check times it beside the sm90 chain.  Not counted
    in ``iteration_forward_bwd.launches``."""
    b, t, p, hop = check_iteration_bwd(g, res, c)
    dct = torch.empty(b, t, p, device=g.device)
    _run_table("aw_iteration_bwd_wmma", g.device,
               _bwd_tensors(g, res, c, dct, _scratch(b, t, 2 * p, hop, g.device)),
               b, t, p, hop)
    return dct


def _check_state(names, tensors, shape, dev) -> None:
    for name, x in zip(names, tensors):
        _check(name, x, shape, _F32, dev)


def _fwd_weights(c: IterConsts) -> list:
    """The weights of ``step_gemms_fwd``, in order."""
    d = c.det
    return [c.ab, c.csw, d.melb, d.w0t, d.w1t, d.w2t, d.w3t]


def _bwd_weights(c: IterConsts) -> list:
    """The weights of ``step_gemms_bwd``, in order."""
    return [*det_bwd_weights(c.det), c.cswt, c.abt]


def _check_step_ops(bufs: StepBuffers, c: IterConsts, b: int, t: int, p: int, hop: int,
                    dev) -> None:
    """The sm90 step's own buffers, and what its GEMMs' tensor maps need."""
    for name, x, shape, dtype in zip(StepOps._fields, bufs.ops, _ops_shapes(b, t, 2 * p, hop),
                                     (_BF16, _F32, _F32)):
        _check(name, x, shape, dtype, dev)
    _check_fold(t, hop)
    big, rows = bufs.scratch.big, bufs.ops.rows
    a_of = {"synthesis": big, "reflect analysis": rows, "reflect analysis VJP": big,
            "synthesis VJP": rows}
    for g, w in zip(step_gemms(b, t, p, hop), _fwd_weights(c) + _bwd_weights(c)):
        if g.kind == "slab":
            check_slab_gemm(a_of[g.name].view(b, -1, g.k), w, g.n, g.rows)
        else:
            check_dense_gemm(bufs.ops.a16, w, g.rows, g.k, g.n)


def _step_tensors(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2, c: IterConsts,
                  bufs: StepBuffers) -> list:
    """The step's pointer table (csrc/iteration.cuh ``StepArgs``), as both
    step entries take it."""
    return [ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2, bufs.loss,
            c.csin, c.y_const, c.env, c.ab, c.abt, c.csw, c.cswt,
            *(getattr(c.det, n) for n in _DET_FWD), *(getattr(c.det, n) for n in _DET_BWD),
            *bufs.res.det, bufs.res.u, bufs.res.m1, *bufs.scratch]


def iteration_step(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2, c: IterConsts,
                   k: NadamCoefs, bufs: StepBuffers | None = None) -> torch.Tensor:
    """One whole solver step for B clips: forward, the push_extremes loss
    and gradient of the first 20 lanes of wm (B, 128), backward, NAdam with
    the per-clip s1, s2 (B,) and the shared d2 (1,), the clamp to [lower,
    upper] and the best snapshot.  ct, m, v, best (B, T, P) and best_loss
    (B,) are updated in place; returns the pre-step ct's loss (B,), which
    on the card is ``bufs.loss``, written again by the next step.
    Replaces the TPU kernel ``_step_kernel``
    (aware_tpu/ops/pallas/iteration.py:513)."""
    if ct.device.type == "cpu":
        return iteration_step_plain(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2,
                                    c, k)
    b, t, p = ct.shape
    dev = ct.device
    hop = _check_iter(c, b, t, p, dev)
    _check_state(("ct", "m", "v", "best", "lower", "upper"), (ct, m, v, best, lower, upper),
                 (b, t, p), dev)
    _check_state(("best_loss", "s1", "s2"), (best_loss, s1, s2), (b,), dev)
    _check("wm", wm, (b, CH[4]), _F32, dev)
    _check("d2", d2, (1,), _F32, dev)
    if bufs is None:
        bufs = step_buffers(b, t, 2 * p, hop, dev)
    _check_residuals(bufs.res, b, t, 2 * p, hop, dev)
    _check_scratch(bufs.scratch, b, t, 2 * p, hop, dev)
    _check("loss", bufs.loss, (b,), _F32, dev)
    _check_step_ops(bufs, c, b, t, p, hop, dev)
    tiles = step_tiles(b, t, p, hop, _sms(dev.index or 0))
    _run_table("aw_iteration_step", dev,
               [*_step_tensors(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2, c, bufs),
                *bufs.ops],
               tiles, len(tiles), b, t, p, hop, *k)
    iteration_step.launches += 1
    return bufs.loss


def _iteration_step_wmma(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2,
                         c: IterConsts, k: NadamCoefs, bufs: StepBuffers) -> torch.Tensor:
    """The step's first chain, ``aw_iteration_step_wmma`` (the WMMA
    template), on the CUDA tensors ``iteration_step`` takes (the constants
    checked): no path reaches it; the chip check times it beside the sm90
    chain.  Not counted in ``iteration_step.launches``."""
    b, t, p = ct.shape
    _check_iter(c, b, t, p, ct.device)
    _run_table("aw_iteration_step_wmma", ct.device,
               _step_tensors(ct, m, v, best, best_loss, lower, upper, wm, s1, s2, d2, c, bufs),
               b, t, p, c.env.shape[-1], *k)
    return bufs.loss


def _step_epilogue(dreim, csin, ct, m, v, best, best_loss, lower, upper, loss, s1, s2, d2,
                   k: NadamCoefs) -> None:
    """The CUDA step's epilogue alone (the kernels that follow its
    synthesis-VJP GEMM), in place, for the chip check against
    :func:`step_epilogue_plain` of ``phase_fold_plain(dreim, csin)``, which
    it runs on CPU tensors."""
    if ct.device.type == "cpu":
        return step_epilogue_plain(phase_fold_plain(dreim, csin), ct, m, v, best, best_loss,
                                   lower, upper, loss, s1, s2, d2, k)
    b, t, p = ct.shape
    dev = ct.device
    _check("dreim", dreim, (b, t, 2 * p), _F32, dev)
    _check("csin", csin, (b, t, 2 * p), _BF16, dev)
    _check_state(("ct", "m", "v", "best", "lower", "upper"), (ct, m, v, best, lower, upper),
                 (b, t, p), dev)
    _check_state(("best_loss", "loss", "s1", "s2"), (best_loss, loss, s1, s2), (b,), dev)
    _check("d2", d2, (1,), _F32, dev)
    _run_table("aw_step_epilogue", dev,
               [dreim, csin, ct, m, v, best, best_loss, lower, upper, loss, s1, s2, d2],
               b, t, p, *k)


KERNELS = (iteration_forward_fwd, iteration_forward_bwd, iteration_step)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ autograd op ---

class _IterationForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, c):
        pred, res = iteration_forward_fwd(ct, c)
        ctx.save_for_backward(*res.det, res.u, res.m1)
        ctx.consts = c
        return pred[:, :N_BITS]

    @staticmethod
    def backward(ctx, g):
        *det, u, m1 = ctx.saved_tensors
        gpad = g.new_zeros(g.shape[0], CH[4])  # the JAX kernel's (1, 128) cotangent
        gpad[:, :N_BITS] = g
        return iteration_forward_bwd(gpad, IterResiduals(DetResiduals(*det), u, m1),
                                     ctx.consts), None


def iteration_forward(ct: torch.Tensor, c: IterConsts) -> torch.Tensor:
    """Padded coefficients (B, T, P) -> tanh bit values (B, 20),
    differentiable w.r.t. ct."""
    return _IterationForward.apply(ct, c)
