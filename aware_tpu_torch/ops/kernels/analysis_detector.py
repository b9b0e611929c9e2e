"""The merged analysis + detector: analysis_detector forward and VJP.

The port of ``aware_tpu/ops/pallas/analysis_detector.py``: the solver's
front half from the normalized signal rows y2 (B, T-1, hop) to the tanh
bit values, with the exact reflect-pad framing of the STFT

    y2 -> reflect-pad rows -> slab analysis DFT (bf16 csw) -> cs2 (B, T, 2P)
       -> the fused detector (ops/kernels/detector.py) -> pred

and its VJP, the detector's VJP followed by the transposed slabs and the
reflect-pad routing back into the boundary signal rows.  On the card each
direction is two C entries of ``csrc/detector_sm90.cu``, the sm90 step's
halves (TMA + wgmma): ``aw_reflect_analysis_fwd`` (the reflect pad, then
the step's analysis slab GEMM) then ``aw_detector_fwd``, and
``aw_detector_bwd`` then ``aw_reflect_analysis_bwd``; their first WMMA
versions stay as ``*_wmma`` (``csrc/analysis_detector.cu``,
``csrc/detector.cu``), which no path reaches.  The wrappers
``analysis_detector_fwd`` / ``analysis_detector_bwd`` check both halves
before the first launch, count their own launch in ``launches``, and the
detector wrappers they call count theirs; given tensors on the CPU they
run the plain versions.

The JAX kernel builds the four pad rows as products with 0/1 flip matrices
(``reflect_pad_matrices``, ``_pad_rows``); the plain version here does the
same, and the CUDA kernel reads the reflected samples by index, which is
the same function (each product picks one bf16 sample).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.kernels.detector import (
    CH,
    MIN_FRAMES,
    N_BITS,
    DetConsts,
    DetResiduals,
    _detector_fused_bwd_wmma,
    _detector_fused_fwd_wmma,
    check_detector_bwd,
    check_detector_fwd_consts,
    detector_fused_bwd,
    detector_fused_bwd_plain,
    detector_fused_fwd,
    detector_fused_fwd_plain,
)
from aware_tpu_torch.ops.kernels.roundtrip import (
    PAD,
    R,
    StepGemm,
    _bf16,
    _check,
    _check_geometry,
    _run,
    check_slab_gemm,
    check_weights_aligned,
    slab_plan_for,
)

_BF16 = torch.bfloat16


class AnalysisDetConsts(NamedTuple):
    """The merged kernels' constants: the analysis bases and the
    detector's constants."""

    csw: torch.Tensor   # (n_fft, 2P) bf16 windowed analysis basis
    cswt: torch.Tensor  # (2P, n_fft) bf16, its transpose
    det: DetConsts


def _pad_mats_np(hop: int) -> np.ndarray:
    """(4 hop, hop) stack [F1; E1; F2; E2] of the reflect-pad flip matrices:
    F1[j, i] = 1 iff i + j = hop, E1 = [0, 0], F2[j, i] = 1 iff
    i + j = hop - 2, E2 = [hop-1, hop-1] (all symmetric)."""
    h = hop
    m = np.zeros((4 * h, h), np.float32)
    j = np.arange(1, h)
    m[j, h - j] = 1.0
    m[h, 0] = 1.0
    j2 = np.arange(0, h - 1)
    m[2 * h + j2, h - 2 - j2] = 1.0
    m[4 * h - 1, h - 1] = 1.0
    return m


@functools.lru_cache(maxsize=8)
def reflect_pad_matrices(hop: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """bf16 (4 hop, hop) [F1; E1; F2; E2] on ``device``, built once per hop
    and device (the plain versions run inside CUDA-graph captures too)."""
    return torch.from_numpy(_pad_mats_np(hop)).to(device, _BF16)


def _pad_rows(y2b: torch.Tensor, pads: torch.Tensor, lr: int, h: int):
    """The four reflect-pad rows (B, hop) from bf16-valued y2 rows
    (B, lr, hop): the two before the clip, then the two after it."""
    pf = pads.float()
    f1, e1, f2, e2 = pf[0:h], pf[h : 2 * h], pf[2 * h : 3 * h], pf[3 * h :]
    top0 = y2b[:, 1] @ f1 + y2b[:, 2] @ e1
    top1 = y2b[:, 0] @ f1 + y2b[:, 1] @ e1
    bot0 = y2b[:, lr - 1] @ f2 + y2b[:, lr - 2] @ e2
    bot1 = y2b[:, lr - 2] @ f2 + y2b[:, lr - 3] @ e2
    return top0, top1, bot0, bot1


# ---------------------------------------------------------- plain versions ---

def reflect_analysis_fwd_plain(y2: torch.Tensor, ac: AnalysisDetConsts) -> torch.Tensor:
    """y2 (B, T-1, hop) -> cs2 (B, T, 2P): the reflect-pad rows, then the
    slab DFT of the bf16 frames."""
    _, lr, hop = y2.shape
    t = lr + 1
    pads = reflect_pad_matrices(hop, y2.device)
    top0, top1, bot0, bot1 = _pad_rows(_bf16(y2), pads, lr, hop)
    yp = torch.cat([top0[:, None], top1[:, None], y2, bot0[:, None], bot1[:, None]], dim=1)
    cf = ac.csw.float()
    return sum(_bf16(yp[:, k : k + t]) @ cf[k * hop : (k + 1) * hop] for k in range(R))


def analysis_detector_fwd_plain(y2: torch.Tensor, ac: AnalysisDetConsts):
    """y2 (B, T-1, hop) -> (pred (B, 128), DetResiduals).  Differentiable
    w.r.t. y2 by autograd."""
    return detector_fused_fwd_plain(reflect_analysis_fwd_plain(y2, ac), ac.det)


def reflect_analysis_bwd_plain(dcs: torch.Tensor, ac: AnalysisDetConsts) -> torch.Tensor:
    """dcs (B, T, 2P) -> gy2 (B, T-1, hop): the transposed slabs, then the
    pad rows' bf16 cotangents routed through the same flip matrices."""
    _, t, _ = dcs.shape
    lr = t - 1
    hop = ac.cswt.shape[1] // R
    gb = _bf16(dcs)
    cf = ac.cswt.float()
    gyp = sum(
        F.pad(gb @ cf[:, k * hop : (k + 1) * hop], (0, 0, k, R - 1 - k)) for k in range(R)
    )  # (B, T + 3, hop): the padded signal's rows
    gy2 = gyp[:, PAD : PAD + lr].clone()
    pf = reflect_pad_matrices(hop, dcs.device).float()
    f1, e1, f2, e2 = pf[0:hop], pf[hop : 2 * hop], pf[2 * hop : 3 * hop], pf[3 * hop :]
    g0, g1 = _bf16(gyp[:, 0]), _bf16(gyp[:, 1])
    gb0, gb1 = _bf16(gyp[:, PAD + lr]), _bf16(gyp[:, PAD + lr + 1])
    gy2[:, 0] += g1 @ f1
    gy2[:, 1] += g0 @ f1 + g1 @ e1
    gy2[:, 2] += g0 @ e1
    gy2[:, lr - 3] += gb1 @ e2
    gy2[:, lr - 2] += gb0 @ e2 + gb1 @ f2
    gy2[:, lr - 1] += gb0 @ f2
    return gy2


def analysis_detector_bwd_plain(g: torch.Tensor, res: DetResiduals, ac: AnalysisDetConsts):
    """VJP of :func:`analysis_detector_fwd_plain` w.r.t. y2: g (B, 128) ->
    gy2 (B, T-1, hop), from the forward's residuals."""
    return reflect_analysis_bwd_plain(detector_fused_bwd_plain(g, res, ac.det), ac)


# ---------------------------------------------------------------- wrappers ---

def _check_analysis(ac: AnalysisDetConsts, t: int, hop: int, device) -> int:
    p2 = ac.csw.shape[-1]
    _check_geometry(p2 // 2, hop, ac.csw.shape[0])
    if t < MIN_FRAMES:
        raise ValueError(f"the merged kernels need T >= {MIN_FRAMES} frames (got {t})")
    _check("csw", ac.csw, (R * hop, p2), _BF16, device)
    _check("cswt", ac.cswt, (p2, R * hop), _BF16, device)
    return p2


def reflect_gemm_fwd(t: int, p2: int, hop: int) -> StepGemm:
    """The reflect analysis's slab GEMM (the sm90 step's, and
    aw_reflect_analysis_fwd's): T rows of 2P from the lr + 4 padded rows'
    hop columns."""
    return StepGemm("reflect analysis", "slab", t, hop, p2)


def check_reflect_analysis_fwd(y2: torch.Tensor, ac: AnalysisDetConsts) -> tuple:
    """What the reflect analysis's sm90 chain cannot take: raise, before
    any launch.  y2 and the analysis constants; T >= MIN_FRAMES; the slab
    GEMM's weight as its tensor map takes it.  Returns (B, T, 2P, hop)."""
    b, lr, hop = y2.shape
    dev = y2.device
    p2 = _check_analysis(ac, lr + 1, hop, dev)
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    check_weights_aligned([reflect_gemm_fwd(lr + 1, p2, hop)], [ac.csw])
    return b, lr + 1, p2, hop


def _reflect_analysis_fwd(y2: torch.Tensor, ac: AnalysisDetConsts,
                          wmma: bool = False) -> torch.Tensor:
    """The CUDA counterpart of :func:`reflect_analysis_fwd_plain`: the
    reflect-padded rows, then the slab GEMM on its planned tile; with
    ``wmma``, its first WMMA version (no path reaches it)."""
    b, t, p2, hop = check_reflect_analysis_fwd(y2, ac)
    dev = y2.device
    cs2 = torch.empty(b, t, p2, device=dev)
    if wmma:
        _run("aw_reflect_analysis_fwd_wmma", dev, y2, ac.csw, cs2, b, t, p2, hop)
        return cs2
    gm = reflect_gemm_fwd(t, p2, hop)
    ypad = torch.empty(b, t - 1 + 2 * PAD, hop, device=dev)
    check_slab_gemm(ypad, ac.csw, gm.n, gm.rows)
    plan = slab_plan_for(ypad, gm.rows, gm.n)
    _run("aw_reflect_analysis_fwd", dev, y2, ac.csw, cs2, ypad, b, t, p2, hop, plan.bm, plan.bn)
    return cs2


def reflect_gemm_bwd(t: int, p2: int, hop: int) -> StepGemm:
    """The reflect analysis VJP's slab GEMM (the sm90 step's, and
    aw_reflect_analysis_bwd's): the lr + 4 padded rows of hop from dcs's
    2P columns."""
    return StepGemm("reflect analysis VJP", "slab", t - 1 + 2 * PAD, p2, hop)


def _reflect_analysis_bwd(dcs: torch.Tensor, ac: AnalysisDetConsts,
                          wmma: bool = False) -> torch.Tensor:
    """The CUDA counterpart of :func:`reflect_analysis_bwd_plain`: the
    slab GEMM over the lr + 4 padded rows on its planned tile, then the
    fold of the pad rows; with ``wmma``, its first WMMA version (no path
    reaches it)."""
    b, t, p2 = dcs.shape
    hop = ac.cswt.shape[1] // R
    dev = dcs.device
    _check_analysis(ac, t, hop, dev)
    _check("dcs", dcs, (b, t, p2), torch.float32, dev)
    gm = reflect_gemm_bwd(t, p2, hop)
    check_slab_gemm(dcs, ac.cswt, gm.n, gm.rows)
    gy2 = torch.empty(b, t - 1, hop, device=dev)
    gpad = torch.empty(b, 2 * PAD, hop, device=dev)
    args = (dcs, ac.cswt, gy2, gpad, b, t, p2, hop)
    if wmma:
        _run("aw_reflect_analysis_bwd_wmma", dev, *args)
    else:
        plan = slab_plan_for(dcs, gm.rows, gm.n)
        _run("aw_reflect_analysis_bwd", dev, *args, plan.bm, plan.bn)
    return gy2


def check_analysis_detector_bwd(g: torch.Tensor, res: DetResiduals,
                                ac: AnalysisDetConsts) -> tuple:
    """What the VJP's two sm90 chains cannot take: raise, before either
    launches.  The detector half's (``check_detector_bwd``), then the
    analysis half's constants and its weight as its tensor map takes it.
    Returns (B, T, 2P, hop)."""
    b, t, _ = check_detector_bwd(g, res, ac.det)
    hop = ac.cswt.shape[1] // R
    p2 = _check_analysis(ac, t, hop, g.device)
    check_weights_aligned([reflect_gemm_bwd(t, p2, hop)], [ac.cswt])
    return b, t, p2, hop


def check_analysis_detector_fwd(y2: torch.Tensor, ac: AnalysisDetConsts) -> tuple:
    """What the forward's two sm90 chains cannot take: raise, before
    either launches.  The analysis half's (``check_reflect_analysis_fwd``),
    then the detector half's for the cs2 it writes
    (``check_detector_fwd_consts``).  Returns (B, T, 2P, hop)."""
    b, t, p2, hop = check_reflect_analysis_fwd(y2, ac)
    check_detector_fwd_consts(ac.det, b, t, p2 // 2, y2.device)
    return b, t, p2, hop


def analysis_detector_fwd(y2: torch.Tensor, ac: AnalysisDetConsts):
    """y2 (B, T-1, hop) -> (pred (B, 128), DetResiduals): the sm90
    reflect analysis (``aw_reflect_analysis_fwd``), then the sm90 detector
    forward (``detector_fused_fwd``), 18 launches.  Replaces the TPU kernel
    ``_ad_fwd_kernel`` (aware_tpu/ops/pallas/analysis_detector.py:177)."""
    if y2.device.type == "cpu":
        return analysis_detector_fwd_plain(y2, ac)
    check_analysis_detector_fwd(y2, ac)
    cs2 = _reflect_analysis_fwd(y2, ac)
    analysis_detector_fwd.launches += 1
    return detector_fused_fwd(cs2, ac.det)


def _analysis_detector_fwd_wmma(y2: torch.Tensor, ac: AnalysisDetConsts):
    """The forward's first versions, ``aw_reflect_analysis_fwd_wmma`` then
    ``aw_detector_fwd_wmma`` (the WMMA template), on the CUDA tensors
    ``analysis_detector_fwd`` takes: no path reaches them; the chip check
    times them beside the sm90 pair.  Counted nowhere."""
    check_analysis_detector_fwd(y2, ac)
    return _detector_fused_fwd_wmma(_reflect_analysis_fwd(y2, ac, wmma=True), ac.det)


def analysis_detector_bwd(g: torch.Tensor, res: DetResiduals, ac: AnalysisDetConsts):
    """g (B, 128) -> gy2 (B, T-1, hop): the sm90 detector VJP
    (``detector_fused_bwd``), then the sm90 reflect analysis VJP and the
    fold.  Replaces the TPU kernel ``_ad_bwd_kernel``
    (aware_tpu/ops/pallas/analysis_detector.py:251)."""
    if g.device.type == "cpu":
        return analysis_detector_bwd_plain(g, res, ac)
    check_analysis_detector_bwd(g, res, ac)
    gy2 = _reflect_analysis_bwd(detector_fused_bwd(g, res, ac.det), ac)
    analysis_detector_bwd.launches += 1
    return gy2


def _analysis_detector_bwd_wmma(g: torch.Tensor, res: DetResiduals, ac: AnalysisDetConsts):
    """The VJP's first versions, ``aw_detector_bwd_wmma`` then
    ``aw_reflect_analysis_bwd_wmma`` (the WMMA template), on the CUDA
    tensors ``analysis_detector_bwd`` takes: no path reaches them; the chip
    check times them beside the sm90 pair.  Counted nowhere."""
    check_analysis_detector_bwd(g, res, ac)
    return _reflect_analysis_bwd(_detector_fused_bwd_wmma(g, res, ac.det), ac, wmma=True)


KERNELS = (analysis_detector_fwd, analysis_detector_bwd)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ autograd op ---

class _AnalysisDetector(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y2, ac):
        pred, res = analysis_detector_fwd(y2, ac)
        ctx.save_for_backward(*res)
        ctx.consts = ac
        return pred[:, :N_BITS]

    @staticmethod
    def backward(ctx, g):
        res = DetResiduals(*ctx.saved_tensors)
        gpad = g.new_zeros(g.shape[0], CH[4])  # the JAX kernel's (1, 128) cotangent
        gpad[:, :N_BITS] = g
        return analysis_detector_bwd(gpad, res, ctx.consts), None


def analysis_detector(y2: torch.Tensor, ac: AnalysisDetConsts) -> torch.Tensor:
    """Normalized signal rows (B, T-1, hop) -> tanh bit values (B, 20),
    differentiable w.r.t. y2."""
    return _AnalysisDetector.apply(y2, ac)
