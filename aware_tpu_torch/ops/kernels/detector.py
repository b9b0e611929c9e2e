"""The fused detector's kernels: detector_fused forward and VJP.

The port of ``aware_tpu/ops/pallas/detector.py``.  The embed solver's
detector half for a batch of clips, from the in-band Re/Im ``cs``
(B, T, 2P) to the tanh bit values, in the time-major layout of the Pallas
kernels:

    |cs| -> mel (bf16 basis rows lo:hi) -> instance norm -> global
    standardize -> AvgPool(2, 2) -> 4 x (1x1 conv bf16, instance norm,
    leaky 0.2) -> BRH (time mean, even - odd, tanh)

with bf16 matmul operands, float32 accumulation and bf16 residuals, and a
closed-form VJP for the input cotangent only (the detector is frozen key
material).  ``aw_detector_fwd`` and ``aw_detector_bwd`` of
``csrc/detector_sm90.cu`` (the sm90 step's detector halves: TMA + wgmma,
their tiles planned here; their first WMMA chains kept in
``csrc/detector.cu`` as ``aw_detector_fwd_wmma`` and
``aw_detector_bwd_wmma``, which no path reaches) are the CUDA kernels,
behind:

* wrappers (``detector_fused_fwd``, ``detector_fused_bwd``) that check
  their operands, allocate outputs and scratch, launch on the current
  stream and count the launch in ``launches``.  Given tensors on the CPU
  they run the plain version instead; on a CUDA tensor they launch the
  kernel or raise;
* plain PyTorch versions (``*_plain``), value for value the JAX kernel's
  ``_det_fwd_values`` / ``_det_bwd_values`` batched over B.  The CPU tests
  hold them against the JAX kernels, the chip check holds the kernels
  against them.

``detector_fused`` is the ``torch.autograd.Function`` over them, returning
(B, 20).  The AvgPool is the strided pair mean: the JAX kernel's dense
(T2, T) pool matrices (``pmt``, ``pm``) hold exact 0.5 / 0 entries, so
their products are that mean, and neither is built here.
"""

from __future__ import annotations

import functools
from typing import Mapping, NamedTuple

import numpy as np
import torch

from aware_tpu_torch.ops.kernels.roundtrip import (
    PART_LD,
    StepGemm,
    _bf16,
    _check,
    _run,
    _sms,
    check_weights_aligned,
    plan_gemms,
    tile_array,
)

_BF16 = torch.bfloat16
IN_EPS = 1e-5  # nn.InstanceNorm1d eps (inside the rsqrt)
GS_EPS = 1e-8  # GlobalStandardize eps (added to the std)

# padded channel widths of the default architecture
P_BAND = 256                      # in-band bins 225 -> 256
CH = (128, 512, 1024, 1024, 128)  # mel, conv0..conv3 out (40 -> 128)
N_BITS = 20                       # BRH outputs: conv3's 40 channels in pairs
MIN_FRAMES = 8  # the sm90 chains' fewest frames (distinct reflect-pad boundary rows)
MEL_CHUNKS = 15  # row chunks of the chunked mel stages at most (kMelChunks)


class DetConsts(NamedTuple):
    """The fused detector's constants: key material and bases on a device."""

    melb: torch.Tensor    # (P_BAND, 128) bf16: mel basis rows lo:hi, transposed
    w0t: torch.Tensor     # (128, 512) bf16 conv weights, transposed
    w1t: torch.Tensor     # (512, 1024) bf16
    w2t: torch.Tensor     # (1024, 1024) bf16
    w3t: torch.Tensor     # (1024, 128) bf16 (out-channels 40 -> 128, zero-padded)
    w0: torch.Tensor      # (512, 128) bf16, untransposed (backward)
    w1: torch.Tensor      # (1024, 512) bf16
    w2: torch.Tensor      # (1024, 1024) bf16
    w3: torch.Tensor      # (128, 1024) bf16
    biases: torch.Tensor  # (4, 1024) f32, row i = conv_i bias, zero-padded
    eo: torch.Tensor      # (128, 128) f32 BRH even - odd readout
    eot: torch.Tensor     # (128, 128) f32, its transpose (backward)
    melbt: torch.Tensor   # (128, P_BAND) bf16 (backward)


class DetResiduals(NamedTuple):
    """The forward's outputs the closed-form VJP reads, batched over B
    (the JAX kernel's 16 outputs, in its order)."""

    pred: torch.Tensor   # (B, 128) f32 tanh readout; columns >= 20 are 0
    nph: torch.Tensor    # (B, T, 2P) bf16 unit phase of cs (0 where cs = 0)
    mel: torch.Tensor    # (B, T, 128) bf16
    y0: torch.Tensor     # (B, T2, 512) bf16 normalized pre-activations
    y1: torch.Tensor     # (B, T2, 1024) bf16
    y2: torch.Tensor     # (B, T2, 1024) bf16
    y3: torch.Tensor     # (B, T2, 128) bf16
    mu1: torch.Tensor    # (B, 128) f32 mel instance-norm mean
    r1: torch.Tensor     # (B, 128) f32 and rsqrt(var + eps)
    rin0: torch.Tensor   # (B, 512) f32 conv instance-norm rsqrt(var + eps)
    rin1: torch.Tensor   # (B, 1024)
    rin2: torch.Tensor   # (B, 1024)
    rin3: torch.Tensor   # (B, 128)
    gmu: torch.Tensor    # (B,) f32 global-standardize mean
    gr: torch.Tensor     # (B,) 1 / (std + eps)
    s: torch.Tensor      # (B,) std

    @property
    def ys(self) -> tuple:
        return (self.y0, self.y1, self.y2, self.y3)

    @property
    def rins(self) -> tuple:
        return (self.rin0, self.rin1, self.rin2, self.rin3)


def fused_detector_consts(
    params: Mapping[str, torch.Tensor | np.ndarray],
    mel_basis: np.ndarray,
    lo: int,
    hi: int,
    device: str | torch.device = "cpu",
) -> DetConsts:
    """Pack the key weights and the mel / readout bases for the kernels, as
    ``aware_tpu/ops/pallas/detector.py:fused_detector_consts`` does.

    ``params``: ``conv{i}_w`` (C_out, C_in) and ``conv{i}_b`` (C_out,);
    ``mel_basis``: the (n_mels, n_fft // 2 + 1) Slaney basis.  The heavy
    operands are bf16; the biases and the +-1 readout stay float32.
    """
    nb = hi - lo
    if nb > P_BAND:
        raise ValueError(f"band width {nb} exceeds padded width {P_BAND}")
    melb = torch.zeros(P_BAND, CH[0])
    melb[:nb] = torch.from_numpy(np.ascontiguousarray(mel_basis[:, lo:hi].T))
    eo = torch.zeros(CH[4], CH[4])
    j = torch.arange(N_BITS)
    eo[2 * j, j] = 1.0
    eo[2 * j + 1, j] = -1.0
    biases = torch.zeros(4, CH[2])
    ws = []
    for i in range(4):
        w = torch.as_tensor(params[f"conv{i}_w"]).float().cpu()
        b = torch.as_tensor(params[f"conv{i}_b"]).float().cpu()
        c_out, c_in = w.shape
        wp = torch.zeros(CH[i + 1], CH[i])
        wp[:c_out, :c_in] = w
        ws.append(wp)
        biases[i, :c_out] = b

    def dev(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return x.to(dtype).contiguous().to(device)

    return DetConsts(
        melb=dev(melb, _BF16),
        w0t=dev(ws[0].t(), _BF16),
        w1t=dev(ws[1].t(), _BF16),
        w2t=dev(ws[2].t(), _BF16),
        w3t=dev(ws[3].t(), _BF16),
        w0=dev(ws[0], _BF16),
        w1=dev(ws[1], _BF16),
        w2=dev(ws[2], _BF16),
        w3=dev(ws[3], _BF16),
        biases=dev(biases),
        eo=dev(eo),
        eot=dev(eo.t()),
        melbt=dev(melb.t(), _BF16),
    )


def fused_detector_supported(cfg, nb: int, t_frames: int, n_fft: int | None = None) -> bool:
    """Whether the fused kernels implement this detector configuration (the
    port's ``DetectorNetConfig``): the gate of
    ``aware_tpu/ops/pallas/detector.py:fused_detector_supported``, field
    for field.  Any other architecture (another norm, activation, final
    activation, pool or channel count) runs the plain banded forward.
    """
    ch_ok = all(c % 128 == 0 for c in cfg.channels[:-1])
    return (
        (n_fft is None or cfg.n_fft == n_fft)
        and cfg.norm_layer == "instance"
        and cfg.activation == "leaky_relu"
        and cfg.final_activation == "tanh"
        and cfg.initial_pool_size == 2
        and cfg.initial_pool_stride == 2
        and cfg.num_blocks == 3
        and tuple(cfg.channels) == (128, 512, 1024, 1024, 40)
        and ch_ok
        and nb <= P_BAND
        and t_frames <= 1024  # the JAX kernel's whole-clip VMEM residency
    )


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def _mean_t(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=1, keepdim=True)


# ---------------------------------------------------------- plain versions ---

def detector_fused_fwd_plain(cs: torch.Tensor, c: DetConsts):
    """cs (B, T, 2P) f32 -> (pred (B, 128), DetResiduals).  Differentiable
    w.r.t. cs by autograd (the sgn(0) = 0 guard keeps zero bins finite)."""
    _, t, p2 = cs.shape
    p = p2 // 2
    re, im = cs[..., :p], cs[..., p:]
    sq = re * re + im * im
    zero = sq == 0
    inv = torch.where(zero, 0.0, torch.rsqrt(torch.where(zero, 1.0, sq)))
    m = sq * inv
    nph = torch.cat([re * inv, im * inv], dim=-1).to(_BF16)
    mel = _bf16(m) @ c.melb.float()                        # (B, T, 128)

    mu1 = _mean_t(mel)
    r1 = torch.rsqrt(_mean_t((mel - mu1) ** 2) + IN_EPS)
    a = (mel - mu1) * r1
    n_el = t * CH[0]
    gmu = a.mean(dim=(1, 2), keepdim=True)
    s = torch.sqrt(((a - gmu) ** 2).sum(dim=(1, 2), keepdim=True) / (n_el - 1))
    gr = 1.0 / (s + GS_EPS)
    b_full = (a - gmu) * gr
    t2 = t // 2  # a trailing odd frame is dropped
    x = 0.5 * b_full[:, 0 : 2 * t2 : 2] + 0.5 * b_full[:, 1 : 2 * t2 : 2]

    ys, rins = [], []
    for i, wt in enumerate((c.w0t, c.w1t, c.w2t, c.w3t)):
        h = _bf16(x) @ wt.float() + c.biases[i, : CH[i + 1]]
        mu = _mean_t(h)
        r = torch.rsqrt(_mean_t((h - mu) ** 2) + IN_EPS)
        yhat = (h - mu) * r
        ys.append(yhat.to(_BF16))
        rins.append(r[:, 0])
        x = _leaky(yhat)
    pred = torch.tanh(x.mean(dim=1) @ c.eo)
    res = DetResiduals(
        pred, nph, mel.to(_BF16), *ys, mu1[:, 0], r1[:, 0], *rins,
        gmu[:, 0, 0], gr[:, 0, 0], s[:, 0, 0],
    )
    return pred, res


def detector_fused_bwd_plain(g: torch.Tensor, res: DetResiduals, c: DetConsts):
    """VJP of :func:`detector_fused_fwd_plain` w.r.t. cs: g (B, 128) ->
    dcs (B, T, 2P), from the forward's residuals."""
    _, t, p2 = res.nph.shape
    p = p2 // 2
    t2 = res.y0.shape[1]
    gt = g * (1.0 - res.pred * res.pred)                   # tanh'
    dx = ((gt @ c.eot) / t2)[:, None, :].expand(-1, t2, -1)
    for i in range(3, -1, -1):
        yhat = res.ys[i].float()
        r = res.rins[i][:, None, :]
        du = dx * torch.where(yhat >= 0, 1.0, 0.2)         # leaky'
        dh = r * (du - _mean_t(du) - yhat * _mean_t(du * yhat))
        dx = _bf16(dh) @ (c.w0, c.w1, c.w2, c.w3)[i].float()

    # pool backward in f32: each frame takes half its pair's cotangent
    db = torch.zeros(dx.shape[0], t, CH[0], dtype=dx.dtype, device=dx.device)
    db[:, 0 : 2 * t2 : 2] = 0.5 * dx
    db[:, 1 : 2 * t2 : 2] = 0.5 * dx
    # global standardize and mel instance norm, from the bf16 mel residual
    a = (res.mel.float() - res.mu1[:, None]) * res.r1[:, None]
    gmu, gr, s = (v[:, None, None] for v in (res.gmu, res.gr, res.s))
    b_full = (a - gmu) * gr
    n_el = t * CH[0]
    da = gr * (db - db.mean(dim=(1, 2), keepdim=True)) - b_full * (
        (db * b_full).sum(dim=(1, 2), keepdim=True) / (s * (n_el - 1))
    )
    dmel = res.r1[:, None] * (da - _mean_t(da) - a * _mean_t(da * a))
    dm = _bf16(dmel) @ c.melbt.float()                     # (B, T, P)
    nphf = res.nph.float()
    return torch.cat([dm * nphf[..., :p], dm * nphf[..., p:]], dim=-1)


# ---------------------------------------------------------------- wrappers ---

def _check_consts(c: DetConsts, p: int, device) -> None:
    if p != P_BAND:
        raise ValueError(f"the fused detector kernels need P == {P_BAND} (got {p})")
    shapes = {
        "melb": (P_BAND, CH[0]), "melbt": (CH[0], P_BAND), "biases": (4, CH[2]),
        "eo": (CH[4], CH[4]), "eot": (CH[4], CH[4]),
        **{f"w{i}t": (CH[i], CH[i + 1]) for i in range(4)},
        **{f"w{i}": (CH[i + 1], CH[i]) for i in range(4)},
    }
    for name, shape in shapes.items():
        dtype = torch.float32 if name in ("biases", "eo", "eot") else _BF16
        _check(name, getattr(c, name), shape, dtype, device)


def _residual_shapes(b: int, t: int, p2: int) -> dict:
    t2 = t // 2
    return {
        "pred": ((b, CH[4]), torch.float32), "nph": ((b, t, p2), _BF16),
        "mel": ((b, t, CH[0]), _BF16),
        **{f"y{i}": ((b, t2, CH[i + 1]), _BF16) for i in range(4)},
        "mu1": ((b, CH[0]), torch.float32), "r1": ((b, CH[0]), torch.float32),
        **{f"rin{i}": ((b, CH[i + 1]), torch.float32) for i in range(4)},
        "gmu": ((b,), torch.float32), "gr": ((b,), torch.float32), "s": ((b,), torch.float32),
    }


def mel_chunks(t: int) -> tuple:
    """(rows per chunk, chunks) of the sm90 chains' chunked mel stages
    over T frames (csrc/detector_sm90.cuh ``mel_chunks``): rows per chunk
    even, so that a pool row's two frames share a chunk, and at most
    MEL_CHUNKS chunks."""
    rc = -(-t // MEL_CHUNKS)
    rc += rc % 2
    return rc, -(-t // rc)


def _check_mel_chunks(t: int) -> None:
    """The chunked mel stages' partial sums of T frames in a clip's
    PART_LD floats (per chunk 2 x 128 channel sums and 2 clip sums), as
    the C entries require (``mel_fits``); raise otherwise."""
    _, nch = mel_chunks(t)
    if nch > MEL_CHUNKS or 2 * nch * (CH[0] + 1) > PART_LD:
        raise ValueError(f"the chunked mel stages' partial sums need {2 * nch * (CH[0] + 1)} "
                         f"floats a clip, {nch} chunks, over the {PART_LD} of the partial sums "
                         f"(T={t})")


def det_gemms_fwd(b: int, t: int, p: int) -> list:
    """The detector forward's dense GEMMs in the sm90 chains' order (mel,
    conv 0..3; csrc/detector_sm90.cuh ``FwdGemm`` from gMel)."""
    t2 = t // 2
    return [StepGemm("mel", "dense", b * t, p, CH[0]),
            *(StepGemm(f"conv {i}", "dense", b * t2, CH[i], CH[i + 1]) for i in range(4))]


def det_fwd_weights(c: DetConsts) -> list:
    """The weights of ``det_gemms_fwd``, in order."""
    return [c.melb, c.w0t, c.w1t, c.w2t, c.w3t]


@functools.lru_cache(maxsize=64)
def det_fwd_tiles(b: int, t: int, p: int, sms: int):
    """The planned tiles of ``det_gemms_fwd`` as the host array of (bm, bn)
    pairs aw_detector_fwd takes (the sm90 step's own tiles for them)."""
    return tile_array(plan_gemms(det_gemms_fwd(b, t, p), b, sms))


def check_detector_fwd_consts(c: DetConsts, b: int, t: int, p: int, device) -> None:
    """What the sm90 forward chain cannot take for B clips of T frames
    whatever its input: raise.  T >= MIN_FRAMES, the constants, the
    chunked mel stages' room for their partial sums, and the GEMMs'
    weights as their tensor maps take them."""
    if t < MIN_FRAMES:
        raise ValueError(f"the sm90 detector forward needs T >= {MIN_FRAMES} frames (got {t})")
    _check_consts(c, p, device)
    _check_mel_chunks(t)
    check_weights_aligned(det_gemms_fwd(b, t, p), det_fwd_weights(c))


def check_detector_fwd(cs: torch.Tensor, c: DetConsts) -> tuple:
    """What the sm90 forward chain cannot take: raise, before any launch
    (``check_detector_fwd_consts``, then cs).  Returns (B, T, P)."""
    b, t, p2 = cs.shape
    check_detector_fwd_consts(c, b, t, p2 // 2, cs.device)
    _check("cs", cs, (b, t, p2), torch.float32, cs.device)
    return b, t, p2 // 2


def _fwd_outputs(b: int, t: int, p2: int, dev) -> tuple:
    """The forward's residuals and the scratch both forward chains share
    (mel32, ha, hb, mu, pool4)."""
    res = DetResiduals(**{
        k: torch.empty(shape, dtype=dtype, device=dev)
        for k, (shape, dtype) in _residual_shapes(b, t, p2).items()
    })
    t2 = t // 2
    scratch = [torch.empty(shape, device=dev) for shape in
               ((b, t, CH[0]), (b, t2, CH[2]), (b, t2, CH[2]), (b, CH[2]), (b, CH[4]))]
    return res, scratch


def detector_fused_fwd(cs: torch.Tensor, c: DetConsts):
    """cs (B, T, 2P) -> (pred (B, 128), DetResiduals): the sm90 step's
    detector forward from cs (csrc/detector_sm90.cu ``aw_detector_fwd``, 16
    launches, its 5 GEMMs' tiles planned here).  Replaces the TPU kernel
    ``_fwd_kernel`` (aware_tpu/ops/pallas/detector.py:310)."""
    if cs.device.type == "cpu":
        return detector_fused_fwd_plain(cs, c)
    b, t, p = check_detector_fwd(cs, c)
    dev = cs.device
    res, scratch = _fwd_outputs(b, t, 2 * p, dev)
    a16 = torch.empty(b, max((t // 2) * CH[2], t * p), dtype=_BF16, device=dev)
    part = torch.empty(b, PART_LD, device=dev)
    tiles = det_fwd_tiles(b, t, p, _sms(dev.index or 0))
    _run("aw_detector_fwd", dev, cs, c.melb, c.w0t, c.w1t, c.w2t, c.w3t, c.biases, c.eo,
         *res, *scratch, a16, part, tiles, len(tiles), b, t, p)
    detector_fused_fwd.launches += 1
    return res.pred, res


def _detector_fused_fwd_wmma(cs: torch.Tensor, c: DetConsts):
    """The forward's first chain, ``aw_detector_fwd_wmma`` (the WMMA
    template), on the CUDA tensors ``detector_fused_fwd`` takes: no path
    reaches it; the chip check times it beside the sm90 chain.  Not
    counted in ``detector_fused_fwd.launches``."""
    b, t, p = check_detector_fwd(cs, c)
    res, scratch = _fwd_outputs(b, t, 2 * p, cs.device)
    _run("aw_detector_fwd_wmma", cs.device, cs, c.melb, c.w0t, c.w1t, c.w2t, c.w3t, c.biases,
         c.eo, *res, *scratch, b, t, p)
    return res.pred, res


def det_gemms_bwd(b: int, t: int, p: int) -> list:
    """The detector VJP's dense GEMMs in the sm90 chains' order (conv 3..0
    VJP, mel VJP; ``BwdGemm``'s first five)."""
    t2 = t // 2
    return [*(StepGemm(f"conv {i} VJP", "dense", b * t2, CH[i + 1], CH[i])
              for i in range(3, -1, -1)),
            StepGemm("mel VJP", "dense", b * t, CH[0], p)]


def det_bwd_weights(c: DetConsts) -> list:
    """The weights of ``det_gemms_bwd``, in order."""
    return [c.w3, c.w2, c.w1, c.w0, c.melbt]


@functools.lru_cache(maxsize=64)
def det_bwd_tiles(b: int, t: int, p: int, sms: int):
    """The planned tiles of ``det_gemms_bwd`` as the host array of (bm, bn)
    pairs aw_detector_bwd takes (the sm90 step's own tiles for them)."""
    return tile_array(plan_gemms(det_gemms_bwd(b, t, p), b, sms))


def check_detector_bwd(g: torch.Tensor, res: DetResiduals, c: DetConsts) -> tuple:
    """What the sm90 VJP chain cannot take: raise, before any launch.  g,
    the residuals and the constants; T >= MIN_FRAMES and the chunked mel
    stages' room for their partial sums; the GEMMs' weights as their
    tensor maps take them.  Returns (B, T, P)."""
    b, t, p2 = res.nph.shape
    dev = g.device
    if t < MIN_FRAMES:
        raise ValueError(f"the sm90 detector VJP needs T >= {MIN_FRAMES} frames (got {t})")
    _check("g", g, (b, CH[4]), torch.float32, dev)
    for name, (shape, dtype) in _residual_shapes(b, t, p2).items():
        _check(name, getattr(res, name), shape, dtype, dev)
    _check_consts(c, p2 // 2, dev)
    _check_mel_chunks(t)
    check_weights_aligned(det_gemms_bwd(b, t, p2 // 2), det_bwd_weights(c))
    return b, t, p2 // 2


def detector_fused_bwd(g: torch.Tensor, res: DetResiduals, c: DetConsts):
    """g (B, 128) -> dcs (B, T, 2P): the sm90 step's detector VJP from g
    (csrc/detector_sm90.cu ``aw_detector_bwd``, 13 launches, its 5 GEMMs'
    tiles planned here).  Replaces the TPU kernel ``_bwd_kernel``
    (aware_tpu/ops/pallas/detector.py:401)."""
    if g.device.type == "cpu":
        return detector_fused_bwd_plain(g, res, c)
    b, t, p = check_detector_bwd(g, res, c)
    dev = g.device
    t2 = t // 2
    dcs = torch.empty(b, t, 2 * p, device=dev)
    dxa = torch.empty(b, t2, CH[2], device=dev)
    dxb = torch.empty(b, t2, CH[2], device=dev)
    m1 = torch.empty(b, CH[2], device=dev)
    m2 = torch.empty(b, CH[2], device=dev)
    dx4 = torch.empty(b, CH[4], device=dev)
    a16 = torch.empty(b, max(t2 * CH[2], t * CH[0]), dtype=_BF16, device=dev)
    part = torch.empty(b, PART_LD, device=dev)
    tiles = det_bwd_tiles(b, t, p, _sms(dev.index or 0))
    _run("aw_detector_bwd", dev, g, *res, c.w0, c.w1, c.w2, c.w3, c.eot, c.melbt, dcs,
         dxa, dxb, m1, m2, dx4, a16, part, tiles, len(tiles), b, t, p)
    detector_fused_bwd.launches += 1
    return dcs


def _detector_fused_bwd_wmma(g: torch.Tensor, res: DetResiduals, c: DetConsts):
    """The VJP's first chain, ``aw_detector_bwd_wmma`` (the WMMA
    template), on the CUDA tensors ``detector_fused_bwd`` takes: no path
    reaches it; the chip check times it beside the sm90 chain.  Not
    counted in ``detector_fused_bwd.launches``."""
    b, t, p = check_detector_bwd(g, res, c)
    dev = g.device
    t2 = t // 2
    dcs = torch.empty(b, t, 2 * p, device=dev)
    scratch = [torch.empty(shape, device=dev) for shape in
               ((b, t2, CH[2]), (b, t2, CH[2]), (b, CH[2]), (b, CH[2]), (b, CH[4]), (b, 2))]
    _run("aw_detector_bwd_wmma", dev, g, *res, c.w0, c.w1, c.w2, c.w3, c.eot, c.melbt, dcs,
         *scratch, b, t, p)
    return dcs


KERNELS = (detector_fused_fwd, detector_fused_bwd)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ autograd op ---

class _DetectorFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cs, c):
        pred, res = detector_fused_fwd(cs, c)
        ctx.save_for_backward(*res)
        ctx.consts = c
        return pred[:, :N_BITS]

    @staticmethod
    def backward(ctx, g):
        res = DetResiduals(*ctx.saved_tensors)
        gpad = g.new_zeros(g.shape[0], CH[4])
        gpad[:, :N_BITS] = g
        return detector_fused_bwd(gpad, res, ctx.consts), None


def detector_fused(cs: torch.Tensor, c: DetConsts) -> torch.Tensor:
    """In-band Re/Im (B, T, 2P) -> tanh bit values (B, 20), differentiable
    w.r.t. cs."""
    return _DetectorFused.apply(cs, c)
