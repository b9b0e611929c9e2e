"""The embed round trip's kernels: synth_norm and band_analysis.

The port of ``aware_tpu/ops/pallas/roundtrip.py``.  Each of the four TPU
kernels (synth_norm forward and VJP, band_analysis forward and VJP) is a
CUDA entry of ``csrc/roundtrip.cu`` with:

* a wrapper (``synth_norm_fwd``, ``synth_norm_bwd``, ``band_analysis_fwd``,
  ``band_analysis_bwd``) that checks its operands, allocates outputs and
  scratch, launches on the current stream and counts the launch in its
  ``launches`` attribute.  Given tensors on the CPU it runs the plain
  version instead; on a CUDA tensor it launches the kernel or raises;
* a plain PyTorch version (``*_plain``) with the same bf16 rounding of
  the product operands and float32 accumulation.  The CPU tests hold it
  against the JAX kernels, and the chip check holds the kernels against it.

``synth_norm`` and ``band_analysis`` are the ``torch.autograd.Function``s
the solver differentiates through.  Everything is batched: the leading
dimension B is the clip.  Shapes (T frames, P padded band bins, hop):

    coeffs (B, T, P) f32, csin (B, T, 2P) bf16, y_const (B, T-1, hop) f32,
    env (T-1, hop) f32, ab (2P, n_fft) bf16, abt (n_fft, 2P) bf16,
    y2 (B, T-1, hop) f32, csw (n_fft, 2P) bf16, cswt (2P, n_fft) bf16,
    cs2 (B, T, 2P) f32, with n_fft = 4 hop (the card's 1024 / 256).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-8
_BF16 = torch.bfloat16
R = 4    # slabs: n_fft / hop
PAD = 2  # rows of centre padding: (n_fft / 2) / hop


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the kernels' matmul operand precision."""
    return x.to(_BF16).float()


# ---------------------------------------------------------- plain versions ---

def synth_u_plain(coeffs, csin, y_const, env, ab):
    """coeffs (B, T, P) -> the synthesis before its peak-norm, u (B, T-1, hop)."""
    _, t, p = coeffs.shape
    hop = env.shape[-1]
    cs = csin.float()
    reim = _bf16(torch.cat([coeffs * cs[..., :p], coeffs * cs[..., p:]], dim=-1))
    abf = ab.float()
    yd = sum(
        F.pad(reim @ abf[:, k * hop : (k + 1) * hop], (0, 0, k, R - 1 - k))
        for k in range(R)
    )
    return yd[:, PAD : PAD + t - 1] / env + y_const


def peak_den(m1: torch.Tensor) -> torch.Tensor:
    """The peak-norm's denominator m1 (1 + e) + e^2, as (B, 1, 1)."""
    return (m1 * (1.0 + _EPS) + _EPS * _EPS)[:, None, None]


def synth_norm_fwd_plain(coeffs, csin, y_const, env, ab):
    """coeffs (B, T, P) -> (y2 (B, T-1, hop), m1 (B,))."""
    u = synth_u_plain(coeffs, csin, y_const, env, ab)
    m1 = u.abs().amax(dim=(1, 2))
    return u / peak_den(m1), m1


def phase_fold_plain(dreim: torch.Tensor, csin: torch.Tensor) -> torch.Tensor:
    """dreim (B, T, 2P) -> dreim_re * csin_re + dreim_im * csin_im (B, T, P)."""
    p = csin.shape[-1] // 2
    cs = csin.float()
    return dreim[..., :p] * cs[..., :p] + dreim[..., p:] * cs[..., p:]


def peak_norm_vjp(g, y2, m1):
    """The cotangent of u from that of y2 = u / peak_den(m1) (B, T-1, hop):
    the equal-tie-split max subgradient of the peak-norm, its ties taken
    over y2's own rows."""
    cden = peak_den(m1)
    q = (g * y2).sum(dim=(1, 2))[:, None, None]
    a = y2.abs()
    mask = (a == a.amax(dim=(1, 2), keepdim=True)).float()
    ties = mask.sum(dim=(1, 2))[:, None, None]
    return g / cden - (q * (1.0 + _EPS) / cden) * torch.sign(y2) * mask / ties


def synth_norm_bwd_plain(g, y2, m1, csin, env, abt):
    """VJP of :func:`synth_norm_fwd_plain` w.r.t. coeffs, from the
    forward's y2 and m1: the equal-tie-split max subgradient of the
    peak-norm, then the transposed slab products."""
    _, lr, hop = g.shape
    t = lr + 1
    gyd = _bf16(F.pad(peak_norm_vjp(g, y2, m1) / env, (0, 0, PAD, R - PAD)))
    abtf = abt.float()
    dreim = sum(gyd[:, k : k + t] @ abtf[k * hop : (k + 1) * hop] for k in range(R))
    return phase_fold_plain(dreim, csin)


def band_analysis_fwd_plain(y2, csw):
    """y2 (B, T-1, hop) -> zero-pad-framed in-band Re/Im (B, T, 2P)."""
    _, lr, hop = y2.shape
    t = lr + 1
    yp = _bf16(F.pad(y2, (0, 0, PAD, R - PAD)))
    cf = csw.float()
    return sum(yp[:, k : k + t] @ cf[k * hop : (k + 1) * hop] for k in range(R))


def band_analysis_bwd_plain(g, cswt):
    """VJP of :func:`band_analysis_fwd_plain` w.r.t. y2."""
    _, t, _ = g.shape
    hop = cswt.shape[1] // R
    gb = _bf16(g)
    cf = cswt.float()
    gyp = sum(
        F.pad(gb @ cf[:, k * hop : (k + 1) * hop], (0, 0, k, R - 1 - k))
        for k in range(R)
    )
    return gyp[:, PAD : PAD + t - 1]


# ---------------------------------------------------------------- wrappers ---

def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_geometry(p: int, hop: int, n_fft: int) -> None:
    # the kernels tile 64 output columns and stage 32-deep operand tiles,
    # and fold R = 4 slabs with 2 rows of centre padding
    if n_fft != R * hop or hop % 64 or p % 32:
        raise ValueError(
            f"CUDA round trip needs n_fft == 4 * hop, hop % 64 == 0 and "
            f"P % 32 == 0 (got n_fft={n_fft}, hop={hop}, P={p})"
        )


def _run(entry: str, device: torch.device, *args) -> None:
    """Launch a C entry on ``device``'s current stream; raise on its error."""
    from aware_tpu_torch.ops.kernels.build import build

    fn = getattr(build().lib, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def synth_norm_fwd(coeffs, csin, y_const, env, ab):
    """Synthesis + double peak-norm: (y2, m1).  Replaces the TPU kernel
    ``_synth_kernel`` (aware_tpu/ops/pallas/roundtrip.py:179)."""
    if coeffs.device.type == "cpu":
        return synth_norm_fwd_plain(coeffs, csin, y_const, env, ab)
    b, t, p = coeffs.shape
    hop = env.shape[-1]
    dev = coeffs.device
    _check_geometry(p, hop, ab.shape[-1])
    _check("coeffs", coeffs, (b, t, p), torch.float32, dev)
    _check("csin", csin, (b, t, 2 * p), _BF16, dev)
    _check("y_const", y_const, (b, t - 1, hop), torch.float32, dev)
    _check("env", env, (t - 1, hop), torch.float32, dev)
    _check("ab", ab, (2 * p, R * hop), _BF16, dev)
    y2 = torch.empty(b, t - 1, hop, device=dev)
    m1 = torch.empty(b, device=dev)
    max_bits = torch.empty(b, dtype=torch.int32, device=dev)
    _run("aw_synth_norm_fwd", dev, coeffs, csin, y_const, env, ab, y2, m1, max_bits,
         b, t, p, hop)
    synth_norm_fwd.launches += 1
    return y2, m1


def synth_norm_bwd(g, y2, m1, csin, env, abt):
    """VJP of the synthesis w.r.t. coeffs.  Replaces ``_synth_bwd_kernel``
    (aware_tpu/ops/pallas/roundtrip.py:223)."""
    if g.device.type == "cpu":
        return synth_norm_bwd_plain(g, y2, m1, csin, env, abt)
    b, lr, hop = g.shape
    t = lr + 1
    p = csin.shape[-1] // 2
    dev = g.device
    _check_geometry(p, hop, abt.shape[0])
    _check("g", g, (b, lr, hop), torch.float32, dev)
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    _check("m1", m1, (b,), torch.float32, dev)
    _check("csin", csin, (b, t, 2 * p), _BF16, dev)
    _check("env", env, (lr, hop), torch.float32, dev)
    _check("abt", abt, (R * hop, 2 * p), _BF16, dev)
    dcoeffs = torch.empty(b, t, p, device=dev)
    dreim = torch.empty(b, t, 2 * p, device=dev)
    scal = torch.empty(b, 4, device=dev)
    _run("aw_synth_norm_bwd", dev, g, y2, m1, csin, env, abt, dcoeffs, dreim, scal,
         b, t, p, hop)
    synth_norm_bwd.launches += 1
    return dcoeffs


def band_analysis_fwd(y2, csw):
    """Zero-pad framing + analysis DFT: cs2.  Replaces ``_analysis_kernel``
    (aware_tpu/ops/pallas/roundtrip.py:254)."""
    if y2.device.type == "cpu":
        return band_analysis_fwd_plain(y2, csw)
    b, lr, hop = y2.shape
    p2 = csw.shape[-1]
    dev = y2.device
    _check_geometry(p2 // 2, hop, csw.shape[0])
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    _check("csw", csw, (R * hop, p2), _BF16, dev)
    cs2 = torch.empty(b, lr + 1, p2, device=dev)
    _run("aw_band_analysis_fwd", dev, y2, csw, cs2, b, lr + 1, p2, hop)
    band_analysis_fwd.launches += 1
    return cs2


def band_analysis_bwd(g, cswt):
    """VJP of the analysis w.r.t. y2.  Replaces ``_analysis_bwd_kernel``
    (aware_tpu/ops/pallas/roundtrip.py:281)."""
    if g.device.type == "cpu":
        return band_analysis_bwd_plain(g, cswt)
    b, t, p2 = g.shape
    hop = cswt.shape[-1] // R
    dev = g.device
    _check_geometry(p2 // 2, hop, cswt.shape[-1])
    _check("g", g, (b, t, p2), torch.float32, dev)
    _check("cswt", cswt, (p2, R * hop), _BF16, dev)
    gy2 = torch.empty(b, t - 1, hop, device=dev)
    _run("aw_band_analysis_bwd", dev, g, cswt, gy2, b, t, p2, hop)
    band_analysis_bwd.launches += 1
    return gy2


KERNELS = (synth_norm_fwd, synth_norm_bwd, band_analysis_fwd, band_analysis_bwd)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ autograd ops ---

class _SynthNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, csin, y_const, env, ab, abt):
        y2, m1 = synth_norm_fwd(coeffs, csin, y_const, env, ab)
        ctx.save_for_backward(y2, m1, csin, env, abt)
        return y2

    @staticmethod
    def backward(ctx, g):
        y2, m1, csin, env, abt = ctx.saved_tensors
        dcoeffs = synth_norm_bwd(g.contiguous(), y2, m1, csin, env, abt)
        return dcoeffs, None, None, None, None, None


class _BandAnalysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y2, csw, cswt):
        ctx.save_for_backward(cswt)
        return band_analysis_fwd(y2, csw)

    @staticmethod
    def backward(ctx, g):
        (cswt,) = ctx.saved_tensors
        return band_analysis_bwd(g.contiguous(), cswt), None, None


def synth_norm(coeffs, csin, y_const, env, ab, abt):
    """Padded coefficients (B, T, P) -> doubly peak-normalized signal rows
    (B, T-1, hop), differentiable w.r.t. coeffs."""
    return _SynthNorm.apply(coeffs, csin, y_const, env, ab, abt)


def band_analysis(y2, csw, cswt):
    """Signal rows (B, T-1, hop) -> zero-pad-framed in-band Re/Im
    (B, T, 2P), differentiable w.r.t. y2."""
    return _BandAnalysis.apply(y2, csw, cswt)


def edge_corrections(y2_flat, csw_k, n_fft, hop, t_frames):
    """The reflect-pad contributions the zero-pad analysis kernel omits:
    a (B, T, 2P) tensor, zero except in frames {0, 1, T-2, T-1}, to add
    to the kernel's cs2.  Plain torch, as in the JAX package.

    y2_flat (B, (T-1)*hop); csw_k: the r = 4 float32 (hop, 2P) windowed
    analysis basis slabs.
    """
    half = n_fft // 2
    if half != 2 * hop:
        raise NotImplementedError("edge corrections assume n_fft//2 == 2*hop")
    lp0 = y2_flat[:, half - hop + 1 : half + 1].flip(-1)
    lp1 = y2_flat[:, 1 : half - hop + 1].flip(-1)
    rp0 = y2_flat[:, -hop - 1 : -1].flip(-1)
    rp1 = y2_flat[:, -half - 1 : -hop - 1].flip(-1)
    rows = torch.stack(
        [
            lp0 @ csw_k[0] + lp1 @ csw_k[1],
            lp1 @ csw_k[0],
            rp0 @ csw_k[3],
            rp0 @ csw_k[2] + rp1 @ csw_k[3],
        ],
        dim=1,
    )
    idx = torch.tensor([0, 1, t_frames - 2, t_frames - 1], device=y2_flat.device)
    corr = y2_flat.new_zeros(y2_flat.shape[0], t_frames, rows.shape[-1])
    return corr.index_add(1, idx, rows)
