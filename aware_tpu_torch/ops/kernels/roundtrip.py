"""The embed round trip's kernels: synth_norm and band_analysis.

The port of ``aware_tpu/ops/pallas/roundtrip.py``.  Each of the four TPU
kernels (synth_norm forward and VJP, band_analysis forward and VJP) is a
CUDA entry on TMA and wgmma: the synth_norm pair of
``csrc/roundtrip_sm90.cu`` (the sm90 step's synthesis stages, on the
step's own tiles for its two synthesis GEMMs: ``synth_fwd_tiles``,
``synth_bwd_tiles``), the band_analysis pair of ``csrc/slab_gemm_sm90.cu``
(with ``shift_mm``; its tile is planned here, ``plan_slab_gemm``, as is
the tile of the whole step's dense GEMMs, ``plan_dense_gemm``).  Their
first WMMA versions stay in ``csrc/roundtrip.cu`` (``aw_*_wmma``), which no
path reaches.  Each kernel has:

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

import ctypes
import dataclasses
import functools
import typing

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


# The sm90 slab GEMM (csrc/slab_gemm_sm90.cuh) of shift_mm and the
# band_analysis VJP: A comes in depth chunks of SLAB_DEPTH f32 columns,
# the weights in boxes of 64 bf16 columns, and each call takes one of
# SLAB_TILES (BM output rows x BN columns per block).
SLAB_DEPTH = 32
SLAB_TILES = ((128, 128), (64, 128), (64, 64))
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    bm: int
    bn: int
    grid: tuple[int, int, int]  # the launch's (column tiles, row tiles, clips)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan_slab_gemm(batch: int, n_out: int, e: int, sms: int = H100_SMS) -> SlabPlan:
    """The tile of one slab-GEMM launch: the largest of SLAB_TILES whose
    grid has a block for every SM, else the one with the most blocks."""
    plans = [SlabPlan(bm, bn, (e // bn, -(-n_out // bm), batch))
             for bm, bn in SLAB_TILES if e % bn == 0]
    if not plans:
        raise ValueError(f"the slab GEMM needs E % 64 == 0 (got {e})")
    return next((pl for pl in plans if pl.blocks >= sms), max(plans, key=lambda pl: pl.blocks))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_slab_gemm(a: torch.Tensor, w: torch.Tensor, e: int, n_out: int) -> None:
    """What the slab GEMM's tensor maps and tiles cannot take: raise.
    ``a`` (B, N, D) f32 and ``w`` the bf16 weights, both contiguous, for
    an output (B, n_out, e)."""
    _, n, d = a.shape
    if d % SLAB_DEPTH or e % 64:
        raise ValueError(f"the slab GEMM needs D % {SLAB_DEPTH} == 0 and E % 64 == 0 "
                         f"(got D={d}, E={e})")
    # TMA reads from 16-byte aligned addresses with 16-byte aligned strides
    # (D % 32 makes A's; E % 64 the weights')
    for name, x in (("A", a), ("the weights", w)):
        if x.data_ptr() % 16:
            raise ValueError(f"the slab GEMM needs {name} 16-byte aligned "
                             f"(at {x.data_ptr():#x})")
    if n < 1 or n_out < 1:
        raise ValueError(f"the slab GEMM needs rows (got N={n}, n_out={n_out})")


def slab_plan_for(a: torch.Tensor, n_out: int, e: int) -> SlabPlan:
    """The planned tile of a launch on ``a``'s card."""
    return plan_slab_gemm(a.shape[0], n_out, e, _sms(a.device.index or 0))


# The sm90 dense GEMM (csrc/dense_gemm_sm90.cuh) of the whole step's
# detector products: A (M, K) bf16 in depth chunks of DENSE_DEPTH columns,
# B (K, N) bf16 in boxes of 64 columns, one of SLAB_TILES per call.
DENSE_DEPTH = 64


def plan_dense_gemm(m: int, n: int, sms: int = H100_SMS) -> SlabPlan:
    """The tile of one dense-GEMM launch over M rows and N columns, by
    plan_slab_gemm's rule: the largest tile whose grid has a block for
    every SM, else the one with the most blocks.  The grid is (column
    tiles, row tiles, 1): the clips' rows are stacked."""
    plans = [SlabPlan(bm, bn, (n // bn, -(-m // bm), 1)) for bm, bn in SLAB_TILES if n % bn == 0]
    if not plans:
        raise ValueError(f"the dense GEMM needs N % 64 == 0 (got {n})")
    return next((pl for pl in plans if pl.blocks >= sms), max(plans, key=lambda pl: pl.blocks))


def check_dense_gemm(a: torch.Tensor, b: torch.Tensor, m: int, k: int, n: int) -> None:
    """What the dense GEMM's tensor maps and tiles cannot take: raise.
    ``a`` holds the (m, k) bf16 A operand at its start, ``b`` is the (k, n)
    bf16 weight; both contiguous."""
    if k % DENSE_DEPTH or n % 64:
        raise ValueError(f"the dense GEMM needs K % {DENSE_DEPTH} == 0 and N % 64 == 0 "
                         f"(got K={k}, N={n})")
    if m < 1 or a.numel() < m * k or tuple(b.shape) != (k, n):
        raise ValueError(f"the dense GEMM needs an (M, K) A with M >= 1 and a (K, N) B "
                         f"(got M={m}, K={k}, N={n}, A of {a.numel()}, B {tuple(b.shape)})")
    for name, x in (("A", a), ("B", b)):
        if x.dtype != _BF16:
            raise TypeError(f"the dense GEMM needs {name} in bf16 (got {x.dtype})")
        if x.data_ptr() % 16:
            raise ValueError(f"the dense GEMM needs {name} 16-byte aligned "
                             f"(at {x.data_ptr():#x})")


class StepGemm(typing.NamedTuple):
    """One GEMM of the sm90 chains (the whole step's 14, and its parts'):
    a slab GEMM over B clips (``rows`` output rows per clip, depth ``k``
    per slab) or a dense one (``rows`` = the B clips' rows stacked, depth
    ``k``); ``n`` output columns."""

    name: str
    kind: str  # "slab" or "dense"
    rows: int
    k: int
    n: int


def plan_gemms(gemms: list, b: int, sms: int) -> list:
    """The planned tile of each of ``gemms`` on a card of ``sms`` SMs."""
    return [plan_slab_gemm(b, g.rows, g.n, sms) if g.kind == "slab"
            else plan_dense_gemm(g.rows, g.n, sms) for g in gemms]


def tile_array(plans: list):
    """Planned tiles as the host array of (bm, bn) pairs the C entries take."""
    pairs = [x for pl in plans for x in (pl.bm, pl.bn)]
    return (ctypes.c_int * len(pairs))(*pairs)


def check_weights_aligned(gemms: list, weights: list) -> None:
    """Each GEMM's weight as its tensor map takes it: TMA's 16-byte
    address alignment; raise otherwise."""
    for g, w in zip(gemms, weights):
        if w.data_ptr() % 16:
            raise ValueError(f"the {g.name} GEMM needs its weight 16-byte aligned "
                             f"(at {w.data_ptr():#x})")


PART_LD = 4096     # floats of one clip's partial sums (csrc/chain_sm90.cuh kPartLd)
FOLD_CHUNK = 4096  # samples of one block of the fold and scalar stages (kFoldChunk)


def _check_fold(t: int, hop: int) -> None:
    """The synthesis VJP's (T-1) hop samples a clip within its partial
    sums' room (3 floats per chunk); raise otherwise."""
    if (t - 1) * hop > FOLD_CHUNK * (PART_LD // 3):
        raise ValueError(f"the sm90 chains' partial sums need (T-1) hop <= "
                         f"{FOLD_CHUNK * (PART_LD // 3)} (got T={t}, hop={hop})")


def synth_gemm(t: int, p: int, hop: int) -> StepGemm:
    """The synthesis's slab GEMM (the sm90 step's first): reim (B, T, 2P)
    -> u (B, T-1, hop)."""
    return StepGemm("synthesis", "slab", t - 1, 2 * p, hop)


def synth_vjp_gemm(t: int, p: int, hop: int) -> StepGemm:
    """The synthesis VJP's slab GEMM (the sm90 step's last): gcrop (B,
    T-1, hop) -> dreim (B, T, 2P)."""
    return StepGemm("synthesis VJP", "slab", t, hop, 2 * p)


@functools.lru_cache(maxsize=64)
def synth_fwd_tiles(b: int, t: int, p: int, hop: int, sms: int):
    """The synthesis GEMM's planned tile, as the host array of one (bm, bn)
    pair aw_synth_norm_fwd takes: the step's own."""
    return tile_array(plan_gemms([synth_gemm(t, p, hop)], b, sms))


@functools.lru_cache(maxsize=64)
def synth_bwd_tiles(b: int, t: int, p: int, hop: int, sms: int):
    """The synthesis-VJP GEMM's planned tile, as aw_synth_norm_bwd takes it:
    the step's own."""
    return tile_array(plan_gemms([synth_vjp_gemm(t, p, hop)], b, sms))


def _run(entry: str, device: torch.device, *args) -> None:
    """Launch a C entry on ``device``'s current stream; raise on its error."""
    from aware_tpu_torch.ops.kernels.build import build

    fn = getattr(build().lib, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def _check_frames(t: int) -> None:
    if t < 2:
        raise ValueError(f"synth_norm needs T >= 2 frames (got {t})")


def check_synth_norm_fwd(coeffs, csin, y_const, env, ab) -> tuple:
    """What the sm90 synthesis cannot take: raise, before any launch.  The
    geometry, T >= 2, every operand's device, dtype, shape and layout, and
    the weight as its tensor map takes it.  Returns (B, T, P, hop)."""
    b, t, p = coeffs.shape
    hop = env.shape[-1]
    dev = coeffs.device
    _check_geometry(p, hop, ab.shape[-1])
    _check_frames(t)
    _check("coeffs", coeffs, (b, t, p), torch.float32, dev)
    _check("csin", csin, (b, t, 2 * p), _BF16, dev)
    _check("y_const", y_const, (b, t - 1, hop), torch.float32, dev)
    _check("env", env, (t - 1, hop), torch.float32, dev)
    _check("ab", ab, (2 * p, R * hop), _BF16, dev)
    check_weights_aligned([synth_gemm(t, p, hop)], [ab])
    return b, t, p, hop


def check_synth_norm_bwd(g, y2, m1, csin, env, abt) -> tuple:
    """What the sm90 synthesis VJP cannot take: raise, before any launch.
    As ``check_synth_norm_fwd``, and the partial sums' room for the
    peak-norm VJP's scalars.  Returns (B, T, P, hop)."""
    b, lr, hop = g.shape
    t = lr + 1
    p = csin.shape[-1] // 2
    dev = g.device
    _check_geometry(p, hop, abt.shape[0])
    _check_frames(t)
    _check("g", g, (b, lr, hop), torch.float32, dev)
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    _check("m1", m1, (b,), torch.float32, dev)
    _check("csin", csin, (b, t, 2 * p), _BF16, dev)
    _check("env", env, (lr, hop), torch.float32, dev)
    _check("abt", abt, (R * hop, 2 * p), _BF16, dev)
    _check_fold(t, hop)
    check_weights_aligned([synth_vjp_gemm(t, p, hop)], [abt])
    return b, t, p, hop


def _synth_launch(entry: str, coeffs, csin, y_const, env, ab):
    """Run ``aw_synth_norm_fwd`` or ``aw_synth_u`` (its first two launches)
    on the planned tile, after every check -> (y2 or u, m1)."""
    b, t, p, hop = check_synth_norm_fwd(coeffs, csin, y_const, env, ab)
    dev = coeffs.device
    reim = torch.empty(b, t, 2 * p, device=dev)
    check_slab_gemm(reim, ab, hop, t - 1)
    out = torch.empty(b, t - 1, hop, device=dev)
    m1 = torch.empty(b, device=dev)
    tiles = synth_fwd_tiles(b, t, p, hop, _sms(dev.index or 0))
    _run(entry, dev, coeffs, csin, y_const, env, ab, reim, out, m1, tiles, len(tiles), b, t, p,
         hop)
    return out, m1


def synth_norm_fwd(coeffs, csin, y_const, env, ab):
    """Synthesis + double peak-norm: (y2, m1), the sm90 step's synthesis
    (``aw_synth_norm_fwd``: reim, the slab GEMM, the scale; 3 launches).
    Replaces the TPU kernel ``_synth_kernel``
    (aware_tpu/ops/pallas/roundtrip.py:179)."""
    if coeffs.device.type == "cpu":
        return synth_norm_fwd_plain(coeffs, csin, y_const, env, ab)
    out = _synth_launch("aw_synth_norm_fwd", coeffs, csin, y_const, env, ab)
    synth_norm_fwd.launches += 1
    return out


def _synth_u(coeffs, csin, y_const, env, ab):
    """The forward's first two launches alone (``aw_synth_u``: the step's
    synthesis) -> (u, m1), for the chip check against the step's forward
    half.  Not counted in ``synth_norm_fwd.launches``."""
    return _synth_launch("aw_synth_u", coeffs, csin, y_const, env, ab)


def _synth_norm_fwd_wmma(coeffs, csin, y_const, env, ab):
    """The forward's first version, ``aw_synth_norm_fwd_wmma`` (the WMMA
    template), on the CUDA tensors ``synth_norm_fwd`` takes: no path
    reaches it; the chip check times it beside the sm90 entry.  Not
    counted in ``synth_norm_fwd.launches``."""
    b, t, p, hop = check_synth_norm_fwd(coeffs, csin, y_const, env, ab)
    dev = coeffs.device
    y2 = torch.empty(b, t - 1, hop, device=dev)
    m1 = torch.empty(b, device=dev)
    max_bits = torch.empty(b, dtype=torch.int32, device=dev)
    _run("aw_synth_norm_fwd_wmma", dev, coeffs, csin, y_const, env, ab, y2, m1, max_bits,
         b, t, p, hop)
    return y2, m1


def synth_norm_bwd(g, y2, m1, csin, env, abt):
    """VJP of the synthesis w.r.t. coeffs, the sm90 step's synthesis VJP
    on y2 itself (``aw_synth_norm_bwd``: the peak-norm VJP's scalars,
    gcrop, the slab GEMM, the phase fold; 5 launches).  Replaces
    ``_synth_bwd_kernel`` (aware_tpu/ops/pallas/roundtrip.py:223)."""
    if g.device.type == "cpu":
        return synth_norm_bwd_plain(g, y2, m1, csin, env, abt)
    b, t, p, hop = check_synth_norm_bwd(g, y2, m1, csin, env, abt)
    dev = g.device
    gcrop = torch.empty(b, t - 1, hop, device=dev)
    check_slab_gemm(gcrop, abt, 2 * p, t)
    dcoeffs = torch.empty(b, t, p, device=dev)
    dreim = torch.empty(b, t, 2 * p, device=dev)
    part = torch.empty(b, PART_LD, device=dev)
    scal = torch.empty(b, 4, device=dev)
    tiles = synth_bwd_tiles(b, t, p, hop, _sms(dev.index or 0))
    _run("aw_synth_norm_bwd", dev, g, y2, m1, csin, env, abt, dcoeffs, dreim, gcrop, part, scal,
         tiles, len(tiles), b, t, p, hop)
    synth_norm_bwd.launches += 1
    return dcoeffs


def _synth_norm_bwd_wmma(g, y2, m1, csin, env, abt):
    """The VJP's first version, ``aw_synth_norm_bwd_wmma`` (the WMMA
    template), on the CUDA tensors ``synth_norm_bwd`` takes: no path
    reaches it; the chip check times it beside the sm90 entry.  Not
    counted in ``synth_norm_bwd.launches``."""
    b, t, p, hop = check_synth_norm_bwd(g, y2, m1, csin, env, abt)
    dev = g.device
    dcoeffs = torch.empty(b, t, p, device=dev)
    dreim = torch.empty(b, t, 2 * p, device=dev)
    scal = torch.empty(b, 4, device=dev)
    _run("aw_synth_norm_bwd_wmma", dev, g, y2, m1, csin, env, abt, dcoeffs, dreim, scal,
         b, t, p, hop)
    return dcoeffs


def band_analysis_fwd(y2, csw):
    """Zero-pad framing + analysis DFT: cs2, on the sm90 slab GEMM.
    Replaces ``_analysis_kernel`` (aware_tpu/ops/pallas/roundtrip.py:254)."""
    if y2.device.type == "cpu":
        return band_analysis_fwd_plain(y2, csw)
    b, lr, hop = y2.shape
    p2 = csw.shape[-1]
    dev = y2.device
    _check_geometry(p2 // 2, hop, csw.shape[0])
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    _check("csw", csw, (R * hop, p2), _BF16, dev)
    check_slab_gemm(y2, csw, p2, lr + 1)
    plan = slab_plan_for(y2, lr + 1, p2)
    cs2 = torch.empty(b, lr + 1, p2, device=dev)
    _run("aw_band_analysis_fwd", dev, y2, csw, cs2, b, lr + 1, p2, hop, plan.bm, plan.bn)
    band_analysis_fwd.launches += 1
    return cs2


def band_analysis_bwd(g, cswt):
    """VJP of the analysis w.r.t. y2, on the sm90 slab GEMM.  Replaces
    ``_analysis_bwd_kernel`` (aware_tpu/ops/pallas/roundtrip.py:281)."""
    if g.device.type == "cpu":
        return band_analysis_bwd_plain(g, cswt)
    b, t, p2 = g.shape
    hop = cswt.shape[-1] // R
    dev = g.device
    _check_geometry(p2 // 2, hop, cswt.shape[-1])
    _check("g", g, (b, t, p2), torch.float32, dev)
    _check("cswt", cswt, (p2, R * hop), _BF16, dev)
    check_slab_gemm(g, cswt, hop, t - 1)
    plan = slab_plan_for(g, t - 1, hop)
    gy2 = torch.empty(b, t - 1, hop, device=dev)
    _run("aw_band_analysis_bwd", dev, g, cswt, gy2, b, t, p2, hop, plan.bm, plan.bn)
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
