"""The long-clip round trip's kernels: shift_mm and the synth_norm_tiled forward.

The port of ``aware_tpu/ops/pallas/roundtrip_tiled.py``, the JAX package's
round trip for clips over 1024 frames.  Both TPU kernels are CUDA entries
on the sm90 slab GEMM (``csrc/slab_gemm_sm90.cuh``: TMA and wgmma),
natively batched over the clip: ``shift_mm`` of ``csrc/slab_gemm_sm90.cu``,
the synthesis of ``csrc/roundtrip_tiled.cu`` (a pass that writes the f32
phase products, then one slab GEMM whose epilogue divides by env, adds
y_const and takes m1 by the tail rule):

* ``shift_mm`` (``_shift_mm_kernel``): out[b, t] = sum_{o<4} bf16(x[b, t+o]) @ w[o]
  for t < n_out, x (B, N, D) f32 with rows at or past N read as zero,
  w (4, D, E) bf16.  Every other direction of the round trip is one of
  its three uses: the analysis forward (``w_af``), the analysis VJP
  (``w_ab``) and the synthesis VJP (``w_sb``);
* ``synth_tiled_fwd`` (``_synth_tiled_kernel``): with ctp = ct padded by
  one zero row before and two after (row m+1 is frame m),
  u[j] = sum_{o<4} bf16(ctp[j+o] * csinp[j+o]) @ w_sf[o], the Re and Im
  halves side by side along the 2P depth, then u = u / env + y_const and
  m1 = max |u| (the tail rule below).  The peak-norm scale and its VJP
  are torch ops, as they are XLA ops in the JAX package.

Each has a wrapper that checks its operands, plans its slab GEMM's tile
(``slab_plan_for``), launches on the current stream and counts the launch
in its ``launches`` attribute (given CPU tensors it runs the plain version
instead; on a CUDA tensor it launches the kernel or raises), and a plain
PyTorch version (``*_plain``) with the same bf16 rounding of the product
operands and float32 accumulation.  Their first WMMA versions stay in the
library as ``aw_shift_mm_wmma`` and ``aw_synth_tiled_fwd_wmma``, which no
wrapper reaches (``chip_smoke.py`` times each pair in turns).

``csinp`` is float32 on this path (``make_csinp``): the product with the
coefficients is rounded to bf16, never the phase itself, unlike the
whole-clip path's bf16 ``csin``.

**The m1 tail rows, a property of the reference that the port carries.**
The TPU kernel takes the running max over whole 256-row tiles, and pads
the last tile's env with 1 and y_const with 0.  Rows lr = T-1 and lr+1
still hold the overlap-add tail of the last two frames (the right-hand
part that the centre crop drops), so they enter m1 undivided by the
envelope, though u, which stops at row lr, does not hold them.  Both
versions here take m1 over the first ``m1_rows(lr)`` = min(ceil(lr / 256)
* 256, lr + 2) rows, the rows from lr on with env 1 and y_const 0.  The
VJP stays the reference's: its ties come from y2's own lr rows.

The TPU kernels' 256-frame grid with its 8-row DMA halo and their
``custom_vmap`` batching are TPU artifacts and are not ported: a CUDA block
reads device memory directly.  ``TILE`` is kept only for the tail rule.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.kernels.roundtrip import (
    _bf16,
    _check,
    _check_geometry,
    _run,
    check_slab_gemm,
    peak_den,
    peak_norm_vjp,
    phase_fold_plain,
    slab_plan_for,
)

_BF16 = torch.bfloat16
R = 4          # slabs: n_fft / hop
HALO = R - 1   # rows a window reads past its last output row
TILE = 256     # the TPU kernel's frames per grid step (the m1 tail rule)


def m1_rows(lr: int) -> int:
    """Rows of u whose |u| enter m1: the TPU kernel's whole last tile,
    of which rows past lr + 1 are zero."""
    return min(-(-lr // TILE) * TILE, lr + 2)


def build_tiled_bases(ab_np: np.ndarray, csw_np: np.ndarray, device) -> dict:
    """The per-slab weights of the four directions, stacked (R, D, E) in
    the order each direction reads them, as bf16 tensors on ``device``.

    ab_np: (2P, n_fft) f32 windowed synthesis basis; csw_np: (n_fft, 2P)
    f32 windowed analysis basis (Re rows / columns at [0, nb), Im at
    [P, P + nb))."""
    hop = ab_np.shape[1] // R
    stacks = {
        # synthesis forward: u[t] += reim[t+o] @ ab_cols(R-1-o)
        "w_sf": [ab_np[:, (R - 1 - o) * hop : (R - o) * hop] for o in range(R)],
        # synthesis VJP: dreim[m] += g_up[m+o] @ ab_cols(o)^T
        "w_sb": [ab_np[:, o * hop : (o + 1) * hop].T for o in range(R)],
        # analysis forward: cs2[t] += yp[t+o] @ csw_rows(o)
        "w_af": [csw_np[o * hop : (o + 1) * hop, :] for o in range(R)],
        # analysis VJP: dyp[i] += gp[i+o] @ csw_rows(R-1-o)^T
        "w_ab": [csw_np[(R - 1 - o) * hop : (R - o) * hop, :].T for o in range(R)],
    }
    return {
        k: torch.from_numpy(np.ascontiguousarray(np.stack(v), np.float32)).to(device, _BF16)
        for k, v in stacks.items()
    }


def make_csinp(cos_in: torch.Tensor, sin_in: torch.Tensor, p: int) -> torch.Tensor:
    """In-band phase (B, nb, T) -> the float32 [cos | sin] constant
    (B, T+3, 2P) aligned with the padded coefficient rows: row m+1 holds
    frame m."""
    b, nb, t = cos_in.shape
    csinp = cos_in.new_zeros(b, t + HALO, 2 * p)
    csinp[:, 1 : t + 1, :nb] = cos_in.transpose(1, 2)
    csinp[:, 1 : t + 1, p : p + nb] = sin_in.transpose(1, 2)
    return csinp


# ---------------------------------------------------------- plain versions ---

def shift_mm_plain(x, w, n_out):
    """x (B, N, D) f32, w (R, D, E) bf16 -> (B, n_out, E) f32."""
    n = x.shape[1]
    xb = _bf16(F.pad(x, (0, 0, 0, max(0, n_out + HALO - n)))[:, : n_out + HALO])
    wf = w.float()
    return sum(xb[:, o : o + n_out] @ wf[o] for o in range(R))


def synth_tiled_fwd_plain(ct, csinp, y_const, env, w_sf):
    """ct (B, T, P) -> (u (B, T-1, hop), m1 (B,)), m1 by the tail rule."""
    p = ct.shape[2]
    lr = env.shape[0]
    rows = m1_rows(lr)
    ctp = F.pad(ct, (0, 0, 1, HALO - 1))
    reim = torch.cat([ctp * csinp[..., :p], ctp * csinp[..., p:]], dim=-1)
    acc = shift_mm_plain(reim, w_sf, rows)
    env_x = F.pad(env, (0, 0, 0, rows - lr), value=1.0)
    u = acc / env_x + F.pad(y_const, (0, 0, 0, rows - lr))
    return u[:, :lr].contiguous(), u.abs().amax(dim=(1, 2))


# ---------------------------------------------------------------- wrappers ---

def shift_mm(x, w, n_out):
    """The shifted-slab product, on the sm90 slab GEMM.  Replaces
    ``_shift_mm_kernel`` (aware_tpu/ops/pallas/roundtrip_tiled.py:103)."""
    if x.device.type == "cpu":
        return shift_mm_plain(x, w, n_out)
    b, n, d = x.shape
    e = w.shape[-1]
    dev = x.device
    _check("x", x, (b, n, d), torch.float32, dev)
    _check("w", w, (R, d, e), _BF16, dev)
    check_slab_gemm(x, w, e, n_out)
    plan = slab_plan_for(x, n_out, e)
    out = torch.empty(b, n_out, e, device=dev)
    _run("aw_shift_mm", dev, x, w, out, b, n, d, e, n_out, plan.bm, plan.bn)
    shift_mm.launches += 1
    return out


def check_synth_tiled(ct, csinp, y_const, env, w_sf) -> tuple:
    """What the tiled synthesis's two launches cannot take: raise, before
    any launch.  Returns (B, T, P, hop)."""
    b, t, p = ct.shape
    hop = env.shape[-1]
    dev = ct.device
    _check_geometry(p, hop, R * hop)
    if t < 2:
        raise ValueError(f"the tiled synthesis needs T >= 2 frames (got {t})")
    _check("ct", ct, (b, t, p), torch.float32, dev)
    _check("csinp", csinp, (b, t + HALO, 2 * p), torch.float32, dev)
    _check("y_const", y_const, (b, t - 1, hop), torch.float32, dev)
    _check("env", env, (t - 1, hop), torch.float32, dev)
    _check("w_sf", w_sf, (R, 2 * p, hop), _BF16, dev)
    # the reim pass reads ct and csinp as float4, the GEMM's epilogue
    # y_const and env as float2, its tensor map w_sf
    for name, x, align in (("ct", ct, 16), ("csinp", csinp, 16), ("w_sf", w_sf, 16),
                           ("y_const", y_const, 8), ("env", env, 8)):
        if x.data_ptr() % align:
            raise ValueError(f"the tiled synthesis needs {name} {align}-byte aligned "
                             f"(at {x.data_ptr():#x})")
    return b, t, p, hop


def synth_tiled_fwd(ct, csinp, y_const, env, w_sf):
    """The long-clip synthesis before its peak-norm: (u, m1), the reim pass
    then the slab GEMM.  Replaces ``_synth_tiled_kernel``
    (aware_tpu/ops/pallas/roundtrip_tiled.py:214)."""
    if ct.device.type == "cpu":
        return synth_tiled_fwd_plain(ct, csinp, y_const, env, w_sf)
    b, t, p, hop = check_synth_tiled(ct, csinp, y_const, env, w_sf)
    dev = ct.device
    rows = m1_rows(t - 1)
    reim = torch.empty(b, t, 2 * p, device=dev)
    plan = slab_plan_for(reim, rows, hop)
    u = torch.empty(b, t - 1, hop, device=dev)
    m1 = torch.empty(b, device=dev)
    _run("aw_synth_tiled_fwd", dev, ct, csinp, y_const, env, w_sf, reim, u, m1,
         b, t, p, hop, rows, plan.bm, plan.bn)
    synth_tiled_fwd.launches += 1
    return u, m1


KERNELS = (shift_mm, synth_tiled_fwd)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ autograd ops ---

class _SynthNormTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, csinp, y_const, env, w_sf, w_sb):
        u, m1 = synth_tiled_fwd(ct, csinp, y_const, env, w_sf)
        y2 = u / peak_den(m1)
        ctx.save_for_backward(y2, m1, csinp, env, w_sb)
        return y2

    @staticmethod
    def backward(ctx, g):
        y2, m1, csinp, env, w_sb = ctx.saved_tensors
        t = y2.shape[1] + 1
        g_crop = peak_norm_vjp(g, y2, m1) / env
        dreim = shift_mm(F.pad(g_crop, (0, 0, HALO - 1, 0)), w_sb, t)
        return phase_fold_plain(dreim, csinp[:, 1 : t + 1]), None, None, None, None, None


class _BandAnalysisTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y2, w_af, w_ab):
        ctx.save_for_backward(w_ab)
        return shift_mm(F.pad(y2, (0, 0, HALO - 1, 0)), w_af, y2.shape[1] + 1)

    @staticmethod
    def backward(ctx, g):
        (w_ab,) = ctx.saved_tensors
        lr = g.shape[1] - 1
        dyp = shift_mm(F.pad(g, (0, 0, HALO, 0)), w_ab, lr + HALO)
        return dyp[:, HALO - 1 : HALO - 1 + lr], None, None


def synth_norm_tiled(ct, csinp, y_const, env, w_sf, w_sb):
    """Padded coefficients (B, T, P) -> doubly peak-normalized signal rows
    (B, T-1, hop), differentiable w.r.t. ct."""
    return _SynthNormTiled.apply(ct, csinp, y_const, env, w_sf, w_sb)


def band_analysis_tiled(y2, w_af, w_ab):
    """Signal rows (B, T-1, hop) -> zero-pad-framed in-band Re/Im
    (B, T, 2P), differentiable w.r.t. y2 (the reflect-pad rows are the
    caller's edge corrections)."""
    return _BandAnalysisTiled.apply(y2, w_af, w_ab)
