"""The frames round trip's kernel: ola_normalize, forward and VJP.

The port of ``aware_tpu/ops/pallas/ola_norm.py``: overlap-add of the
windowed ISTFT frames -> centre crop -> envelope division -> the double
peak-norm collapsed into one scale, and its tie-splitting VJP.  Both TPU
kernels are CUDA entries of ``csrc/ola_norm.cu``, natively batched over the
clip (the formulas are in its header):

* ``ola_normalize_fwd`` (``_fwd_kernel``): wframes (B, T, n_fft) f32 and
  env (T-1, hop) f32 -> y2 (B, T-1, hop) f32 and m1 (B,) f32;
* ``ola_normalize_bwd`` (``_bwd_kernel``): g and y2 (B, T-1, hop), env
  and m1 -> dwframes (B, T, n_fft) f32.

Each has a wrapper that checks its operands, launches on the current
stream and counts the launch in its ``launches`` attribute (given CPU
tensors it runs the plain version instead; on a CUDA tensor it launches
the kernel or raises), and a plain PyTorch version (``*_plain``) that
follows the TPU kernel's formulas line by line, not autograd of the
chain: the slice adds in k = 0..3 order, the collapsed scale
c = (m1 + e)(m1 / (m1 + e) + e), and the VJP's tie split over y2's own
maxima (``aware_tpu/ops/pallas/ola_norm.py:84-107``).  ``ola_normalize``
is the ``torch.autograd.Function`` the "ola" solver path differentiates
through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.kernels.roundtrip import _check, _run

_EPS = 1e-8
R = 4      # slabs: n_fft / hop
PAD = 2    # rows of centre crop: (n_fft / 2) / hop
CHUNK = 1024  # elements per block of the CUDA kernels (csrc/ola_norm.cu kChunk)


def _scale(m1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(c, n) of the collapsed double peak-norm, per clip (B, 1, 1)."""
    m1 = m1[:, None, None]
    c1 = m1 + _EPS
    n = m1 / c1
    return c1 * (n + _EPS), n


# ---------------------------------------------------------- plain versions ---

def ola_normalize_fwd_plain(wframes: torch.Tensor, env: torch.Tensor):
    """wframes (B, T, R*hop) -> (y2 (B, T-1, hop), m1 (B,))."""
    b, t, n_fft = wframes.shape
    hop = n_fft // R
    acc = wframes.new_zeros(b, t + R - 1, hop)
    for k in range(R):
        acc[:, k : k + t] += wframes[..., k * hop : (k + 1) * hop]
    y_env = acc[:, PAD : PAD + t - 1] / env
    m1 = y_env.abs().amax(dim=(1, 2))
    return y_env / _scale(m1)[0], m1


def ola_normalize_bwd_plain(g, y2, env, m1):
    """VJP of :func:`ola_normalize_fwd_plain` w.r.t. wframes, from its y2
    and m1: g (B, T-1, hop) -> (B, T, R*hop)."""
    b, lr, hop = g.shape
    t = lr + 1
    c, n = _scale(m1)
    q = (g * y2).sum(dim=(1, 2))[:, None, None]
    p = (n + _EPS) * q
    k_coef = p * (_EPS + c) / (c * c)
    # the tie mask from y2 itself: y2 * c would round and could match nothing
    a = y2.abs()
    mask = (a == a.amax(dim=(1, 2), keepdim=True)).float()
    ties = mask.sum(dim=(1, 2))[:, None, None]
    g_env = g / c - k_coef * torch.sign(y2) * mask / ties
    grows = F.pad(g_env / env, (0, 0, PAD, R - PAD))  # (B, T+3, hop)
    return torch.cat([grows[:, k : k + t] for k in range(R)], dim=-1)


# ---------------------------------------------------------------- wrappers ---

def _check_hop(n_fft: int, hop: int) -> None:
    if n_fft != R * hop:
        raise ValueError(f"CUDA ola_normalize needs n_fft == 4 * hop (got {n_fft}, {hop})")


def ola_normalize_fwd(wframes, env):
    """OLA + crop + envelope + double peak-norm: (y2, m1).  Replaces
    ``_fwd_kernel`` (aware_tpu/ops/pallas/ola_norm.py:135)."""
    if wframes.device.type == "cpu":
        return ola_normalize_fwd_plain(wframes, env)
    b, t, n_fft = wframes.shape
    hop = env.shape[-1]
    dev = wframes.device
    _check_hop(n_fft, hop)
    _check("wframes", wframes, (b, t, n_fft), torch.float32, dev)
    _check("env", env, (t - 1, hop), torch.float32, dev)
    y2 = torch.empty(b, t - 1, hop, device=dev)
    m1 = torch.empty(b, device=dev)
    _run("aw_ola_fwd", dev, wframes, env, y2, m1, b, t, hop)
    ola_normalize_fwd.launches += 1
    return y2, m1


def ola_normalize_bwd(g, y2, env, m1):
    """VJP w.r.t. the frames.  Replaces ``_bwd_kernel``
    (aware_tpu/ops/pallas/ola_norm.py:167)."""
    if g.device.type == "cpu":
        return ola_normalize_bwd_plain(g, y2, env, m1)
    b, lr, hop = g.shape
    dev = g.device
    _check("g", g, (b, lr, hop), torch.float32, dev)
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    _check("env", env, (lr, hop), torch.float32, dev)
    _check("m1", m1, (b,), torch.float32, dev)
    part = torch.empty(b, -(-lr * hop // CHUNK), 2, device=dev)
    scal = torch.empty(b, 2, device=dev)
    ties = torch.empty(b, dtype=torch.int32, device=dev)
    dwf = torch.empty(b, lr + 1, R * hop, device=dev)
    _run("aw_ola_bwd", dev, g, y2, env, m1, part, scal, ties, dwf, b, lr + 1, hop)
    ola_normalize_bwd.launches += 1
    return dwf


KERNELS = (ola_normalize_fwd, ola_normalize_bwd)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ------------------------------------------------------------ autograd op ---

class _OlaNormalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wframes, env):
        y2, m1 = ola_normalize_fwd(wframes, env)
        ctx.save_for_backward(y2, env, m1)
        return y2

    @staticmethod
    def backward(ctx, g):
        y2, env, m1 = ctx.saved_tensors
        return ola_normalize_bwd(g.contiguous(), y2, env, m1), None


def ola_normalize(wframes, env):
    """Windowed frames (B, T, n_fft) -> doubly peak-normalized signal rows
    (B, T-1, hop), differentiable w.r.t. the frames."""
    return _OlaNormalize.apply(wframes, env)
