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

Both take any frame geometry with n_fft = r hop, the r slabs and the
pad = r // 2 rows of centre crop read off the shapes as the TPU kernel
reads them (``aware_tpu/ops/pallas/ola_norm.py:60-61``, ``:81-82``): r = 4
on the default card, 2 at n_fft 1024 / hop 512, 8 at 2048 / 256; hop need
only be a multiple of 4 for the cluster variant (192 at 768 / 192).  Where
hop does not divide n_fft, or (n_fft / 2), the TPU kernel's whole-row crop
cannot be the centred STFT's (it returns NaN at 1024 / 200): ``slabs``
raises there.

Each direction has two CUDA variants, one launch each in the plan's
choice (``ola_plan``, from the shapes alone): "cluster", one thread-block
cluster per clip whose CTAs hold the clip's rows in shared memory and
finish its reductions through distributed shared memory
(``aw_ola_fwd_cluster``, ``aw_ola_bwd_cluster``), where the rows fit the
cluster's shared memory (the 10 s clips); "stream", blocks that share
nothing and meet between launches in device memory
(``aw_ola_fwd_stream``, ``aw_ola_bwd_stream``), past it (the 60 s clips).

Each has a wrapper that checks its operands, launches on the current
stream and counts the launch in its ``launches`` attribute and by variant
in ``variants`` (given CPU tensors it runs the plain version instead; on a
CUDA tensor it launches the kernel or raises), and a plain PyTorch
version (``*_plain``) that follows the TPU kernel's formulas line by line,
not autograd of the chain: the slice adds in k = 0..r-1 order, the
collapsed scale c = (m1 + e)(m1 / (m1 + e) + e), and the VJP's tie split
over y2's own maxima (``aware_tpu/ops/pallas/ola_norm.py:84-107``).
``ola_normalize`` is the ``torch.autograd.Function`` the "ola" solver path
differentiates through.
"""

from __future__ import annotations

import functools
import typing

import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.kernels.roundtrip import _check, _run

_EPS = 1e-8
R = 4      # slabs, n_fft / hop, on the default card (1024 / 256)
PAD = 2    # rows of centre crop, (n_fft / 2) / hop, there
CHUNK = 1024  # elements per block of the stream variant (csrc/ola_norm.cu kChunk)


def slabs(n_fft: int, hop: int) -> tuple[int, int]:
    """(r, pad): the slabs n_fft / hop and the rows (n_fft / 2) / hop of
    centre crop of a frame geometry; raise where hop divides neither."""
    if n_fft % hop or (n_fft // 2) % hop:
        raise ValueError(
            f"ola_normalize needs hop to divide n_fft and n_fft / 2 (got n_fft={n_fft}, "
            f"hop={hop}): its whole-row centre crop is the STFT's only there, and the JAX "
            "package's kernel returns NaN at n_fft % hop != 0")
    return n_fft // hop, n_fft // 2 // hop


def _scale(m1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(c, n) of the collapsed double peak-norm, per clip (B, 1, 1)."""
    m1 = m1[:, None, None]
    c1 = m1 + _EPS
    n = m1 / c1
    return c1 * (n + _EPS), n


# ---------------------------------------------------------- plain versions ---

def ola_normalize_fwd_plain(wframes: torch.Tensor, env: torch.Tensor):
    """wframes (B, T, r*hop) -> (y2 (B, T-1, hop), m1 (B,))."""
    b, t, n_fft = wframes.shape
    hop = env.shape[-1]
    r, pad = slabs(n_fft, hop)
    acc = wframes.new_zeros(b, t + r - 1, hop)
    for k in range(r):
        acc[:, k : k + t] += wframes[..., k * hop : (k + 1) * hop]
    y_env = acc[:, pad : pad + t - 1] / env
    m1 = y_env.abs().amax(dim=(1, 2))
    return y_env / _scale(m1)[0], m1


def ola_normalize_bwd_plain(g, y2, env, m1, n_fft: int | None = None):
    """VJP of :func:`ola_normalize_fwd_plain` w.r.t. wframes, from its y2
    and m1: g (B, T-1, hop) -> (B, T, n_fft) (n_fft 4 hop where not given)."""
    b, lr, hop = g.shape
    t = lr + 1
    r, pad = slabs(n_fft or R * hop, hop)
    c, n = _scale(m1)
    q = (g * y2).sum(dim=(1, 2))[:, None, None]
    p = (n + _EPS) * q
    k_coef = p * (_EPS + c) / (c * c)
    # the tie mask from y2 itself: y2 * c would round and could match nothing
    a = y2.abs()
    mask = (a == a.amax(dim=(1, 2), keepdim=True)).float()
    ties = mask.sum(dim=(1, 2))[:, None, None]
    g_env = g / c - k_coef * torch.sign(y2) * mask / ties
    grows = F.pad(g_env / env, (0, 0, pad, r - pad))  # (B, T+r-1, hop)
    return torch.cat([grows[:, k : k + t] for k in range(r)], dim=-1)


# -------------------------------------------------------------------- plan ---

SMEM_LIMIT = 232448   # shared memory a CTA may take on sm_90 (the opt-in maximum)
CLUSTER_STATIC = 512  # bytes of the cluster kernels' static shared memory, at most
CLUSTER_THREADS = 1024  # threads of a CTA of the cluster variant (csrc/ola_norm.cu kClusterThreads)
CLUSTER_SIZES = (8, 16)
CLUSTER = 8  # CTAs a clip (csrc/ola_norm.cu header: why this size)


class OlaPlan(typing.NamedTuple):
    """How one (B, T, hop) runs, both directions: the variant ("cluster"
    where a CTA's rows fit its shared memory, else "stream"), the cluster
    size, each CTA's (start, stop) of the T-1 rows of y_env (of g and y2)
    and of the T+3 rows of grows that the VJP writes, and the dynamic
    shared memory a CTA takes, in bytes (its rows of y_env, or of y2)."""

    variant: str
    cluster: int
    rows: tuple
    grows: tuple
    smem: int


@functools.lru_cache(maxsize=64)
def ola_plan(b: int, t: int, hop: int, cluster: int = CLUSTER, r: int = R) -> OlaPlan:
    """The plan of a launch on B clips of T frames and r slabs: from the
    shapes alone.  CTA k owns rows [k lr // C, (k + 1) lr // C) (as
    csrc/ola_norm.cu cta_rows), and the grows rows pad = r // 2 further
    on, the first CTA also the centre crop's leading zero rows, the last
    its trailing ones."""
    lr = t - 1
    pad = r // 2
    rows = tuple((k * lr // cluster, (k + 1) * lr // cluster) for k in range(cluster))
    grows = tuple((0 if k == 0 else s + pad, t + r - 1 if k == cluster - 1 else e + pad)
                  for k, (s, e) in enumerate(rows))
    smem = -(-lr // cluster) * hop * 4  # bytes of a CTA's rows, at most
    fits = smem + CLUSTER_STATIC <= SMEM_LIMIT and hop % 4 == 0
    return OlaPlan("cluster" if fits else "stream", cluster, rows, grows, smem)


# ---------------------------------------------------------------- wrappers ---

def _check_frames(t: int) -> None:
    if t < 2:
        raise ValueError(f"CUDA ola_normalize needs T >= 2 frames (got {t})")


def _check_aligned(**tensors) -> None:
    """The cluster variant's 16-byte loads and stores."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"the cluster ola_normalize needs {name} 16-byte aligned "
                             f"(at {x.data_ptr():#x})")


def check_ola_fwd(wframes, env) -> tuple:
    """What the forward kernels cannot take: raise, before any launch.
    Returns (B, T, hop)."""
    b, t, n_fft = wframes.shape
    hop = env.shape[-1]
    dev = wframes.device
    slabs(n_fft, hop)
    _check_frames(t)
    _check("wframes", wframes, (b, t, n_fft), torch.float32, dev)
    _check("env", env, (t - 1, hop), torch.float32, dev)
    return b, t, hop


def check_ola_bwd(g, y2, env, m1, n_fft: int) -> tuple:
    """What the VJP kernels cannot take: raise, before any launch.
    Returns (B, T, hop)."""
    b, lr, hop = g.shape
    dev = g.device
    slabs(n_fft, hop)
    _check_frames(lr + 1)
    _check("g", g, (b, lr, hop), torch.float32, dev)
    _check("y2", y2, (b, lr, hop), torch.float32, dev)
    _check("env", env, (lr, hop), torch.float32, dev)
    _check("m1", m1, (b,), torch.float32, dev)
    return b, lr + 1, hop


def _fwd_launch(wframes, env, variant: str, plan: OlaPlan):
    """One launch of the forward's ``variant`` on checked operands."""
    b, t, n_fft = wframes.shape
    hop = env.shape[-1]
    r, pad = slabs(n_fft, hop)
    dev = wframes.device
    y2 = torch.empty(b, t - 1, hop, device=dev)
    m1 = torch.empty(b, device=dev)
    if variant == "cluster":
        if plan.variant != "cluster":
            raise ValueError(f"T={t} frames of hop {hop} do not fit a cluster of {plan.cluster}")
        _check_aligned(wframes=wframes, env=env)
        _run("aw_ola_fwd_cluster", dev, wframes, env, y2, m1, b, t, hop, r, pad, plan.cluster)
    else:
        _run("aw_ola_fwd_stream", dev, wframes, env, y2, m1, b, t, hop, r, pad)
    return y2, m1


def _bwd_launch(g, y2, env, m1, n_fft: int, variant: str, plan: OlaPlan):
    """One launch of the VJP's ``variant`` on checked operands."""
    b, lr, hop = g.shape
    r, pad = slabs(n_fft, hop)
    dev = g.device
    dwf = torch.empty(b, lr + 1, n_fft, device=dev)
    if variant == "cluster":
        if plan.variant != "cluster":
            raise ValueError(f"T={lr + 1} frames of hop {hop} do not fit a cluster of "
                             f"{plan.cluster}")
        _check_aligned(g=g, y2=y2, env=env)
        _run("aw_ola_bwd_cluster", dev, g, y2, env, m1, dwf, b, lr + 1, hop, r, pad,
             plan.cluster)
    else:
        part = torch.empty(b, -(-lr * hop // CHUNK), 2, device=dev)
        scal = torch.empty(b, 2, device=dev)
        ties = torch.empty(b, dtype=torch.int32, device=dev)
        _run("aw_ola_bwd_stream", dev, g, y2, env, m1, part, scal, ties, dwf, b, lr + 1, hop,
             r, pad)
    return dwf


def ola_normalize_fwd(wframes, env):
    """OLA + crop + envelope + double peak-norm: (y2, m1), one launch of
    the planned variant.  Replaces ``_fwd_kernel``
    (aware_tpu/ops/pallas/ola_norm.py:135)."""
    if wframes.device.type == "cpu":
        return ola_normalize_fwd_plain(wframes, env)
    b, t, hop = check_ola_fwd(wframes, env)
    plan = ola_plan(b, t, hop, r=wframes.shape[-1] // hop)
    out = _fwd_launch(wframes, env, plan.variant, plan)
    ola_normalize_fwd.launches += 1
    ola_normalize_fwd.variants[plan.variant] += 1
    return out


def ola_normalize_bwd(g, y2, env, m1, n_fft: int | None = None):
    """VJP w.r.t. the frames (B, T, n_fft; n_fft 4 hop where not given),
    one launch of the planned variant.  Replaces ``_bwd_kernel``
    (aware_tpu/ops/pallas/ola_norm.py:167)."""
    n_fft = n_fft or R * g.shape[-1]
    if g.device.type == "cpu":
        return ola_normalize_bwd_plain(g, y2, env, m1, n_fft)
    b, t, hop = check_ola_bwd(g, y2, env, m1, n_fft)
    plan = ola_plan(b, t, hop, r=n_fft // hop)
    out = _bwd_launch(g, y2, env, m1, n_fft, plan.variant, plan)
    ola_normalize_bwd.launches += 1
    ola_normalize_bwd.variants[plan.variant] += 1
    return out


def _ola_fwd_variant(wframes, env, variant: str, cluster: int = CLUSTER):
    """The forward's ``variant`` (at ``cluster`` CTAs a clip), whatever the
    plan picks, on the CUDA tensors ``ola_normalize_fwd`` takes: for the
    chip check, which holds the variants against each other and times
    them in turns.  Not counted."""
    b, t, hop = check_ola_fwd(wframes, env)
    plan = ola_plan(b, t, hop, cluster, wframes.shape[-1] // hop)
    return _fwd_launch(wframes, env, variant, plan)


def _ola_bwd_variant(g, y2, env, m1, variant: str, cluster: int = CLUSTER,
                     n_fft: int | None = None):
    """The VJP's ``variant``, as :func:`_ola_fwd_variant` (n_fft 4 hop
    where not given).  Not counted."""
    n_fft = n_fft or R * g.shape[-1]
    b, t, hop = check_ola_bwd(g, y2, env, m1, n_fft)
    return _bwd_launch(g, y2, env, m1, n_fft, variant, ola_plan(b, t, hop, cluster, n_fft // hop))


KERNELS = (ola_normalize_fwd, ola_normalize_bwd)
VARIANTS = ("cluster", "stream")


def reset_launches() -> None:
    """Every count to 0: each wrapper's ``launches`` and its launches by
    variant (``variants``)."""
    for k in KERNELS:
        k.launches = 0
        k.variants = dict.fromkeys(VARIANTS, 0)


reset_launches()


# ------------------------------------------------------------ autograd op ---

class _OlaNormalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wframes, env):
        y2, m1 = ola_normalize_fwd(wframes, env)
        ctx.save_for_backward(y2, env, m1)
        ctx.n_fft = wframes.shape[-1]
        return y2

    @staticmethod
    def backward(ctx, g):
        y2, env, m1 = ctx.saved_tensors
        return ola_normalize_bwd(g.contiguous(), y2, env, m1, ctx.n_fft), None


def ola_normalize(wframes, env):
    """Windowed frames (B, T, n_fft) -> doubly peak-normalized signal rows
    (B, T-1, hop), differentiable w.r.t. the frames."""
    return _OlaNormalize.apply(wframes, env)
