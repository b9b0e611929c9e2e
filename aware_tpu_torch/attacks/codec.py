"""Differentiable lossy-compression approximation (MP3-style).

The port of ``aware_tpu/attacks/codec.py:47-185`` (``mp3_approx`` and its
helpers): MDCT analysis over 1152-sample granule pairs with a sine window,
a masking threshold from Bark-band spreading pooled into 21 scalefactor
bands, bit-reservoir pressure, a transient gate, the |c|^(3/4) companding
quantizer with straight-through rounding, lame's quality lowpass, and the
TDAC overlap-add synthesis.  Length-preserving and batched over (..., L).

Clips and maxima are ``torch.maximum`` / ``torch.minimum`` against tensors,
which split the gradient at a tie as ``jnp.maximum`` and ``jnp.clip`` do
(``torch.clamp`` would pass all of it).  A coefficient that quantizes to 0
sits on such a tie (``maximum(0, 0)``), and many do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_FRAME = 1152  # MP3 granule-pair size
_HOP = _FRAME // 2
_N_SFB = 21    # Layer-III long-block scalefactor band count

# quality 0 (best) .. 9 (worst) -> noise-floor scale relative to the masking
# threshold; 10 and 11 go beyond lame's range (EOT hardening views)
_QUALITY_SCALE = {
    0: 0.02, 1: 0.035, 2: 0.06, 3: 0.1, 4: 0.17,
    5: 0.28, 6: 0.45, 7: 0.7, 8: 1.1, 9: 1.8,
    10: 3.0, 11: 5.0,
}
# lame's VBR lowpass, as fractions of sr/2
_QUALITY_CUTOFF = {
    0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0, 4: 0.95,
    5: 0.90, 6: 0.85, 7: 0.82, 8: 0.76, 9: 0.70,
    10: 0.62, 11: 0.55,
}


def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi * (np.arange(n) + 0.5) / n).astype(np.float64)


@functools.lru_cache(maxsize=4)
def _mdct_matrix(n: int) -> np.ndarray:
    """(n, n//2) MDCT basis, the sine window included."""
    k = np.arange(n // 2)[None, :]
    t = np.arange(n)[:, None]
    basis = np.cos((2.0 * np.pi / n) * (t + 0.5 + n / 4.0) * (k + 0.5))
    return (_sine_window(n)[:, None] * basis * np.sqrt(2.0 / (n // 2))).astype(np.float32)


def _bark(n_coef: int, sr: int) -> np.ndarray:
    f = (np.arange(n_coef) + 0.5) * (sr / 2.0) / n_coef
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@functools.lru_cache(maxsize=4)
def _bark_spread(n_coef: int, sr: int) -> np.ndarray:
    """(n_coef, n_coef) triangular +/-1 Bark spreading matrix."""
    z = _bark(n_coef, sr)
    spread = np.maximum(0.0, 1.0 - np.abs(z[:, None] - z[None, :]))
    spread /= spread.sum(axis=1, keepdims=True)
    return spread.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _sfb_matrices(n_coef: int, sr: int) -> tuple[np.ndarray, np.ndarray]:
    """Scalefactor bands over Bark-uniform edges: (pool (N_SFB, n_coef),
    the mean over a band's members; expand (n_coef, N_SFB), one-hot)."""
    z = _bark(n_coef, sr)
    edges = np.linspace(0.0, z[-1] * (1 + 1e-9), _N_SFB + 1)
    band = np.clip(np.searchsorted(edges, z, side="right") - 1, 0, _N_SFB - 1)
    expand = np.zeros((n_coef, _N_SFB), np.float32)
    expand[np.arange(n_coef), band] = 1.0
    pool = (expand / np.maximum(expand.sum(axis=0), 1.0)).T
    return pool, expand


@functools.lru_cache(maxsize=16)
def _consts(sr: int, quality: int, device: torch.device, dtype: torch.dtype):
    """The constants of one rate and quality on ``device``: the
    MDCT basis, the spreading matrix's transpose, the pooling and expansion
    matrices' transposes, the lowpass mask (None at cutoff 1) and the
    scalars the quantizer compares with."""
    n = _FRAME
    pool, expand = _sfb_matrices(n // 2, sr)
    cutoff = _QUALITY_CUTOFF[quality]
    mask = None
    if cutoff < 1.0:
        mask = np.zeros(n // 2, np.float32)
        mask[: int(cutoff * (n // 2))] = 1.0

    def dev(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    scalars = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in
               (("p_lo", 0.25), ("p_hi", 4.0), ("mag_lo", 1e-4), ("zero", 0.0))}
    return (dev(_mdct_matrix(n)), dev(_bark_spread(n // 2, sr).T), dev(pool.T),
            dev(expand.T), dev(mask), scalars)


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (half to even, as jnp.round)."""
    return x + (torch.round(x) - x).detach()


def _smooth5(e: torch.Tensor) -> torch.Tensor:
    """5-tap moving average along the last axis, edge-padded."""
    ep = torch.cat([e[..., :1], e[..., :1], e, e[..., -1:], e[..., -1:]], dim=-1)
    return sum(ep[..., i : i + e.shape[-1]] for i in range(5)) / 5.0


def mp3_approx(x: torch.Tensor, sr: int, quality: int = 2) -> torch.Tensor:
    """MDCT-domain perceptual quantization of (..., L); the output has the
    input's length."""
    quality = int(quality)
    scale = _QUALITY_SCALE[quality]
    mdct, spread_t, pool_t, expand_t, mask, c = _consts(sr, quality, x.device, x.dtype)
    n, length = _FRAME, x.shape[-1]
    pad = (-(length - n) % _HOP) + n  # the tail and one frame of lead
    xp = F.pad(x, (_HOP, pad))
    n_frames = (xp.shape[-1] - n) // _HOP + 1
    rows = xp.reshape(*x.shape[:-1], -1, _HOP)
    frames = torch.cat([rows[..., :n_frames, :], rows[..., 1 : n_frames + 1, :]], dim=-1)
    coefs = frames @ mdct  # (..., T, n//2)

    # masking threshold: the spread magnitude envelope, pooled per SFB
    envelope = coefs.abs() @ spread_t
    step_sfb = scale * (envelope @ pool_t + 1e-6)  # (..., T, N_SFB)

    # bit-reservoir pressure: loud frames get relatively larger steps
    e_frame = (coefs**2).mean(dim=-1) + 1e-12  # (..., T)
    pressure = e_frame / (_smooth5(e_frame).mean(dim=-1, keepdim=True) + 1e-12)
    pressure = torch.minimum(c["p_hi"], torch.maximum(c["p_lo"], pressure)) ** 0.25

    # transient gate: a sharp energy rise gets finer steps
    prev = torch.cat([e_frame[..., :1], e_frame[..., :-1]], dim=-1)
    gate = 1.0 / (1.0 + 3.0 * torch.sigmoid((e_frame / (prev + 1e-12) - 6.0) / 2.0))

    step = (step_sfb * (pressure * gate)[..., None]) @ expand_t  # per coefficient

    # the |c|^(3/4) quantizer, straight-through; the floor below one LSB
    # keeps the derivative of x^0.75 finite at 0
    mag = torch.maximum(coefs.abs() / step, c["mag_lo"])
    qmag = torch.maximum(_ste_round(mag**0.75), c["zero"]) ** (4.0 / 3.0)
    q = torch.sign(coefs) * qmag * step
    if mask is not None:
        q = q * mask

    # synthesis with the same windowed basis: TDAC cancels the aliasing in
    # the 50 % overlap-add
    chunks = q @ mdct.T  # (..., T, n)
    y = F.pad(chunks[..., :_HOP], (0, 0, 0, 1)) + F.pad(chunks[..., _HOP:], (0, 0, 1, 0))
    y = y.reshape(*x.shape[:-1], -1)
    return y[..., _HOP : _HOP + length]
