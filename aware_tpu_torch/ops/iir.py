"""IIR filter design and application.

The port of ``aware_tpu/ops/iir.py``, the filters of the attack suite's
``low_pass``, ``high_pass`` and ``bandstop_200Hz`` rows:

* the design, on the host in float64 numpy, copied: Butterworth ``butter``
  / ``butter_zpk`` / ``butter_sos`` (analog prototype -> frequency
  transform -> bilinear), ``zpk2sos``, ``lfilter_zi``, ``sosfilt_zi``,
  ``iir_impulse_response``;
* the appliers on tensors (..., L): ``lfilter`` (direct form II
  transposed) and ``sosfilt`` (a cascade of DF2T biquads) run the float32
  recurrences of the JAX package's ``lax.scan`` steps in the same order
  (``yn = b0 xn + z0``, then the state update), on the card as the
  hand-written scan kernels ``aw_lfilter`` and ``aw_sosfilt``
  (``ops/kernels/iir.py``, ``csrc/iir.cu``), on the CPU as their plain
  versions; ``filtfilt`` and ``sosfiltfilt`` (zero phase, scipy's odd
  extension and edge conditions) run them forward and backward;
  ``fir_approx`` applies a truncated impulse response as one ``conv1d``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from aware_tpu_torch.ops.kernels.iir import device_array, lfilter_scan, sosfilt_scan


# ------------------------------------------------------------- design ----

def _butter_prototype(order: int) -> np.ndarray:
    """Analog Butterworth poles (unit cutoff, left half-plane)."""
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order) + np.pi / 2
    return np.exp(1j * theta)


def _bilinear_zpk(z, p, k, fs):
    fs2 = 2.0 * fs
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    # zeros at infinity map to -1
    z_d = np.append(z_d, -np.ones(len(p) - len(z)))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, k_d


def butter_zpk(
    order: int, wn, btype: str = "low"
) -> tuple[np.ndarray, np.ndarray, float]:
    """Digital Butterworth in zpk form; ``wn`` normalized to Nyquist."""
    fs = 2.0
    z = np.array([], dtype=complex)
    p = _butter_prototype(order)
    k = 1.0

    if btype in ("low", "lowpass", "high", "highpass"):
        warped = 2.0 * fs * np.tan(np.pi * float(np.atleast_1d(wn)[0]) / 2.0)
        if btype.startswith("low"):
            p = p * warped
            k *= warped**order
        else:  # highpass: lp2hp
            k *= np.real(np.prod(-p))
            p = warped / p
            z = np.zeros(order, dtype=complex)
    elif btype in ("bandpass", "bandstop"):
        lo, hi = np.atleast_1d(wn)
        w1 = 2.0 * fs * np.tan(np.pi * float(lo) / 2.0)
        w2 = 2.0 * fs * np.tan(np.pi * float(hi) / 2.0)
        bw, w0 = w2 - w1, np.sqrt(w1 * w2)
        if btype == "bandpass":  # lp2bp
            p_lp = p * bw / 2.0
            p = np.concatenate(
                [
                    p_lp + np.sqrt(p_lp**2 - w0**2),
                    p_lp - np.sqrt(p_lp**2 - w0**2),
                ]
            )
            z = np.zeros(order, dtype=complex)
            k *= bw**order
        else:  # lp2bs
            k *= np.real(np.prod(-p))
            p_inv = (bw / 2.0) / p
            p = np.concatenate(
                [
                    p_inv + np.sqrt(p_inv**2 - w0**2),
                    p_inv - np.sqrt(p_inv**2 - w0**2),
                ]
            )
            z = np.concatenate(
                [1j * w0 * np.ones(order), -1j * w0 * np.ones(order)]
            )
    else:
        raise ValueError(f"invalid btype: {btype}")

    return _bilinear_zpk(z, p, k, fs)


def butter(
    order: int, wn, btype: str = "low"
) -> tuple[np.ndarray, np.ndarray]:
    """Digital Butterworth (b, a) polynomials, scipy-compatible.

    NOTE: direct-form application of high-order narrow-band designs is
    numerically unstable in float32 — use :func:`butter_sos` +
    :func:`sosfilt`/:func:`sosfiltfilt` on device for those.
    """
    z, p, k = butter_zpk(order, wn, btype)
    b = np.real(k * np.poly(z))
    a = np.real(np.poly(p))
    return b.astype(np.float64), a.astype(np.float64)


def _pair_conjugates(roots: np.ndarray) -> list[np.ndarray]:
    """Group roots into conjugate pairs (or real pairs), largest |.| first."""
    roots = np.asarray(roots, dtype=complex)
    used = np.zeros(len(roots), dtype=bool)
    order = np.argsort(-np.abs(roots), kind="stable")
    pairs = []
    for i in order:
        if used[i]:
            continue
        used[i] = True
        ri = roots[i]
        if abs(ri.imag) > 1e-12:
            # find its conjugate
            j = np.argmin(np.where(used, np.inf, np.abs(roots - ri.conjugate())))
            used[j] = True
            pairs.append(np.array([ri, roots[j]]))
        else:
            # pair with another real root (or alone)
            reals = [
                j
                for j in order
                if not used[j] and abs(roots[j].imag) <= 1e-12
            ]
            if reals:
                j = reals[0]
                used[j] = True
                pairs.append(np.array([ri, roots[j]]))
            else:
                pairs.append(np.array([ri]))
    return pairs


def zpk2sos(z: np.ndarray, p: np.ndarray, k: float) -> np.ndarray:
    """zpk -> (n_sections, 6) second-order sections.

    Pairing: pole pairs closest to the unit circle first, each matched with
    the nearest zero pair (the standard stability-first heuristic; gain
    folded into the first section).
    """
    z = np.asarray(z, dtype=complex)
    p = np.asarray(p, dtype=complex)
    if len(z) < len(p):
        z = np.append(z, np.zeros(len(p) - len(z)))
    p_pairs = _pair_conjugates(p)
    z_pairs = _pair_conjugates(z)
    # match each pole pair with the nearest remaining zero pair
    sos = []
    z_used = [False] * len(z_pairs)
    for pp in p_pairs:
        best, best_d = None, np.inf
        for idx, zp in enumerate(z_pairs):
            if z_used[idx]:
                continue
            d = np.min(np.abs(pp[0] - zp))
            if d < best_d:
                best, best_d = idx, d
        zp = z_pairs[best] if best is not None else np.array([])
        if best is not None:
            z_used[best] = True
        b = np.real(np.poly(zp)) if len(zp) else np.array([1.0])
        a = np.real(np.poly(pp))
        b = np.pad(b, (0, 3 - len(b)))
        a = np.pad(a, (0, 3 - len(a)))
        sos.append(np.concatenate([b, a]))
    sos = np.array(sos, dtype=np.float64)
    sos[0, :3] *= k
    return sos


def butter_sos(order: int, wn, btype: str = "low") -> np.ndarray:
    """Digital Butterworth as second-order sections (f32-stable cascade)."""
    return zpk2sos(*butter_zpk(order, wn, btype))


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state DF2T initial conditions (scipy.signal.lfilter_zi)."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    b, a = b / a[0], a / a[0]
    # transposed companion matrix of a (the DF2T state-update matrix)
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - A, B)


# -------------------------------------------------------------- apply ----

def _ba(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(b, a) padded to one length and divided by a[0], in float64."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    return b / a[0], a / a[0]


def lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, zi=None) -> torch.Tensor:
    """Causal IIR filtering of the last axis (DF2T), leading batch dims
    allowed.  ``zi``: optional initial state (n-1,) or (..., n-1), as an
    array or a tensor.  Returns y (never the final state)."""
    b, a = _ba(b, a)
    batch, length = x.shape[:-1], x.shape[-1]
    xs = x.reshape(-1, length).contiguous()
    z0 = None
    if zi is not None:
        z0 = torch.as_tensor(zi, dtype=x.dtype, device=x.device)
        z0 = z0.broadcast_to((*batch, len(b) - 1)).reshape(xs.shape[0], len(b) - 1).contiguous()
    return lfilter_scan(xs, b, a, z0).reshape(*batch, length)


def filtfilt(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase filtering with scipy's defaults (odd extension,
    padlen = 3*max(len(a), len(b)), lfilter_zi edge conditions)."""
    n = max(len(a), len(b))
    padlen = 3 * n
    if x.shape[-1] <= padlen:
        raise ValueError("input too short for filtfilt padding")
    ext = _odd_ext(x, padlen)
    zi = device_array(lfilter_zi(b, a), x.device)
    y = lfilter(b, a, ext, zi=zi * ext[..., :1])
    y = y.flip(-1)
    y = lfilter(b, a, y, zi=zi * y[..., :1])
    return y.flip(-1)[..., padlen:-padlen]


def _odd_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    left = 2 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def sosfilt(sos: np.ndarray, x: torch.Tensor, zi=None) -> torch.Tensor:
    """Cascaded-biquad filtering (DF2T per section) of the last axis,
    stable in float32 where high-order direct forms blow up.  ``zi``:
    optional (n_sections, 2) or (..., n_sections, 2) initial state."""
    sos = np.asarray(sos, dtype=np.float64)
    n_sec = sos.shape[0]
    batch, length = x.shape[:-1], x.shape[-1]
    xs = x.reshape(-1, length).contiguous()
    z0 = None
    if zi is not None:
        z0 = torch.as_tensor(zi, dtype=x.dtype, device=x.device)
        z0 = z0.broadcast_to((*batch, n_sec, 2)).reshape(xs.shape[0], n_sec, 2).contiguous()
    return sosfilt_scan(xs, sos, z0).reshape(*batch, length)


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """(n_sections, 2) steady-state conditions (scipy.signal.sosfilt_zi)."""
    sos = np.asarray(sos, dtype=np.float64)
    zi = np.zeros((sos.shape[0], 2))
    scale = 1.0
    for s in range(sos.shape[0]):
        b, a = sos[s, :3], sos[s, 3:]
        zi[s] = scale * lfilter_zi(b, a)
        scale *= np.sum(b) / np.sum(a)  # DC gain of this section
    return zi


def sosfiltfilt(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase cascaded-biquad filtering (odd extension, scipy-style
    edge conditions)."""
    sos = np.asarray(sos, dtype=np.float64)
    ntaps = 2 * sos.shape[0] + 1
    padlen = 3 * ntaps
    if x.shape[-1] <= padlen:
        raise ValueError("input too short for sosfiltfilt padding")
    ext = _odd_ext(x, padlen)
    zi = device_array(sosfilt_zi(sos), x.device)
    y = sosfilt(sos, ext, zi=zi * ext[..., :1, None])
    y = y.flip(-1)
    y = sosfilt(sos, y, zi=zi * y[..., :1, None])
    return y.flip(-1)[..., padlen:-padlen]


# --------------------------------------------------- FIR approximation ----

def iir_impulse_response(
    b: np.ndarray, a: np.ndarray, length: int = 2048
) -> np.ndarray:
    """Truncated impulse response of an IIR filter (host, float64)."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b))) / a[0]
    a = np.pad(a, (0, n - len(a))) / a[0]
    h = np.zeros(length)
    for i in range(length):
        acc = b[i] if i < n else 0.0
        jmax = min(n - 1, i)
        if jmax > 0:
            acc -= np.dot(a[1 : jmax + 1], h[i - 1 : i - 1 - jmax : -1] if i - 1 - jmax >= 0 else h[i - 1 :: -1])
        h[i] = acc
    return h


def fir_approx(b: np.ndarray, a: np.ndarray, x: torch.Tensor, length: int = 2048) -> torch.Tensor:
    """Apply an IIR filter as a truncated-IR FIR convolution (causal): one
    ``conv1d``, parallel over time and differentiable.  Accurate to the
    truncated tail energy (< 1e-8 of the total for the suite's 4th/6th
    order filters at 2048 taps)."""
    h = iir_impulse_response(b, a, length)
    k = torch.as_tensor(h[::-1].copy(), dtype=x.dtype, device=x.device).reshape(1, 1, -1)
    batch_shape = x.shape[:-1]
    y = F.conv1d(F.pad(x.reshape(-1, 1, x.shape[-1]), (length - 1, 0)), k)
    return y.reshape(*batch_shape, -1)
