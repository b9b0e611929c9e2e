"""The IIR filters' scan kernels: ``aw_lfilter`` and ``aw_sosfilt``.

Not TPU kernels: the JAX package runs these recurrences as ``lax.scan``
(``aware_tpu/ops/iir.py:247``, ``:304``).  In plain torch on the card each
sample would cost several launches (160 000 samples a 10 s clip), so the
recurrences are CUDA entries of ``csrc/iir.cu`` (the design is in its
header): one thread per lane, the state in registers, float32 in the JAX
step's order.

* ``lfilter_scan(x, b, a, zi)``: direct form II transposed, x (B, L)
  float32, b and a (n,) float64 already divided by a[0] (``ops.iir._ba``),
  zi (B, n-1) float32 or None;
* ``sosfilt_scan(x, sos, zi)``: a cascade of DF2T biquads, sos
  (n_sections, 6) float64, zi (B, n_sections, 2) float32 or None.

Each wrapper checks its operands, launches on the current stream and
counts the launch in its ``launches`` attribute; given CPU tensors it runs
the plain version instead, and on a CUDA tensor it launches the kernel or
raises.  The plain versions (``*_plain``) are torch loops over the samples
of the same recurrence, in the same order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aware_tpu_torch.ops.kernels.roundtrip import _check, _run

MAX_STATE = 16     # lfilter's state length n-1 at most (csrc/iir.cu kMaxState)
MAX_SECTIONS = 16  # sosfilt's sections at most (csrc/iir.cu kMaxSections)


@functools.lru_cache(maxsize=256)
def _cached(data: bytes, shape: tuple, device: torch.device) -> torch.Tensor:
    host = np.frombuffer(data, np.float64).reshape(shape).astype(np.float32)
    return torch.from_numpy(host).to(device)


def device_array(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float64 host array as a float32 tensor on ``device``, copied once
    per value and device: a copy from the host in every call would wait for
    the card (and cannot be captured in a CUDA graph).  Read only."""
    a = np.ascontiguousarray(a, dtype=np.float64)
    return _cached(a.tobytes(), a.shape, device)


def _lfilter_coefs(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(2, n) float32 [b; a] on x's device: the JAX step's cast of the
    float64 normalized coefficients."""
    return device_array(np.stack([b, a]), x.device)


def _sos_coefs(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(n_sections, 6) float32 [b0 b1 b2 | a0 a1 a2 / a0]: the JAX step's
    ``bs`` and ``as_``."""
    sos = np.asarray(sos, dtype=np.float64)
    return device_array(np.concatenate([sos[:, :3], sos[:, 3:] / sos[:, 3:4]], axis=1), x.device)


# ---------------------------------------------------------- plain versions ---

def lfilter_plain(x: torch.Tensor, b: np.ndarray, a: np.ndarray,
                  zi: torch.Tensor | None = None) -> torch.Tensor:
    """DF2T over the last axis of x (B, L), one step a sample:
    ``yn = b0 xn + z0``, ``z_i = (b_{i+1} xn - a_{i+1} yn) + z_{i+1}``."""
    c = _lfilter_coefs(b, a, x)
    n = c.shape[1]
    bt, at = c[0], c[1]
    z = x.new_zeros(x.shape[0], n - 1) if zi is None else zi.clone()
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        xn = x[:, t]
        yn = bt[0] * xn + z[:, 0]
        shifted = torch.cat([z[:, 1:], z.new_zeros(z.shape[0], 1)], dim=1)
        z = bt[1:] * xn[:, None] - at[1:] * yn[:, None] + shifted
        y[:, t] = yn
    return y


def sosfilt_plain(x: torch.Tensor, sos: np.ndarray,
                  zi: torch.Tensor | None = None) -> torch.Tensor:
    """The biquad cascade over the last axis of x (B, L): per sample and
    section, ``y = b0 v + z0``, ``z0 = (b1 v - a1 y) + z1``,
    ``z1 = b2 v - a2 y``, then v = y for the next section."""
    c = _sos_coefs(sos, x)
    z = x.new_zeros(x.shape[0], c.shape[0], 2) if zi is None else zi.clone()
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        v = x[:, t]
        for s in range(c.shape[0]):
            out = c[s, 0] * v + z[:, s, 0]
            z1 = c[s, 1] * v - c[s, 4] * out + z[:, s, 1]
            z2 = c[s, 2] * v - c[s, 5] * out
            z[:, s, 0], z[:, s, 1] = z1, z2
            v = out
        y[:, t] = v
    return y


# ---------------------------------------------------------------- wrappers ---

def check_lfilter(x, b, zi) -> tuple[int, int, int]:
    """What ``aw_lfilter`` cannot take: raise, before any launch.
    Returns (B, L, n-1)."""
    bsz, length = x.shape
    ns = len(b) - 1
    if not 1 <= ns <= MAX_STATE:
        raise ValueError(f"CUDA lfilter takes 1 to {MAX_STATE} state values (got {ns})")
    _check("x", x, (bsz, length), torch.float32, x.device)
    if zi is not None:
        _check("zi", zi, (bsz, ns), torch.float32, x.device)
    return bsz, length, ns


def check_sosfilt(x, sos, zi) -> tuple[int, int, int]:
    """What ``aw_sosfilt`` cannot take: raise, before any launch.
    Returns (B, L, n_sections)."""
    bsz, length = x.shape
    n_sec = len(sos)
    if np.shape(sos)[1:] != (6,) or not 1 <= n_sec <= MAX_SECTIONS:
        raise ValueError(f"CUDA sosfilt takes (1 to {MAX_SECTIONS}, 6) sections "
                         f"(got {np.shape(sos)})")
    _check("x", x, (bsz, length), torch.float32, x.device)
    if zi is not None:
        _check("zi", zi, (bsz, n_sec, 2), torch.float32, x.device)
    return bsz, length, n_sec


def lfilter_scan(x: torch.Tensor, b: np.ndarray, a: np.ndarray,
                 zi: torch.Tensor | None = None) -> torch.Tensor:
    """DF2T of x (B, L) by ``aw_lfilter`` (1 launch); a new computation, not
    a TPU kernel (the JAX package's ``lax.scan`` at aware_tpu/ops/iir.py:247)."""
    if x.device.type == "cpu":
        return lfilter_plain(x, b, a, zi)
    bsz, length, ns = check_lfilter(x, b, zi)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _run("aw_lfilter", x.device, x, _lfilter_coefs(b, a, x), zi, y, bsz, length, ns)
    lfilter_scan.launches += 1
    return y


def sosfilt_scan(x: torch.Tensor, sos: np.ndarray,
                 zi: torch.Tensor | None = None) -> torch.Tensor:
    """The biquad cascade of x (B, L) by ``aw_sosfilt`` (1 launch); a new
    computation, not a TPU kernel (``lax.scan`` at aware_tpu/ops/iir.py:304)."""
    if x.device.type == "cpu":
        return sosfilt_plain(x, sos, zi)
    bsz, length, n_sec = check_sosfilt(x, sos, zi)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _run("aw_sosfilt", x.device, x, _sos_coefs(sos, x), zi, y, bsz, length, n_sec)
    sosfilt_scan.launches += 1
    return y


lfilter_scan.launches = 0
sosfilt_scan.launches = 0
KERNELS = (lfilter_scan, sosfilt_scan)
