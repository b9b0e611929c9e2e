"""Sequence-parallel long-form detection: the frame axis split over ranks.

The port of ``aware_tpu/parallel/streaming.py``.  The detector is
time-translation covariant up to its global statistics: the instance-norm
and global-standardize statistics and the readout's time mean.  So an
hours-long clip splits over the ``seq`` ranks on the STFT frame axis:

* each rank copies only its own contiguous segment of the clip to its
  device (per-device memory O(L / n)), and takes the halo of ``n_fft -
  hop`` samples that its last frames read past it from its right
  neighbour, by a point-to-point exchange (the port of the JAX
  ``ppermute``); the last rank holds the tail;
* the peak normalization's maximum is an all-reduce of the ranks' maxima;
* every statistic and the readout's mean are masked partial sums,
  all-reduced over the ``seq`` group alone (on a (data, seq) mesh each
  data row detects its own clip): ``DetectorNet.forward_masked`` with an
  all-reduce as its ``reduce``, the same forward as the masked batch's.

The result equals ``detect_values`` of the whole clip on one device, to
float tolerance.  Frame bookkeeping, as in the JAX package: with T = L //
hop + 1 frames, each rank holds t_loc = ceil(T / n) frames, rounded up to
even so that the initial AvgPool(2, 2) never pairs frames of two ranks,
and masks those past T.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aware_tpu_torch.config import AwareConfig, in_band_bins
from aware_tpu_torch.models.detector import DetectorNet
from aware_tpu_torch.ops.windows import get_window
from aware_tpu_torch.parallel.batch import on_device
from aware_tpu_torch.parallel.mesh import Mesh


def _padded(x: np.ndarray, start: int, stop: int, pad: int) -> np.ndarray:
    """Samples [start, stop) of x reflect-padded by ``pad`` on both sides
    and then zero: the JAX package's ``xp``, cut from x's slices alone."""
    n = len(x)
    regions = ((0, x[1 : pad + 1][::-1]), (pad, x), (pad + n, x[n - pad - 1 : n - 1][::-1]))
    out = np.zeros(stop - start, np.float32)
    for lo, part in regions:
        a, b = max(start, lo), min(stop, lo + len(part))
        if a < b:
            out[a - start : b - start] = part[a - lo : b - lo]
    return out


def streaming_detect_values(
    net: DetectorNet,
    audio,
    cfg: AwareConfig,
    mesh: Mesh,
    axis: str = "seq",
) -> torch.Tensor:
    """Detector values (output_length,) of one clip (L,), split over
    ``axis``: every rank of the axis is handed the whole clip (host or
    device), copies its own segment to its device and returns the values,
    on its device.  A collective call over the axis's group."""
    n_fft, hop = cfg.frame_length, cfg.hop_length
    n, d = mesh.shape[axis], mesh.index(axis)
    group, ranks = mesh.group(axis), mesh.ranks(axis)
    dev = mesh.device
    net = on_device(net, dev)
    halo_len = n_fft - hop
    pad = n_fft // 2

    x = audio.detach().cpu().numpy() if isinstance(audio, torch.Tensor) else np.asarray(audio)
    x = x.astype(np.float32, copy=False)
    length = x.shape[-1]
    t_total = length // hop + 1
    t_loc = -(-t_total // n)
    t_loc += t_loc % 2  # even, so the AvgPool pairs stay on one rank
    seg = t_loc * hop
    if seg < halo_len:
        raise ValueError(
            f"a clip of {length} samples gives {t_loc} frames a rank on {n} ranks: fewer "
            f"samples ({seg}) than the halo of n_fft - hop = {halo_len}")

    # this rank's segment of the padded clip; the last rank also holds the
    # tail, and every sample of the clip that no segment holds
    start, stop = d * seg, (d + 1) * seg
    if d == n - 1:
        stop = max(stop + halo_len, pad + length)
    part = torch.from_numpy(_padded(x, start, stop, pad)).to(dev)

    def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=group)
        return t

    # the global peak normalization: reflected samples repeat others, and
    # the zeros past the pad add nothing to the maximum
    peak = all_reduce(part.abs().amax().reshape(1), dist.ReduceOp.MAX)
    part = part / (peak + 1e-8)
    if d == n - 1:
        halo = part[seg : seg + halo_len]
    else:
        halo = torch.empty(halo_len, dtype=part.dtype, device=dev)
    ops = []
    if d > 0:
        ops.append(dist.P2POp(dist.isend, part[:halo_len].contiguous(), ranks[d - 1], group))
    if d < n - 1:
        ops.append(dist.P2POp(dist.irecv, halo, ranks[d + 1], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    ext = torch.cat([part[:seg], halo])  # (t_loc - 1) * hop + n_fft samples
    window = torch.from_numpy(get_window(cfg.window, cfg.win_length)).to(dev)
    frames = ext.unfold(0, n_fft, hop) * window  # (t_loc, n_fft)
    mag = torch.fft.rfft(frames, dim=-1).abs().T  # (F, t_loc)
    lo, hi = in_band_bins(net.cfg.sample_rate, n_fft, cfg.embedding_bands)
    keep = torch.zeros(mag.shape[0], 1, dtype=mag.dtype, device=dev)
    keep[lo:hi] = 1.0
    mask = (d * t_loc + torch.arange(t_loc, device=dev)) < t_total
    with torch.no_grad():
        return net.forward_masked((mag * keep)[None], mask[None], cfg.matmul_precision,
                                  reduce=all_reduce)[0]
