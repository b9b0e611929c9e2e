"""The embed and detect batches split over a mesh axis.

The port of ``aware_tpu/parallel/batch.py``.  The per-clip solver is
embarrassingly parallel: the detector is replicated (every rank holds the
net), each rank solves its own rows of the batch with no collective in the
solver loop, and one all-gather over the axis gives every rank the whole
result, as ``np.asarray`` of the JAX package's sharded result does.  On a
mesh of more axes, the ranks that differ on the others hold the same rows.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist

from aware_tpu_torch.config import AwareConfig
from aware_tpu_torch.embed.solver import EmbedResult, embed_batch
from aware_tpu_torch.models.detector import DetectorNet, detect_values_batch
from aware_tpu_torch.parallel.mesh import Mesh


def on_device(net: DetectorNet, device: torch.device) -> DetectorNet:
    """``net``, or a copy of it on ``device`` where it lies elsewhere."""
    if net.mel_basis.device == device:
        return net
    return copy.deepcopy(net).to(device)


def local_rows(x, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's rows of the batch ``x`` (B, ...) (host or device), on
    its device: the axis's ranks take B / n rows each, in order.  A batch
    that the axis's size does not divide raises ValueError."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by mesh axis '{axis}' size {n}")
    rows = x.shape[0] // n
    part = x[mesh.index(axis) * rows : (mesh.index(axis) + 1) * rows]
    return torch.as_tensor(np.asarray(part) if not isinstance(part, torch.Tensor) else part,
                           dtype=torch.float32).to(mesh.device)


def all_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The whole batch from each rank's rows ``x``: an all-gather over the
    axis's group, concatenated in the axis's order."""
    if mesh.shape[axis] == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts)


def sharded_embed_batch(
    net: DetectorNet,
    audios,
    watermarks,
    cfg: AwareConfig,
    mesh: Mesh,
    axis: str = "data",
) -> EmbedResult:
    """``embed_batch`` of clips (B, L) with bipolar patterns (B, n_bits),
    split over ``axis``: B must divide by its size.  Each rank solves its
    rows on its device and returns the whole result, every field (B, ...)."""
    x = local_rows(audios, mesh, axis)
    wm = local_rows(watermarks, mesh, axis)
    res = embed_batch(on_device(net, mesh.device), x, wm, cfg)
    return EmbedResult(*(all_rows(f, mesh, axis) for f in res))


def sharded_detect_batch(
    net: DetectorNet,
    audios,
    cfg: AwareConfig,
    mesh: Mesh,
    axis: str = "data",
) -> torch.Tensor:
    """Detector values (B, n_bits) of clips (B, L), split over ``axis``
    (B must divide by its size), with the card's hop, window, win_length,
    bands and precision; every rank returns all B rows."""
    values = detect_values_batch(
        on_device(net, mesh.device),
        local_rows(audios, mesh, axis),
        hop_length=cfg.hop_length,
        window=cfg.window,
        win_length=cfg.win_length,
        embedding_bands=cfg.embedding_bands,
        precision=cfg.matmul_precision,
    )
    return all_rows(values, mesh, axis)
