"""The device mesh of the port: ranks of ``torch.distributed`` on named axes.

The port of ``aware_tpu/parallel/mesh.py``.  The framework's two parallel
axes:

* ``data``: clips are independent, so a batch splits over the ranks
  (``parallel/batch.py``; the adversarial training's batch too);
* ``seq``: long-form detection splits the STFT frame axis over the ranks,
  with a halo from the right neighbour, and every statistic of the
  detector becomes a partial sum all-reduced over the axis
  (``parallel/streaming.py``).

A rank is one process on one device: ``cuda:<LOCAL_RANK>`` under NCCL, or
the CPU under gloo when the caller passes ``device="cpu"``.  The process
group is the one already initialized; else the launcher's (``torchrun``
sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``); else a world of one.
Where JAX hands a whole array to a mesh, here every rank is handed the
whole input and works on its own part of it.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from aware_tpu_torch.device import resolve_device


class Mesh:
    """Named axes over the ranks of the default process group, as a JAX
    ``Mesh`` over devices: ``shape[axis]`` is the axis's size, ``group``
    its process group (the ranks that differ from this one on that axis
    alone), ``index`` this rank's coordinate on it.  ``device`` is this
    rank's device."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group on ``axis``, by coordinate."""
        return dist.get_process_group_ranks(self.group(axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _default_group(backend: str, device: torch.device) -> None:
    """The default process group: the one initialized, else the launcher's
    (``env://``), else a world of one on an in-process store."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in have:
            raise ValueError(
                f"the process group's backend is {have!r}; a mesh on {device} needs {backend}")
        return
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)


def get_mesh(
    axes: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """A mesh of every rank of the world on ``axes``: by default the whole
    world on the first axis; ``shape`` splits it, e.g. ``axes=("data",
    "seq"), shape=(2, 4)`` on 8 ranks.  A shape whose product is not the
    world's size raises ValueError.  Each rank runs on ``cuda:<LOCAL_RANK>``
    with NCCL (raising where there is no card), or with ``device="cpu"`` on
    the CPU with gloo.  A collective call: every rank calls it, with the
    same arguments, in the same order as its other meshes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a mesh runs on the card or the CPU, not on {dev}")
    _default_group(backend, dev)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes)), dev)
