"""Multi-device paths of the port on ``torch.distributed``: the mesh, the
batch split over ``data`` and long-form detection over ``seq``."""

from aware_tpu_torch.parallel.mesh import Mesh, get_mesh
from aware_tpu_torch.parallel.batch import sharded_embed_batch, sharded_detect_batch
from aware_tpu_torch.parallel.streaming import streaming_detect_values

__all__ = [
    "Mesh",
    "get_mesh",
    "sharded_embed_batch",
    "sharded_detect_batch",
    "streaming_detect_values",
]
