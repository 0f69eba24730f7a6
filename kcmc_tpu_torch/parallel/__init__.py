"""Frame-axis data parallelism of the port (the counterpart of
kcmc_tpu/parallel/): a 1-D mesh of devices, the frame batch split over
it, the reference keypoints gathered onto every shard, one process per
device across processes through torch.distributed."""

from kcmc_tpu_torch.parallel.mesh import (
    FRAME_AXIS,
    initialize_multihost,
    make_mesh,
    resolve_mesh,
    shard_host_local_frames,
)
from kcmc_tpu_torch.parallel.sharded import (
    make_sharded_batch_fn,
    mesh_size,
    pad_batch_to_mesh,
    pad_reference_to_mesh,
    ring_all_gather,
)

__all__ = [
    "FRAME_AXIS",
    "initialize_multihost",
    "make_mesh",
    "make_sharded_batch_fn",
    "mesh_size",
    "pad_batch_to_mesh",
    "pad_reference_to_mesh",
    "resolve_mesh",
    "ring_all_gather",
    "shard_host_local_frames",
]
