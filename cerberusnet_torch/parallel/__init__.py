"""Data parallelism across processes (``parallel/mesh.py``), the port's
counterpart of ``cerberusnet_tpu/parallel``."""

from cerberusnet_torch.parallel.mesh import (
    SINGLE,
    DataMesh,
    data_ranks,
    launch,
    make_mesh,
    shard_batch,
)

__all__ = ["SINGLE", "DataMesh", "data_ranks", "launch", "make_mesh",
           "shard_batch"]
