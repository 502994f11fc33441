"""Data and spatial parallelism across processes (``parallel/mesh.py``,
``parallel/halo.py``), the port's counterpart of
``cerberusnet_tpu/parallel``."""

from cerberusnet_torch.parallel.mesh import (
    SINGLE,
    DataMesh,
    data_ranks,
    launch,
    make_mesh,
    shard_batch,
    shard_samples,
)

__all__ = ["SINGLE", "DataMesh", "data_ranks", "launch", "make_mesh",
           "shard_batch", "shard_samples"]
