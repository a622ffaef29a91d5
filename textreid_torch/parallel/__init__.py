"""Data parallelism over ``torch.distributed`` (counterpart of
``textreid_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_shard_count,
    local_batch_size,
    make_mesh,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "data_shard_count",
           "local_batch_size", "make_mesh"]
