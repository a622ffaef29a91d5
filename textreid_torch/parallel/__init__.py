"""The mesh over ``torch.distributed`` (counterpart of
``textreid_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SLICE_AXIS,
    Mesh,
    data_axes,
    data_shard_count,
    local_batch_size,
    make_mesh,
    shard_state,
    tp_spec,
    zero1_spec,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SLICE_AXIS", "Mesh", "data_axes",
           "data_shard_count", "local_batch_size", "make_mesh",
           "shard_state", "tp_spec", "zero1_spec"]
