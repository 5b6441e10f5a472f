"""Scale-out: the ``(model, data, dict)`` mesh over `torch.distributed`.

Counterpart of `sparse_coding__tpu/parallel`: the same names."""

from sparse_coding__tpu_torch.parallel.distributed import (
    host_local_to_global,
    initialize_distributed,
    local_batch_slice,
)
from sparse_coding__tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DICT_AXIS,
    MODEL_AXIS,
    Mesh,
    PartitionSpec,
    batch_sharding,
    default_mesh_shape,
    infer_state_specs,
    make_mesh,
    per_model_batch_sharding,
    shard_state,
)

__all__ = [
    "DATA_AXIS", "DICT_AXIS", "MODEL_AXIS", "Mesh", "PartitionSpec", "batch_sharding", "default_mesh_shape",
    "host_local_to_global", "infer_state_specs", "initialize_distributed", "local_batch_slice", "make_mesh",
    "per_model_batch_sharding", "shard_state",
]
