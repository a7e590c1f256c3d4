"""Data and tensor parallelism over torch.distributed: the process group,
the ('data', 'model') mesh and its groups, the batch layout, the parameter
placements and the column-parallel layers that apply them
(counterpart of ns2vc_tpu/parallel)."""

from ns2vc_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_batch,
)

__all__ = ["make_mesh", "batch_sharding", "param_shardings", "shard_batch"]
