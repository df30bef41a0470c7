from .process_mesh import DeviceMesh, ProcessMesh  # noqa: F401
from .placement import (  # noqa: F401
    PartitionSpec, Shard, Replicate, Partial, Placement,
    placements_to_spec, spec_to_placements,
)
from .api import (  # noqa: F401
    DistAttr, shard_tensor, dtensor_from_fn, reshard, shard_layer,
    shard_optimizer, to_static, DistModel, Strategy, unshard_dtensor,
    dtensor_to_local, local_shards, moe_global_mesh_tensor,
    moe_sub_mesh_tensors, ShardingStage1, ShardingStage2, ShardingStage3,
)
