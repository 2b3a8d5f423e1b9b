"""Device mesh over torch.distributed (counterpart of :mod:`pixparse_tpu.parallel`)."""

from pixparse_tpu_torch.parallel.mesh import (
    DEFAULT_LOGICAL_RULES,
    MESH_AXES,
    MeshEnv,
    create_mesh,
    is_distributed_env,
    logical_sharding,
    mesh_shape,
    shard_batch,
    shard_model,
)
