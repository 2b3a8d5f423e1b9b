"""Device mesh over torch.distributed (counterpart of :mod:`pixparse_tpu.parallel`)."""

from pixparse_tpu_torch.parallel.mesh import (
    MESH_AXES,
    MeshEnv,
    create_mesh,
    is_distributed_env,
    mesh_shape,
    shard_batch,
    shard_model,
)
