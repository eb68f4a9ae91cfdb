"""Device meshes, shardings, SPMD helpers (the port of ``thunder_tpu/parallel``)."""

from thunder_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    full_state,
    gather_whole,
    make_mesh,
    param_shardings,
    replicated,
    shard_variables,
    stacked_batch_sharding,
    unshard_variables,
)
