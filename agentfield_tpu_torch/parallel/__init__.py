"""Tensor parallelism on ``torch.distributed`` — counterpart of
``agentfield_tpu/parallel/``: ``mesh`` (axes, one rank's mesh and its
collectives), ``sharding`` (partition specs, one rank's slice of a tree)
and ``worker`` (the rank loop of a tensor-parallel serving engine)."""

from agentfield_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_SEQ,
    AXIS_STAGE,
    CANONICAL_ORDER,
    Mesh,
    auto_mesh_shape,
    make_mesh,
)
from agentfield_tpu_torch.parallel.sharding import (  # noqa: F401
    check_divisibility,
    param_pspecs,
    shard_params,
)
