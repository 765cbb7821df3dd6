"""Multi-chip distribution (new relative to the reference).

The reference is shared-memory only (SURVEY.md sections 2.10-2.11): its one
parallelism strategy is tile-parallel threading.  This framework adds
spatial domain decomposition: voxel grids are block-partitioned over a 3-D
`jax.sharding.Mesh`, stencil halo exchanges and CG reductions become XLA
collectives inserted by the SPMD partitioner, and coarse levels below a
size threshold are replicated per device (communication-avoiding coarse
strategy).
"""

from geometricmultigridpressuresolver_tpu.parallel import distributed
from geometricmultigridpressuresolver_tpu.parallel.mesh import (
    factor_mesh,
    make_mesh,
    grid_pspec,
)
from geometricmultigridpressuresolver_tpu.parallel.sharding import (
    shard_problem,
    shard_setup,
    shard_grid,
    shard_velocity,
)

__all__ = [
    "distributed",
    "factor_mesh",
    "make_mesh",
    "grid_pspec",
    "shard_problem",
    "shard_setup",
    "shard_grid",
    "shard_velocity",
]
