"""L5 sharded execution: the mesh (``mesh``), the ghost-ring exchange
(``halo``), the reductions (``collectives``), ``ShardMapExecutor`` and
``AutoShardedExecutor`` (``executors``), one process driving every shard,
or a ``torch.distributed`` world of processes each driving its own
(``multihost``)."""

from .collectives import gather_to_host, global_sum
from .executors import AutoShardedExecutor, ShardMapExecutor
from .halo import (exchange_halo_1d, exchange_ring, exchange_rings,
                   gather_from_padded, pad_rings, pad_with_halo_1d,
                   pad_with_halo_2d, refresh_rings, ring_plan, zero_ring)
from .mesh import (Mesh, assemble, factor2d, grid_spec, make_mesh,
                   make_mesh_2d, mesh_spans_processes, put_global,
                   resolve_grid2d, shard_space)

__all__ = [
    "Mesh", "make_mesh", "make_mesh_2d", "factor2d", "resolve_grid2d",
    "grid_spec", "shard_space", "put_global", "mesh_spans_processes",
    "assemble", "exchange_halo_1d", "exchange_ring",
    "exchange_rings", "ring_plan", "zero_ring", "pad_with_halo_1d",
    "pad_with_halo_2d", "pad_rings", "refresh_rings",
    "gather_from_padded", "global_sum", "gather_to_host",
    "AutoShardedExecutor", "ShardMapExecutor",
]
