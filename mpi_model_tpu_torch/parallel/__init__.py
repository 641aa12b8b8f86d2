"""L5 sharded execution: the mesh (``mesh``), the ghost-ring exchange
(``halo``), the reductions (``collectives``) and ``ShardMapExecutor``
(``executors``), one process driving every shard."""

from .collectives import gather_to_host, global_sum
from .executors import ShardMapExecutor
from .halo import (exchange_halo_1d, exchange_ring, gather_from_padded,
                   pad_with_halo_1d, pad_with_halo_2d, refresh_rings,
                   zero_ring)
from .mesh import (Mesh, assemble, factor2d, make_mesh, make_mesh_2d,
                   resolve_grid2d, shard_space)

__all__ = [
    "Mesh", "make_mesh", "make_mesh_2d", "factor2d", "resolve_grid2d",
    "shard_space", "assemble", "exchange_halo_1d", "exchange_ring",
    "zero_ring", "pad_with_halo_1d", "pad_with_halo_2d", "refresh_rings",
    "gather_from_padded", "global_sum", "gather_to_host",
    "ShardMapExecutor",
]
