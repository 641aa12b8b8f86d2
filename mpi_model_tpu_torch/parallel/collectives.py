"""Collectives over the shards of a mesh (counterpart of
``mpi_model_tpu/parallel/collectives.py``).

The reference builds every multi-rank pattern from blocking
``MPI_Send``/``MPI_Recv`` (``Model.hpp:70-131``); the JAX package uses
XLA's collectives inside ``shard_map``. With one process holding every
shard:

- reduce → ``global_sum``: per-shard partial sums added in fixed
  shard-major order (row-major over the mesh positions), so a run's total
  does not depend on which device finished first;
- gather → ``gather_to_host``: the global grid assembled from its shards.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import ShardGrid, assemble


def global_sum(grid: ShardGrid) -> torch.Tensor:
    """Σ over shards of each shard's sum, in shard-major order, on the first
    shard's device; f64 shards sum in f64, other floats in f32."""
    first = grid[0][0]
    acc_dt = torch.float64 if first.dtype == torch.float64 else torch.float32
    total = None
    for row in grid:
        for t in row:
            s = torch.sum(t, dtype=acc_dt).to(first.device)
            total = s if total is None else total + s
    return total


def gather_to_host(grid: ShardGrid) -> np.ndarray:
    """The global grid of one channel as a host array (bf16 as float32)."""
    full = assemble(grid, torch.device("cpu"))
    if full.dtype == torch.bfloat16:
        full = full.float()
    return full.numpy()
