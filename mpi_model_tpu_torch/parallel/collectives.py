"""Collectives over the shards of a mesh (counterpart of
``mpi_model_tpu/parallel/collectives.py``).

The reference builds every multi-rank pattern from blocking
``MPI_Send``/``MPI_Recv`` (``Model.hpp:70-131``); the JAX package uses
XLA's collectives inside ``shard_map``. Here a process holds its own
positions' shards (``None`` at the others, ``parallel.mesh``):

- reduce → ``global_sum``: per-shard partial sums added in fixed
  shard-major order (row-major over the mesh positions), so a run's total
  depends neither on which device finished first nor on how many
  processes hold the shards: the partials of other processes are gathered
  (``parallel.multihost``), never ``all_reduce``d, whose order is not
  fixed;
- gather → ``gather_grid`` / ``gather_to_host``: the global grid assembled
  from its shards, on every process.
"""

from __future__ import annotations

import numpy as np
import torch

from . import multihost
from .mesh import ShardGrid, assemble, layout_owners


def _positions(grid: ShardGrid) -> list[tuple[int, int]]:
    lines, columns = len(grid), len(grid[0])
    return [(i, j) for i in range(lines) for j in range(columns)]


def _local(grid: ShardGrid) -> list[tuple[int, int]]:
    """The positions this process holds; they must be its run of the
    row-major layout (``mesh.layout_owners``)."""
    mine = [c for c in _positions(grid) if grid[c[0]][c[1]] is not None]
    owners = layout_owners(len(grid), len(grid[0]), multihost.process_count())
    if owners is not None:
        rank = multihost.process_index()
        want = [c for c in _positions(grid) if owners[c[0]][c[1]] == rank]
        if mine != want:
            raise ValueError(
                f"process {rank} holds positions {mine}, not its run "
                f"{want} of the row-major layout")
    return mine


def _gathered(grid: ShardGrid, collective: bool) -> list[torch.Tensor]:
    """Every position's bytes (flat ``uint8``), row-major: this process's
    shards, and the others' from one all-gather."""
    mine = _local(grid)
    raw = torch.cat([multihost.as_bytes(grid[i][j]) for i, j in mine])
    parts = multihost.all_gather_bytes(raw) if collective else [raw]
    per = len(mine)
    size = raw.numel() // per
    return [p[k * size:(k + 1) * size] for p in parts for k in range(per)]


def gather_grid(grid: ShardGrid, device: torch.device,
                collective: bool = True) -> torch.Tensor:
    """The global tensor of one channel on ``device`` on every process,
    gathered with one all-gather (``collective``; under gloo the shards are
    staged through host memory). Every position's shard has one shape."""
    if not collective:
        return assemble(grid, device)
    first = next(t for row in grid for t in row if t is not None)
    lines, columns = len(grid), len(grid[0])
    h, w = first.shape[-2:]
    out = torch.empty(first.shape[:-2] + (lines * h, columns * w),
                      dtype=first.dtype, device=device)
    for (i, j), raw in zip(_positions(grid), _gathered(grid, True)):
        out[..., i * h:(i + 1) * h, j * w:(j + 1) * w].copy_(
            multihost.from_bytes(raw, first.dtype, first.shape),
            non_blocking=True)
    return out


def global_sum(grid: ShardGrid) -> torch.Tensor:
    """Σ over shards of each shard's sum, in shard-major order, on this
    process's first shard's device; f64 shards sum in f64, other floats in
    f32. With a ``torch.distributed`` group every shard's partial is
    gathered first, so a run over N processes totals what the same mesh
    totals in one process, bit for bit."""
    first = next(t for row in grid for t in row if t is not None)
    acc_dt = torch.float64 if first.dtype == torch.float64 else torch.float32
    partials = [[None if t is None else torch.sum(t, dtype=acc_dt).reshape(1)
                 for t in row] for row in grid]
    if multihost.has_group():
        sums = [multihost.from_bytes(r, acc_dt, (1,)).to(first.device)
                for r in _gathered(partials, True)]
    else:
        sums = [p.to(first.device) for row in partials for p in row]
    total = None
    for s in sums:
        s = s.reshape(())
        total = s if total is None else total + s
    return total


def gather_to_host(grid: ShardGrid) -> np.ndarray:
    """The global grid of one channel as a host array (bf16 as float32), on
    every process."""
    full = assemble(grid, torch.device("cpu"))
    if full.dtype == torch.bfloat16:
        full = full.float()
    return full.numpy()
