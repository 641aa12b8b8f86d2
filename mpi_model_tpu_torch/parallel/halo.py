"""Halo (ghost-cell) exchange between the shards of a mesh (counterpart of
``mpi_model_tpu/parallel/halo.py``).

The reference's owner of a boundary source sends its shares to the next
rank in blocking ``MPI_Send``s and the neighbour adds them into its first
row (``/root/reference/src/Model.hpp:189-235``). The JAX package ships
each shard's edge rows and columns with ``ppermute`` inside ``shard_map``
(two stages, so the corners ride along). Here one process holds every
shard (``parallel.mesh``), so a shard's ghost ring is cut directly from its
neighbours: ``n`` is the last d rows of the shard above, ``nw`` the
bottom-right d×d block of the shard above-left, and so on, with zeros
where the shard sits on a true grid edge — the values the two-stage
ppermute delivers, exactly.

Each piece is one contiguous tensor on the receiving shard's device. On
one device a piece that is already contiguous in its source (``n``/``s``:
whole rows) is a view of it, and the others are slice copies; the kernels
are out of place, so no shard is written while a ring that views it is
read. Between distinct CUDA devices a piece is a ``non_blocking`` copy,
which PyTorch orders after the sending device's current stream and before
the receiving one's.

A runner that keeps each shard in a ring-1 padded buffer for a whole run
refreshes the rings in place with ``refresh_rings``: the same values as
``pad_with_halo_1d/2d``, with no new copy a step.

Chaos seam (``resilience.inject``): while a halo fault is armed for a
chunk, ``exchange_ring``, ``pad_with_halo_1d`` and ``refresh_rings`` add
``inject.halo_perturbation()`` to the received top ghost rows, the
stand-in for a corrupted payload (the JAX package's ``_chaos_ring``).
Unarmed, each costs one module-global read.

Shards are addressed as ``grid[i][j]`` (``parallel.mesh.ShardGrid``); a
1-D mesh has one column.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.fused_stencil import pad_from_ring
from ..resilience import inject
from .mesh import ShardGrid


def _piece(src: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``src`` as one contiguous tensor on ``dev``."""
    if src.device == dev:
        return src.contiguous()
    return src.to(dev, non_blocking=True).contiguous()


def _check_depth(grid: ShardGrid, depth: int, rows: bool,
                 cols: bool) -> None:
    h, w = grid[0][0].shape
    if depth < 1:
        raise ValueError(f"halo depth must be >= 1, got {depth}")
    if (rows and depth > h) or (cols and depth > w):
        raise ValueError(
            f"halo depth {depth} exceeds the shard extent ({h}x{w}) — the "
            "exchanged slab cannot be deeper than the shard")


def exchange_halo_1d(grid: ShardGrid, i: int, j: int, axis: int = 0,
                     depth: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(before, after) slabs of shard (i, j) along ``axis``: the neighbour
    below's (or left's) last ``depth`` rows (columns) and the neighbour
    above's (right's) first ``depth``; zeros at a true grid edge."""
    _check_depth(grid, depth, axis == 0, axis == 1)
    local = grid[i][j]
    dev = local.device
    h, w = local.shape
    n = len(grid) if axis == 0 else len(grid[0])
    k = i if axis == 0 else j
    shape = (depth, w) if axis == 0 else (h, depth)

    def nb(kk):
        return grid[kk][j] if axis == 0 else grid[i][kk]

    if k > 0:
        src = nb(k - 1)
        before = _piece(src[-depth:] if axis == 0 else src[:, -depth:], dev)
    else:
        before = torch.zeros(shape, dtype=local.dtype, device=dev)
    if k < n - 1:
        src = nb(k + 1)
        after = _piece(src[:depth] if axis == 0 else src[:, :depth], dev)
    else:
        after = torch.zeros(shape, dtype=local.dtype, device=dev)
    return before, after


def exchange_ring(grid: ShardGrid, i: int, j: int, depth: int = 1) -> dict:
    """Depth-``d`` ghost ring of shard (i, j) as separate pieces, the JAX
    package's layout: ``n``/``s`` ``[d, w]``, ``w``/``e`` ``[h, d]``, corners
    ``[d, d]``, zeros at true grid edges (and for the corners and columns of
    a 1-D mesh, whose columns are unsplit)."""
    lines, columns = len(grid), len(grid[0])
    _check_depth(grid, depth, lines > 1, columns > 1)
    local = grid[i][j]
    dev = local.device
    h, w = local.shape
    d = depth

    def cut(di, dj, rows, cols, shape):
        ii, jj = i + di, j + dj
        if 0 <= ii < lines and 0 <= jj < columns:
            return _piece(grid[ii][jj][rows, cols], dev)
        return torch.zeros(shape, dtype=local.dtype, device=dev)

    whole = slice(None)
    first, last = slice(0, d), slice(-d, None)
    ring = {
        "n": cut(-1, 0, last, whole, (d, w)),
        "s": cut(1, 0, first, whole, (d, w)),
        "w": cut(0, -1, whole, last, (h, d)),
        "e": cut(0, 1, whole, first, (h, d)),
        "nw": cut(-1, -1, last, last, (d, d)),
        "ne": cut(-1, 1, last, first, (d, d)),
        "sw": cut(1, -1, first, last, (d, d)),
        "se": cut(1, 1, first, first, (d, d)),
    }
    # chaos seam (resilience.inject): one module-global read when no plan
    # is armed. Armed with a halo fault, the received top rows (the padded
    # shard's first d rows: nw, n, ne) carry the perturbation, out of place
    # (a piece may be a view of the neighbour's shard)
    eps = inject.halo_perturbation()
    if eps is not None:
        for k in ("nw", "n", "ne"):
            ring[k] = ring[k] + eps
    return ring


def zero_ring(local: torch.Tensor, depth: int = 1) -> dict:
    """An all-zero ghost ring shaped like ``exchange_ring``'s output: the
    no-traffic stand-in used when measuring halo cost (and the boundary
    condition of a standalone full grid)."""
    h, w = local.shape
    d = depth

    def z(s):
        return torch.zeros(s, dtype=local.dtype, device=local.device)

    return {"n": z((d, w)), "s": z((d, w)), "w": z((h, d)), "e": z((h, d)),
            "nw": z((d, d)), "ne": z((d, d)), "sw": z((d, d)),
            "se": z((d, d))}


def pad_with_halo_1d(grid: ShardGrid, i: int, depth: int = 1
                     ) -> torch.Tensor:
    """Shard i of a 1-D (row-striped) mesh → ``[h + 2d, w + 2d]``: row slabs
    from the mesh neighbours, columns zero-padded (unsharded dimension)."""
    before, after = exchange_halo_1d(grid, i, 0, axis=0, depth=depth)
    rows = torch.cat([before, grid[i][0], after], dim=0)
    padded = torch.nn.functional.pad(rows, (depth, depth))
    eps = inject.halo_perturbation()  # the chaos seam, as in exchange_ring
    if eps is not None:
        padded[:depth] += eps
    return padded


def pad_with_halo_2d(grid: ShardGrid, i: int, j: int, depth: int = 1
                     ) -> torch.Tensor:
    """Shard (i, j) → ``[h + 2d, w + 2d]`` with the full 8-neighbour (edge +
    corner) halo of the mesh."""
    return pad_from_ring(grid[i][j], exchange_ring(grid, i, j, depth))


def refresh_rings(grid: ShardGrid) -> None:
    """The depth-1 exchange for a grid of ring-1 padded shard buffers
    (``[h + 2, w + 2]`` each, the shard in the interior), in place: every
    ring takes the values ``pad_with_halo_1d/2d`` would give it, without a
    new padded copy. Two stages, as the JAX package's two ppermutes:
    columns first (interior rows), then whole rows, which carry the corners
    along from the columns just refreshed. Every write lands in a ring,
    every read in an interior or (stage 2) a ring stage 1 wrote, so no
    shard's interior is read after a write. Rings on a true grid edge, and
    the columns of a 1-D mesh, are never written: they keep the zeros of
    the buffer's first padding. Between devices a piece is a
    ``non_blocking`` copy, ordered as in ``exchange_ring``."""
    lines, columns = len(grid), len(grid[0])
    for i in range(lines):
        for j in range(columns):
            p = grid[i][j]
            if j > 0:
                p[1:-1, 0].copy_(grid[i][j - 1][1:-1, -2], non_blocking=True)
            if j < columns - 1:
                p[1:-1, -1].copy_(grid[i][j + 1][1:-1, 1], non_blocking=True)
    for i in range(lines):
        for j in range(columns):
            p = grid[i][j]
            if i > 0:
                p[0].copy_(grid[i - 1][j][-2], non_blocking=True)
            if i < lines - 1:
                p[-1].copy_(grid[i + 1][j][1], non_blocking=True)
    # the chaos seam, as in exchange_ring, on the rows received this step
    # (a true edge's ring is never rewritten, so it is left alone)
    eps = inject.halo_perturbation()
    if eps is not None:
        for row in grid[1:]:
            for p in row:
                p[0] += eps


def gather_from_padded(padded: torch.Tensor,
                       offsets: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``inflow[i, j] = Σ_d padded[1+i+dx, 1+j+dy]`` for an ``[h+2, w+2]``
    padded share array: the shard-local form of
    ``ops.stencil.gather_neighbors``."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    inflow = None
    for dx, dy in offsets:
        piece = padded[1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
        inflow = piece if inflow is None else inflow + piece
    return inflow
