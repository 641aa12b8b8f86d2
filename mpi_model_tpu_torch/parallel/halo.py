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

Across processes (``parallel.multihost``; ``None`` in a grid where another
process owns the position) an exchange is a plan and a transport.
``ring_plan(grid shape, shard shape, depth, owners)`` lists every piece of
every ring: which direction of which shard it fills, the shard and the
rows and columns it is cut from, the two processes and a tag of its own
(direction × shard: gloo matches a receive by source and tag, so the
``n`` and ``nw`` pieces of one peer never cross). ``carry`` posts every
piece this process sends or receives as one ``batch_isend_irecv``
(``multihost.exchange_pieces``); pieces between shards of one process are
cut directly, as above. ``exchange_rings`` (every held shard's ring),
``pad_rings`` and ``refresh_rings`` are collectives then: every process
calls them at the same point of its run; ``exchange_ring`` and
``pad_with_halo_1d/2d`` of one position too, returning None where the
position is another process's. Under gloo the pieces are staged through
the host: per exchange, one device-to-host copy of every piece sent and
one host-to-device copy of every piece received, the exchange's host
reads (two a process an exchange, where one runs the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..ops.fused_stencil import pad_from_ring
from ..resilience import inject
from . import multihost
from .mesh import ShardGrid, layout_owners

#: a ring's pieces, in the order ``exchange_ring`` returns them
RING_KEYS = ("n", "s", "w", "e", "nw", "ne", "sw", "se")


@dataclasses.dataclass(frozen=True)
class Piece:
    """One piece of one exchange: ring direction ``key`` of shard ``dst``,
    cut from shard ``src`` at ``rows`` × ``cols`` (``[start, stop)``), sent
    by process ``src_rank`` to ``dst_rank`` under ``tag``."""

    key: str
    src: tuple[int, int]
    dst: tuple[int, int]
    rows: tuple[int, int]
    cols: tuple[int, int]
    src_rank: int
    dst_rank: int
    tag: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows[1] - self.rows[0], self.cols[1] - self.cols[0])

    @property
    def remote(self) -> bool:
        return self.src_rank != self.dst_rank


def _source(key: str, d: int, h: int, w: int):
    """(di, dj, rows, cols): where piece ``key`` of a depth-``d`` ring comes
    from, relative to the receiving shard, in an ``[h, w]`` source shard."""
    first_r, last_r, whole_r = (0, d), (h - d, h), (0, h)
    first_c, last_c, whole_c = (0, d), (w - d, w), (0, w)
    return {"n": (-1, 0, last_r, whole_c), "s": (1, 0, first_r, whole_c),
            "w": (0, -1, whole_r, last_c), "e": (0, 1, whole_r, first_c),
            "nw": (-1, -1, last_r, last_c), "ne": (-1, 1, last_r, first_c),
            "sw": (1, -1, first_r, last_c),
            "se": (1, 1, first_r, first_c)}[key]


def ring_plan(grid_shape: tuple[int, int], shard_shape: tuple[int, int],
              depth: int, owners=None) -> tuple[Piece, ...]:
    """Every piece of every position's depth-``depth`` ring whose source
    lies in the mesh (a ring on a true grid edge, and the columns and
    corners of a 1-D mesh, have none: they are zeros). ``owners`` is the
    mesh's (``Mesh.owners``; None: process 0 owns every position). The tag
    is ``direction × positions + destination``, unique within an
    exchange."""
    lines, columns = grid_shape
    h, w = shard_shape[-2:]
    n = lines * columns

    def owner(i, j):
        return 0 if owners is None else owners[i][j]

    out = []
    for k, key in enumerate(RING_KEYS):
        for i in range(lines):
            for j in range(columns):
                di, dj, rows, cols = _source(key, depth, h, w)
                ii, jj = i + di, j + dj
                if not (0 <= ii < lines and 0 <= jj < columns):
                    continue
                out.append(Piece(key, (ii, jj), (i, j), rows, cols,
                                 owner(ii, jj), owner(i, j),
                                 k * n + i * columns + j))
    return tuple(out)


def carry(plan: Sequence[Piece], grid: ShardGrid,
          rank: Optional[int] = None) -> dict:
    """The transport: post every remote piece process ``rank`` (this one by
    default) sends or receives in ``plan`` as one ``batch_isend_irecv``;
    return the received ones, ``{(dst, key): tensor}`` on the receiving
    shard's device. Under gloo the card pieces are staged through the host
    (the exchange's host reads: one copy of all of them each way)."""
    rank = multihost.process_index() if rank is None else rank
    sends, recvs, keys = [], [], []
    for p in plan:
        if not p.remote:
            continue
        if p.src_rank == rank:
            src = grid[p.src[0]][p.src[1]]
            sends.append((p.dst_rank, p.tag,
                          src[p.rows[0]:p.rows[1], p.cols[0]:p.cols[1]]))
        elif p.dst_rank == rank:
            dst = grid[p.dst[0]][p.dst[1]]
            recvs.append((p.src_rank, p.tag, p.shape, dst.dtype,
                          dst.device))
            keys.append((p.dst, p.key))
    return dict(zip(keys, multihost.exchange_pieces(sends, recvs)))


def _first(grid: ShardGrid) -> torch.Tensor:
    return next(t for row in grid for t in row if t is not None)


def _all_local(grid: ShardGrid) -> bool:
    return all(t is not None for row in grid for t in row)


def _owners(grid: ShardGrid):
    return layout_owners(len(grid), len(grid[0]), multihost.process_count())


def _piece(src: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``src`` as one contiguous tensor on ``dev``."""
    if src.device == dev:
        return src.contiguous()
    return src.to(dev, non_blocking=True).contiguous()


def _check_depth(grid: ShardGrid, depth: int, rows: bool,
                 cols: bool) -> None:
    h, w = _first(grid).shape[-2:]
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
    above's (right's) first ``depth``; zeros at a true grid edge. Shards
    may carry leading batch dimensions (the ensemble mesh's ``[B, h, w]``
    lanes): rows and columns are the last two."""
    _check_depth(grid, depth, axis == 0, axis == 1)
    local = grid[i][j]
    dev = local.device
    h, w = local.shape[-2:]
    n = len(grid) if axis == 0 else len(grid[0])
    k = i if axis == 0 else j
    shape = local.shape[:-2] + ((depth, w) if axis == 0 else (h, depth))

    def nb(kk):
        return grid[kk][j] if axis == 0 else grid[i][kk]

    if k > 0:
        src = nb(k - 1)
        before = _piece(src[..., -depth:, :] if axis == 0
                        else src[..., -depth:], dev)
    else:
        before = torch.zeros(shape, dtype=local.dtype, device=dev)
    if k < n - 1:
        src = nb(k + 1)
        after = _piece(src[..., :depth, :] if axis == 0
                       else src[..., :depth], dev)
    else:
        after = torch.zeros(shape, dtype=local.dtype, device=dev)
    return before, after


def _ring_of(grid: ShardGrid, i: int, j: int, depth: int,
             remote: dict) -> dict:
    """Shard (i, j)'s ring: pieces of held neighbours cut directly,
    ``remote`` ones as received, zeros where no neighbour is; the chaos
    seam on the received top rows."""
    lines, columns = len(grid), len(grid[0])
    local = grid[i][j]
    dev = local.device
    h, w = local.shape
    ring = {}
    for key in RING_KEYS:
        di, dj, rows, cols = _source(key, depth, h, w)
        ii, jj = i + di, j + dj
        if not (0 <= ii < lines and 0 <= jj < columns):
            ring[key] = torch.zeros((rows[1] - rows[0], cols[1] - cols[0]),
                                    dtype=local.dtype, device=dev)
        elif grid[ii][jj] is None:
            ring[key] = remote[(i, j), key]
        else:
            # the slices of the source shard (shards may differ in shape)
            src = grid[ii][jj]
            _, _, rows, cols = _source(key, depth, *src.shape)
            ring[key] = _piece(src[rows[0]:rows[1], cols[0]:cols[1]], dev)
    # chaos seam (resilience.inject): one module-global read when no plan
    # is armed. Armed with a halo fault, the received top rows (the padded
    # shard's first d rows: nw, n, ne) carry the perturbation, out of place
    # (a piece may be a view of the neighbour's shard)
    eps = inject.halo_perturbation()
    if eps is not None:
        for k in ("nw", "n", "ne"):
            ring[k] = ring[k] + eps
    return ring


def exchange_ring(grid: ShardGrid, i: int, j: int,
                  depth: int = 1) -> Optional[dict]:
    """Depth-``d`` ghost ring of shard (i, j) as separate pieces, the JAX
    package's layout: ``n``/``s`` ``[d, w]``, ``w``/``e`` ``[h, d]``, corners
    ``[d, d]``, zeros at true grid edges (and for the corners and columns of
    a 1-D mesh, whose columns are unsplit). Where other processes own
    positions this is a collective of every process (the same (i, j)
    everywhere): the owner of (i, j) gets its ring, the others None."""
    lines, columns = len(grid), len(grid[0])
    _check_depth(grid, depth, lines > 1, columns > 1)
    remote = {}
    if not _all_local(grid):
        plan = [p for p in ring_plan((lines, columns), _first(grid).shape,
                                     depth, _owners(grid))
                if p.dst == (i, j)]
        remote = carry(plan, grid)
        if grid[i][j] is None:
            return None
    return _ring_of(grid, i, j, depth, remote)


def exchange_rings(grid: ShardGrid, depth: int = 1) -> dict:
    """Every held shard's depth-``depth`` ring, ``{(i, j): ring}``: each
    ``exchange_ring``'s, with every remote piece of the exchange carried by
    one ``batch_isend_irecv`` (a collective where other processes own
    positions)."""
    lines, columns = len(grid), len(grid[0])
    _check_depth(grid, depth, lines > 1, columns > 1)
    remote = {}
    if not _all_local(grid):
        remote = carry(ring_plan((lines, columns), _first(grid).shape, depth,
                                 _owners(grid)), grid)
    return {(i, j): _ring_of(grid, i, j, depth, remote)
            for i in range(lines) for j in range(columns)
            if grid[i][j] is not None}


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
                     ) -> Optional[torch.Tensor]:
    """Shard i of a 1-D (row-striped) mesh → ``[h + 2d, w + 2d]``: row slabs
    from the mesh neighbours, columns zero-padded (unsharded dimension).
    A collective where other processes own positions (None elsewhere)."""
    if not _all_local(grid):
        ring = exchange_ring(grid, i, 0, depth)
        return None if ring is None else pad_from_ring(grid[i][0], ring)
    before, after = exchange_halo_1d(grid, i, 0, axis=0, depth=depth)
    rows = torch.cat([before, grid[i][0], after], dim=0)
    padded = torch.nn.functional.pad(rows, (depth, depth))
    eps = inject.halo_perturbation()  # the chaos seam, as in exchange_ring
    if eps is not None:
        padded[:depth] += eps
    return padded


def pad_with_halo_2d(grid: ShardGrid, i: int, j: int, depth: int = 1
                     ) -> Optional[torch.Tensor]:
    """Shard (i, j) → ``[h + 2d, w + 2d]`` with the full 8-neighbour (edge +
    corner) halo of the mesh. A collective where other processes own
    positions (None elsewhere)."""
    ring = exchange_ring(grid, i, j, depth)
    return None if ring is None else pad_from_ring(grid[i][j], ring)


def pad_rings(grid: ShardGrid, depth: int = 1, one_d: bool = False) -> dict:
    """Every held shard padded with its depth-``depth`` halo, ``{(i, j):
    padded}``: ``pad_with_halo_1d`` (``one_d``) or ``pad_with_halo_2d`` of
    each, and where other processes own positions one exchange
    (``exchange_rings``) for them all."""
    lines, columns = len(grid), len(grid[0])
    if _all_local(grid):
        return {(i, j): (pad_with_halo_1d(grid, i, depth) if one_d
                         else pad_with_halo_2d(grid, i, j, depth))
                for i in range(lines) for j in range(columns)}
    return {c: pad_from_ring(grid[c[0]][c[1]], ring)
            for c, ring in exchange_rings(grid, depth).items()}


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
    ``non_blocking`` copy, ordered as in ``exchange_ring``. Where other
    processes own positions it is one collective exchange of the same
    values (``_refresh_remote``)."""
    if not _all_local(grid):
        _refresh_remote(grid)
        return
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


#: where piece ``key`` lands in a ring-1 padded buffer
_RING1_SLOT = {"n": (slice(0, 1), slice(1, -1)), "s": (slice(-1, None),
                                                      slice(1, -1)),
               "w": (slice(1, -1), slice(0, 1)), "e": (slice(1, -1),
                                                      slice(-1, None)),
               "nw": (slice(0, 1), slice(0, 1)),
               "ne": (slice(0, 1), slice(-1, None)),
               "sw": (slice(-1, None), slice(0, 1)),
               "se": (slice(-1, None), slice(-1, None))}


def _refresh_remote(grid: ShardGrid) -> None:
    """``refresh_rings`` over positions of several processes, in one
    exchange: each ring cell takes its neighbour's interior value directly
    (a corner: the diagonal neighbour's), which is what the two stages
    leave there."""
    lines, columns = len(grid), len(grid[0])
    inner = [[None if p is None else p[1:-1, 1:-1] for p in row]
             for row in grid]
    remote = carry(ring_plan((lines, columns), _first(inner).shape, 1,
                             _owners(grid)), inner)
    eps = inject.halo_perturbation()
    for i in range(lines):
        for j in range(columns):
            p = grid[i][j]
            if p is None:
                continue
            for key in RING_KEYS:
                di, dj, rows, cols = _source(key, 1, *inner[i][j].shape)
                ii, jj = i + di, j + dj
                if not (0 <= ii < lines and 0 <= jj < columns):
                    if eps is not None and i > 0 and key in ("nw", "ne"):
                        # the top row is rewritten whole before the seam
                        p[_RING1_SLOT[key]] = 0
                    continue
                src = (remote[(i, j), key] if inner[ii][jj] is None
                       else inner[ii][jj][rows[0]:rows[1], cols[0]:cols[1]])
                p[_RING1_SLOT[key]].copy_(src, non_blocking=True)
            # the chaos seam, as in refresh_rings
            if eps is not None and i > 0:
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
