"""The active-tile engine in plain torch (counterpart of
``mpi_model_tpu/ops/active.py``): step only the tiles near mass.

The grid is cut into ``(th, tw)`` tiles. A tile is **active** this step iff
any cell in it or in its ring-1 neighbor tiles is nonzero (the 3x3 dilation
of the per-tile any-nonzero map). For the uniform-rate linear flows the
engine serves (``Diffusion``), an inactive tile and every cell within
distance 1 of it are zero, so its update is exactly zero: skipping it is
exactly equal to computing it. A stored ``-0.0`` counts as zero and a
skipped tile keeps it, while the dense step gives ``+0.0``: equal under
``==``, one sign bit apart under byte hashing.

- Tile ids are cumsum-compacted into a fixed ``[K]`` buffer on the device
  (``compact_tile_ids``; no ``torch.nonzero``, which would sync).
- ``active_pass`` gathers the active tiles' ring-1 windows in one indexed
  read, computes the update term for term as ``ops.stencil.transport`` does
  (``outflow = rate*v``; ``share = outflow/count``; inflow summed from zero
  in ``offsets`` order; ``(v - outflow) + inflow``, counts from the window's
  global coordinates, clamped to >= 1 off the grid) and scatters it back.
  Every read precedes every write. The result equals the dense step bit for
  bit at every dtype. The port updates ``padded`` and ``upd`` in place
  (the JAX package returns new arrays), which saves a grid copy per step.
- The host needs the dilated count once per step, for one decision: is this
  step a dense fallback? (The JAX runner decides on the device.) Above the
  capacity or the activity threshold the engine takes the dense step that
  same step, never a truncated set.

``ghost_flags`` and ``dense_from_ghost_padded`` serve the sharded path
(``parallel.executors.ShardMapExecutor`` with ``step_impl="active"`` or
``"active_fused"``): a shard's padded state carries its neighbours' values
in a one-cell ring, the ring wakes the edge tiles one step before flux
arrives, and a shard above the threshold takes the dense step on the same
ring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.cell import MOORE_OFFSETS
from .stencil import neighbor_counts, scalar_const, transport


def _pick_tile_dim(dim: int, preferred: int) -> int:
    """Largest divisor of ``dim`` that is <= preferred."""
    for t in range(min(dim, preferred), 0, -1):
        if dim % t == 0:
            return t
    return dim


@dataclasses.dataclass(frozen=True)
class ActivePlan:
    """Static geometry of the engine for one grid shape: tile dims,
    tile-grid dims, the compaction capacity ``K`` and the dense-fallback
    threshold (in tiles)."""

    shape: tuple[int, int]
    tile: tuple[int, int]
    grid: tuple[int, int]          #: (gi, gj) tile-grid dims
    capacity: int                  #: K — compaction buffer lanes
    fallback_tiles: int            #: dense fallback when count exceeds this

    @property
    def ntiles(self) -> int:
        return self.grid[0] * self.grid[1]


def plan_for(shape: tuple[int, int], tile: Optional[tuple[int, int]] = None,
             capacity: Optional[int] = None,
             max_active_frac: float = 0.25,
             preferred_tile: int = 128) -> ActivePlan:
    """The engine geometry for ``shape``: tiles default to the largest
    divisors <= ``preferred_tile``; ``capacity`` to
    ``ceil(max_active_frac * ntiles)``; the dense fallback engages when the
    dilated count exceeds ``min(capacity, ceil(max_active_frac * ntiles))``,
    so capacity overflow never truncates the active set."""
    h, w = shape
    if tile is None:
        tile = (_pick_tile_dim(h, preferred_tile),
                _pick_tile_dim(w, preferred_tile))
    th, tw = int(tile[0]), int(tile[1])
    if th < 1 or tw < 1 or h % th or w % tw:
        raise ValueError(
            f"tile {tile} does not tile grid {shape} exactly; pick "
            "divisors of the grid dims (or tile=None to auto-pick)")
    gi, gj = h // th, w // tw
    ntiles = gi * gj
    if not 0.0 < max_active_frac <= 1.0:
        raise ValueError(
            f"max_active_frac must be in (0, 1], got {max_active_frac}")
    frac_tiles = max(1, min(ntiles, math.ceil(max_active_frac * ntiles)))
    cap = frac_tiles if capacity is None else int(capacity)
    if cap < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    cap = min(cap, ntiles)
    return ActivePlan(shape=(h, w), tile=(th, tw), grid=(gi, gj),
                      capacity=cap, fallback_tiles=min(cap, frac_tiles))


# -- activity map ------------------------------------------------------------

def tile_nonzero_map(v: torch.Tensor, plan: ActivePlan) -> torch.Tensor:
    """Per-tile any-nonzero: bool ``[gi, gj]`` (``v != 0``)."""
    (th, tw), (gi, gj) = plan.tile, plan.grid
    return (v != 0).reshape(gi, th, gj, tw).any(dim=3).any(dim=1)


def dilate_tile_map(tmap: torch.Tensor) -> torch.Tensor:
    """3x3 (ring-1) dilation of the tile map: a tile activates one step
    before flux can arrive."""
    gi, gj = tmap.shape
    p = F.pad(tmap.to(torch.uint8), (1, 1, 1, 1))
    out = torch.zeros_like(p[1:-1, 1:-1])
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            out = out | p[1 + dx:1 + dx + gi, 1 + dy:1 + dy + gj]
    return out.bool()


def ghost_flags(padded: torch.Tensor, plan: ActivePlan,
                tmap: torch.Tensor) -> torch.Tensor:
    """A shard's whole active set, bool ``[gi, gj]``: the ring-1 dilation
    of its tile map ``tmap`` (``dilate_tile_map``) OR the edge tiles its
    one-cell ghost ring (``[h+2, w+2]`` padded shard) activates. A nonzero
    ghost cell activates every edge tile whose window holds it: a ghost
    cell one column past a tile seam sits in two tiles' windows, so the
    per-tile strip map is dilated along the strip; a corner ghost
    neighbours only the corner tile's corner cell. Flux arriving from a
    neighbour shard is so seen one step early, as the interior dilation
    sees it. With an all-False ``tmap`` this is the JAX package's
    ``ghost_flags(padded, plan)``.

    Computed as one 3x3 dilation of the tile map framed by the ring's
    per-tile strips (the frame's corners are the corner ghosts): a strip
    entry reaches its tile and the two beside it along the edge, a corner
    entry only the corner tile."""
    (th, tw), (gi, gj) = plan.tile, plan.grid
    h, w = plan.shape
    frame = torch.zeros((gi + 2, gj + 2), dtype=torch.float32,
                        device=padded.device)
    frame[1:-1, 1:-1] = tmap
    # slices only (no index lists, which would be copied to the device)
    frame[0, 1:-1] = (padded[0, 1:w + 1] != 0).view(gj, tw).any(dim=1)
    frame[-1, 1:-1] = (padded[h + 1, 1:w + 1] != 0).view(gj, tw).any(dim=1)
    frame[1:-1, 0] = (padded[1:h + 1, 0] != 0).view(gi, th).any(dim=1)
    frame[1:-1, -1] = (padded[1:h + 1, w + 1] != 0).view(gi, th).any(dim=1)
    frame[::gi + 1, ::gj + 1] = padded[::h + 1, ::w + 1] != 0  # corners
    return F.max_pool2d(frame[None, None], 3, stride=1)[0, 0] > 0


def changed_tile_map(prev, new, plan: ActivePlan) -> np.ndarray:
    """Per-tile any-CHANGED map between two states of one channel: a bool
    ``[gi, gj]`` host array, True where any byte of the tile differs (a
    ``-0.0``/``+0.0`` flip or a NaN reads as changed). Two tensors on one
    device are compared there, and only the map comes to the host."""
    (th, tw), (gi, gj) = plan.tile, plan.grid
    if (isinstance(prev, torch.Tensor) and isinstance(new, torch.Tensor)
            and prev.device == new.device):
        a = prev.detach().contiguous().view(torch.uint8)
        b = new.detach().contiguous().view(torch.uint8)
        return ((a != b).reshape(gi, th, gj, -1).any(dim=3).any(dim=1)
                .cpu().numpy())

    def as_bytes(x):
        if isinstance(x, torch.Tensor):
            return x.detach().contiguous().view(torch.uint8).cpu().numpy()
        return np.ascontiguousarray(x).view(np.uint8)

    a = as_bytes(prev).reshape(gi, th, gj, -1)
    b = as_bytes(new).reshape(gi, th, gj, -1)
    return np.any(a != b, axis=(1, 3))


def compact_tile_ids(flags: torch.Tensor,
                     plan: ActivePlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Cumsum-compact the active map into the fixed ``[K]`` int32 index
    buffer: ``(ids, count)``, the row-major tile indices of the active tiles
    in lanes ``[0, count)``. Lanes past the capacity are dropped (they land
    in a discarded slot); the caller's fallback fires before such a set is
    used. On the device, without a host sync."""
    f = flags.reshape(-1)
    k = plan.capacity
    count = f.sum(dtype=torch.int32)
    pos = torch.cumsum(f.to(torch.int32), 0) - 1
    dest = torch.where(f, pos, k).clamp_(max=k).to(torch.int64)
    ids = torch.zeros(k + 1, dtype=torch.int32, device=flags.device)
    ids.scatter_(0, dest, torch.arange(f.shape[0], dtype=torch.int32,
                                       device=flags.device))
    return ids[:k], count


def window_index(ids: torch.Tensor, plan: ActivePlan, n: int, k: int,
                 off: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row and column indices ``[n, th+2k]`` and ``[n, tw+2k]`` of the
    first ``n`` lanes' ring-``k`` windows in a padded array whose tile
    ``(i, j)`` starts at ``(i*th + off, j*tw + off)`` (``off = ring - k``)."""
    (th, tw), (_, gj) = plan.tile, plan.grid
    t = ids[:n].to(torch.int64)
    dev = ids.device
    rows = (t // gj * th + off)[:, None] + torch.arange(th + 2 * k,
                                                        device=dev)
    cols = (t % gj * tw + off)[:, None] + torch.arange(tw + 2 * k,
                                                       device=dev)
    return rows, cols


def window_counts(rows_g: torch.Tensor, cols_g: torch.Tensor,
                  global_shape: tuple[int, int], offsets, dtype
                  ) -> torch.Tensor:
    """Per-lane in-bounds neighbor counts ``[n, wh, ww]`` of the cells at
    global rows ``rows_g [n, wh]`` and columns ``cols_g [n, ww]``, clamped to
    >= 1 (off-grid cells hold 0)."""
    H, W = global_shape
    cnt = None
    for dx, dy in offsets:
        okr = (rows_g + dx >= 0) & (rows_g + dx < H)
        okc = (cols_g + dy >= 0) & (cols_g + dy < W)
        c = (okr[:, :, None] & okc[:, None, :]).to(dtype)
        cnt = c if cnt is None else cnt + c
    return torch.clamp(cnt, min=1)


# -- the per-tile update (bitwise-mirrors ops.stencil.transport) -------------

def active_pass(padded: torch.Tensor, upd: torch.Tensor, ids: torch.Tensor,
                count, rate, plan: ActivePlan, origin,
                global_shape: tuple[int, int],
                offsets: Sequence[tuple[int, int]],
                dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One flow step over the compacted active set; returns ``(padded,
    upd, anyf)`` where ``anyf`` is the ``[K]`` bool any-nonzero of the
    computed tiles (lanes past ``count`` are False). ``padded`` is the
    ``[h+2, w+2]`` state with a zero ring, ``upd`` the ``[K, th, tw]``
    update buffer; both are updated in place (lanes of ``upd`` past
    ``count`` keep stale data and are never scattered). ``count`` may be a
    tensor: reading it here is one host sync."""
    (th, tw) = plan.tile
    K = plan.capacity
    n = min(int(count), K)
    anyf = torch.zeros(K, dtype=torch.bool, device=padded.device)
    if n == 0:
        return padded, upd, anyf
    rows, cols = window_index(ids, plan, n, 1, 0)
    win = padded[rows[:, :, None], cols[:, None, :]]
    cnt = window_counts(rows + (int(origin[0]) - 1),
                        cols + (int(origin[1]) - 1), global_shape, offsets,
                        dtype)
    rate_c = scalar_const(rate, dtype, padded.device)
    outflow = rate_c * win
    share = outflow / cnt
    inflow = torch.zeros((n, th, tw), dtype=dtype, device=padded.device)
    for dx, dy in offsets:
        inflow = inflow + share[:, 1 + dx:1 + dx + th, 1 + dy:1 + dy + tw]
    tile_out = (win[:, 1:-1, 1:-1] - outflow[:, 1:-1, 1:-1]) + inflow
    upd[:n] = tile_out
    anyf[:n] = (tile_out != 0).flatten(1).any(dim=1)
    padded[rows[:, 1:-1, None], cols[:, None, 1:-1]] = tile_out
    return padded, upd, anyf


def next_tile_map(anyf: torch.Tensor, ids: torch.Tensor, count,
                  plan: ActivePlan) -> torch.Tensor:
    """Exact post-step tile map from the per-lane flags: tiles outside the
    active set are zero by the engine invariant, so scattering the ``[K]``
    flags over a False map is the full answer."""
    gi, gj = plan.grid
    dev = anyf.device
    lanes = torch.arange(plan.capacity, dtype=torch.int32, device=dev)
    cnt = torch.as_tensor(count, dtype=torch.int32, device=dev)
    valid = lanes < torch.clamp(cnt, max=plan.capacity)
    idx = torch.where(valid, ids, gi * gj).to(torch.int64)
    flat = torch.zeros(gi * gj + 1, dtype=torch.bool, device=dev)
    flat.scatter_(0, idx, anyf & valid)
    return flat[:gi * gj].reshape(gi, gj)


# -- dense fallback ----------------------------------------------------------

def dense_from_padded(padded: torch.Tensor, rate, counts: torch.Tensor,
                      offsets: Sequence[tuple[int, int]],
                      dtype) -> torch.Tensor:
    """Full-grid dense step on the ring-1 padded state: ``transport``'s
    exact expression, returned re-padded with a zero ring."""
    v = padded[1:-1, 1:-1]
    rate_c = scalar_const(rate, dtype, padded.device)
    return F.pad(transport(v, rate_c * v, counts, offsets), (1, 1, 1, 1))


def dense_from_ghost_padded(padded: torch.Tensor, rate,
                            counts_pad: torch.Tensor,
                            offsets: Sequence[tuple[int, int]],
                            dtype) -> torch.Tensor:
    """Per-shard dense step on a padded shard whose ring holds its
    neighbours' values: shares computed on the whole padded array (a ghost
    cell's share is the value its owner computes, from the same operands
    by the same expression), inflow summed from zero in ``offsets`` order,
    then ``(v - outflow) + inflow``. Bitwise the share-exchanging xla shard
    step. ``counts_pad`` are the padded shard's neighbour counts from
    global coordinates, clamped to >= 1. Returns the bare ``[h, w]``
    interior."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    outflow_p = scalar_const(rate, dtype, padded.device) * padded
    share_p = outflow_p / counts_pad
    inflow = torch.zeros((h, w), dtype=dtype, device=padded.device)
    for dx, dy in offsets:
        inflow = inflow + share_p[1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
    return (padded[1:-1, 1:-1] - outflow_p[1:-1, 1:-1]) + inflow


def dense_transport_step(shape, rate, offsets, origin, global_shape, dtype):
    """The dense plain step ``v -> transport(v, rate*v)`` for a geometry
    (bitwise ``ops.stencil.flow_step`` with a uniform rate)."""
    def step(v: torch.Tensor) -> torch.Tensor:
        counts = neighbor_counts(shape, offsets, origin, global_shape,
                                 dtype, v.device)
        rate_c = scalar_const(rate, dtype, v.device)
        return transport(v, rate_c * v, counts, offsets)
    return step


# -- stateless per-step form (Model.make_step impl="active") -----------------

class ActiveDiffusionStep:
    """Stateless active-tile step for one channel: pad → activity →
    compact → active pass (or the dense fallback, same step) → unpad.
    Activity is recomputed from the values each call, so interleaved point
    flows are seen next step. ``dense_fn`` (values → values) is the
    fallback: K1 where the caller chose it, else the plain transport."""

    def __init__(self, shape: tuple[int, int], rate: float, dtype,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                 origin: tuple[int, int] = (0, 0),
                 global_shape: Optional[tuple[int, int]] = None,
                 tile: Optional[tuple[int, int]] = None,
                 capacity: Optional[int] = None,
                 max_active_frac: float = 0.25,
                 dense_fn: Optional[Callable] = None):
        self.shape = tuple(shape)
        self.rate = float(rate)
        self.dtype = dtype
        self.offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
        self.origin = (int(origin[0]), int(origin[1]))
        self.global_shape = (tuple(global_shape) if global_shape is not None
                             else self.shape)
        self.plan = plan_for(self.shape, tile=tile, capacity=capacity,
                             max_active_frac=max_active_frac)
        self.dense_fn = dense_fn or dense_transport_step(
            self.shape, self.rate, self.offsets, self.origin,
            self.global_shape, self.dtype)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        plan = self.plan
        th, tw = plan.tile
        flags = dilate_tile_map(tile_nonzero_map(v, plan))
        count = int(flags.sum())
        if count > plan.fallback_tiles:
            return self.dense_fn(v.contiguous())
        padded = F.pad(v, (1, 1, 1, 1))
        ids, _ = compact_tile_ids(flags, plan)
        upd = torch.empty((plan.capacity, th, tw), dtype=v.dtype,
                          device=v.device)
        active_pass(padded, upd, ids, count, self.rate, plan, self.origin,
                    self.global_shape, self.offsets, v.dtype)
        return padded[1:-1, 1:-1].contiguous()


# -- the amortized whole-run runner (SerialExecutor) -------------------------

def run_dense_fallback(padded: torch.Tensor, ring: int, steps: int,
                       fn: Callable) -> torch.Tensor:
    """``steps`` calls of the dense stepper ``fn`` on the interior of a
    ring-``ring`` padded state, written back in place (the ring stays
    zero)."""
    inner = padded[ring:-ring, ring:-ring]
    v = inner.contiguous()
    for _ in range(steps):
        v = fn(v)
    inner.copy_(v)
    return padded


def build_active_runner(shape: tuple[int, int], rates: dict,
                        offsets: Sequence[tuple[int, int]], dtype,
                        origin: tuple[int, int] = (0, 0),
                        global_shape: Optional[tuple[int, int]] = None,
                        plan: Optional[ActivePlan] = None,
                        dense_fns: Optional[dict] = None,
                        track_dirty: bool = False) -> Callable:
    """Whole-run active stepper: ``run(values, n) -> (values,
    (fallback_events, active_tiles_total))``, or with ``track_dirty`` also
    the bool ``[gi, gj]`` union of every tile the run wrote (the compacted
    set on active steps, the ring-1 dilation of the pre-step map on dense
    steps). Pads each channel once and carries ``(padded, tile_map, upd)``
    across the run; per step it reads the dilated count on the host once
    (the fallback decision). ``dense_fns`` maps attr → dense stepper for
    fallback steps (None → the bitwise plain transport). Stats are host
    ints: ``fallback_events`` counts (attr, step) pairs that fell back,
    ``active_tiles_total`` sums the dilated counts."""
    shape = tuple(shape)
    gshape = tuple(global_shape) if global_shape is not None else shape
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    if plan is None:
        plan = plan_for(shape)
    th, tw = plan.tile
    dense_fns = dense_fns or {}

    def run(values: dict, n: int):
        n = int(n)
        out = dict(values)
        fb = at = 0
        dev = next(iter(values.values())).device
        dirty = torch.zeros(plan.grid, dtype=torch.bool, device=dev)
        counts = None
        for a, rate in rates.items():
            v = values[a]
            padded = F.pad(v, (1, 1, 1, 1))
            tmap = tile_nonzero_map(v, plan)
            upd = torch.empty((plan.capacity, th, tw), dtype=dtype,
                              device=dev)
            for _ in range(n):
                flags = dilate_tile_map(tmap)
                cnt_t = flags.sum(dtype=torch.int32)
                cnt = int(cnt_t)  # the one host read per step
                at += cnt
                if cnt <= plan.fallback_tiles:
                    ids, _ = compact_tile_ids(flags, plan)
                    _, _, anyf = active_pass(padded, upd, ids, cnt, rate,
                                             plan, origin, gshape, offsets,
                                             dtype)
                    tmap = next_tile_map(anyf, ids, cnt_t, plan)
                    if track_dirty:
                        dirty |= flags
                    continue
                fb += 1
                if track_dirty:
                    dirty |= flags  # the ring-1 dilation of the pre-step map
                fn = dense_fns.get(a)
                if fn is not None:
                    run_dense_fallback(padded, 1, 1, fn)
                else:
                    if counts is None:
                        counts = neighbor_counts(shape, offsets, origin,
                                                 gshape, dtype, dev)
                    padded = dense_from_padded(padded, rate, counts,
                                               offsets, dtype)
                tmap = tile_nonzero_map(padded[1:-1, 1:-1], plan)
            out[a] = padded[1:-1, 1:-1].contiguous()
        if track_dirty:
            return out, (fb, at, dirty)
        return out, (fb, at)

    return run

