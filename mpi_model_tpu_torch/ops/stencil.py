"""Stencil transport ops in plain torch (counterpart of
``mpi_model_tpu/ops/stencil.py``).

- ``transport``: every cell sheds ``outflow[c]`` and splits it equally among
  its in-bounds neighbors; zero-padded shifts are the non-periodic boundary.
- ``neighbor_counts`` / ``weighted_counts``: the divisors, computed on the
  device from ``arange`` (the weighted one for the IR's weighted
  ``Transport``).
- ``point_flow_step``: the sparse path for point sources, one
  ``index_put_(..., accumulate=True)`` per offset in ``MOORE_OFFSETS``
  order. Out-of-bounds neighbors are dropped outright: their shares land
  in a discarded slot past the grid (a boolean mask would read the
  device on the host for its count).
- ``scalar_const``: a 0-d constant on a device, made once and cached.

The operation order is the reference's (``share = outflow / counts``, then
``values - outflow + Σ shifts`` in offset order), so at f64 the results
match the JAX package bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.cell import MOORE_OFFSETS


_SCALARS: dict = {}


def scalar_const(value, dtype, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, made once per
    (value, dtype, device) and reused: a tensor made from a host number is
    a host-to-device copy the card waits for, so a step must not make one
    each call. Callers must not write into it."""
    key = (float(value), dtype, torch.device(device))
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(float(value), dtype=dtype,
                                         device=device)
    return t


def shift2d(x: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """result[i, j] = x[i+dx, j+dy] if in bounds else 0 (dx, dy ∈ {-1,0,1})."""
    h, w = x.shape[-2], x.shape[-1]
    padded = F.pad(x, (1, 1, 1, 1))
    return padded[..., 1 + dx:1 + dx + h, 1 + dy:1 + dy + w]


def gather_neighbors(share: torch.Tensor,
                     offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS
                     ) -> torch.Tensor:
    """inflow[c] = Σ_d share[c + d] over in-bounds neighbors."""
    inflow = torch.zeros_like(share)
    for dx, dy in offsets:
        inflow = inflow + shift2d(share, dx, dy)
    return inflow


def neighbor_counts(
    shape: tuple[int, int],
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    origin: tuple[int, int] = (0, 0),
    global_shape: tuple[int, int] = None,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Per-cell in-bounds neighbor counts computed on the device from
    ``arange`` (counterpart of ``neighbor_counts_traced``): no host grid is
    built or copied."""
    h, w = shape
    gx, gy = global_shape if global_shape is not None else (h, w)
    x0, y0 = origin
    rows = x0 + torch.arange(h, device=device)[:, None]
    cols = y0 + torch.arange(w, device=device)[None, :]
    cnt = None
    for dx, dy in offsets:
        ok = ((rows + dx >= 0) & (rows + dx < gx)
              & (cols + dy >= 0) & (cols + dy < gy))
        c = ok.to(dtype)
        cnt = c if cnt is None else cnt + c
    return cnt


def weighted_counts(
    shape: tuple[int, int],
    offsets: Sequence[tuple[int, int]],
    weights: Sequence[float],
    origin: tuple[int, int] = (0, 0),
    global_shape: tuple[int, int] = None,
    dtype=torch.float32,
    device=None,
    *,
    rows: Optional[torch.Tensor] = None,
    cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-cell sum of the in-bounds taps' weights (counterpart of
    ``weighted_counts_traced``): the divisor of the weighted ``Transport``
    term (``ir.terms.Transport(weights=...)``). With unit weights it equals
    ``neighbor_counts``. The cells are the ``shape`` block at ``origin``,
    or, where ``rows`` (``[..., h, 1]``) and ``cols`` (``[..., 1, w]``)
    give their global coordinates, the cells those index (the active
    engine's windows)."""
    h, w = shape
    gx, gy = global_shape if global_shape is not None else (h, w)
    if rows is None:
        x0, y0 = origin
        rows = x0 + torch.arange(h, device=device)[:, None]
        cols = y0 + torch.arange(w, device=device)[None, :]
    cnt = None
    for wt, (dx, dy) in zip(weights, offsets):
        ok = ((rows + dx >= 0) & (rows + dx < gx)
              & (cols + dy >= 0) & (cols + dy < gy))
        c = ok.to(dtype) * torch.tensor(wt, dtype=dtype, device=ok.device)
        cnt = c if cnt is None else cnt + c
    return cnt


def transport(values: torch.Tensor, outflow: torch.Tensor,
              counts: torch.Tensor,
              offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One mass-conserving redistribution step over the whole grid.
    ``out`` (a tensor of the result's shape and dtype that aliases no
    input) receives the result in place of a fresh tensor, with the same
    operations."""
    share = outflow / counts
    return torch.add(values - outflow, gather_neighbors(share, offsets),
                     out=out)


def flow_step(values: torch.Tensor, rate_field: torch.Tensor,
              counts: torch.Tensor,
              offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS
              ) -> torch.Tensor:
    """Dense flow step: ``outflow = rate_field * values`` then transport."""
    return transport(values, rate_field * values, counts, offsets)


def point_flow_step(
    values: torch.Tensor,
    src_x: torch.Tensor,
    src_y: torch.Tensor,
    amount: torch.Tensor,
    counts: torch.Tensor,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
) -> torch.Tensor:
    """Sparse single/multi-source step. ``src_x``/``src_y``/``amount`` have
    shape ``[k]``: each source sheds ``amount[i]`` and every in-bounds
    neighbor gains ``amount[i] / counts[src]``. Returns a new tensor."""
    h, w = values.shape
    share = amount / counts[src_x, src_y]
    # the grid flattened, with one discarded slot past it: an off-grid
    # neighbour's share lands there, so no in-grid cell sees an extra add
    # and nothing reads the device on the host
    trash = h * w
    flat = torch.cat([values.reshape(-1), values.new_zeros(1)])
    flat.index_put_((src_x * w + src_y,), -amount, accumulate=True)
    for dx, dy in offsets:
        nx, ny = src_x + dx, src_y + dy
        valid = (nx >= 0) & (nx < h) & (ny >= 0) & (ny < w)
        flat.index_put_((torch.where(valid, nx * w + ny, trash),), share,
                        accumulate=True)
    return flat[:trash].reshape(h, w)
