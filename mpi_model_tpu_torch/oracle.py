"""Serial NumPy oracle: the golden reference, kept free of torch and jax.

A copy of the JAX package's ``oracle.py`` functions that the port needs
(``chip_smoke.py`` takes its goldens from here without importing that
package); a test pins this copy to the original on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .core.cell import MOORE_OFFSETS, moore_neighbors, neighbor_count_grid


def shift2d_np(x: np.ndarray, dx: int, dy: int) -> np.ndarray:
    out = np.zeros_like(x)
    h, w = x.shape
    xs, xe = max(0, -dx), min(h, h - dx)
    ys, ye = max(0, -dy), min(w, w - dy)
    out[xs:xe, ys:ye] = x[xs + dx:xe + dx, ys + dy:ye + dy]
    return out


def transport_np(values: np.ndarray, outflow: np.ndarray,
                 counts: Optional[np.ndarray] = None,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS) -> np.ndarray:
    if counts is None:
        counts = neighbor_count_grid(*values.shape, offsets=offsets,
                                     dtype=values.dtype)
    share = outflow / counts
    inflow = np.zeros_like(values)
    for dx, dy in offsets:
        inflow += shift2d_np(share, dx, dy)
    return values - outflow + inflow


def dense_flow_step_np(values: np.ndarray, rate: float | np.ndarray,
                       offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS) -> np.ndarray:
    return transport_np(values, np.asarray(rate, dtype=values.dtype) * values,
                        offsets=offsets)


def point_flow_step_np(values: np.ndarray, x: int, y: int, amount: float,
                       offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS) -> np.ndarray:
    """Source sheds ``amount``; each in-bounds neighbor gains ``amount/k``
    where k is the source's neighbor count."""
    h, w = values.shape
    neigh = moore_neighbors(x, y, h, w, offsets)
    out = values.copy()
    out[x, y] -= amount
    for nx, ny in neigh:
        out[nx, ny] += amount / len(neigh)
    return out


def cut_np(G: np.ndarray, rs: int, re: int, cs: int, ce: int) -> np.ndarray:
    """``G[rs:re, cs:ce]`` with zero-fill outside the grid: what a ghost-ring
    exchange delivers to a shard at a true grid edge."""
    H, W = G.shape
    out = np.zeros((re - rs, ce - cs), G.dtype)
    rs_c, re_c = max(rs, 0), min(re, H)
    cs_c, ce_c = max(cs, 0), min(ce, W)
    if rs_c < re_c and cs_c < ce_c:
        out[rs_c - rs:re_c - rs, cs_c - cs:ce_c - cs] = G[rs_c:re_c,
                                                          cs_c:ce_c]
    return out


def ring_from_global_np(G: np.ndarray, r0: int, c0: int, h: int, w: int,
                        d: int) -> dict:
    """The depth-``d`` ghost ring of the shard at global offset (r0, c0),
    cut directly from the global grid (``parallel.halo.exchange_ring``'s
    layout: n/s [d, w], w/e [h, d], corners [d, d]; zeros at true grid
    edges). Ground truth for the halo kernels' checks."""
    return {
        "n": cut_np(G, r0 - d, r0, c0, c0 + w),
        "s": cut_np(G, r0 + h, r0 + h + d, c0, c0 + w),
        "w": cut_np(G, r0, r0 + h, c0 - d, c0),
        "e": cut_np(G, r0, r0 + h, c0 + w, c0 + w + d),
        "nw": cut_np(G, r0 - d, r0, c0 - d, c0),
        "ne": cut_np(G, r0 - d, r0, c0 + w, c0 + w + d),
        "sw": cut_np(G, r0 + h, r0 + h + d, c0 - d, c0),
        "se": cut_np(G, r0 + h, r0 + h + d, c0 + w, c0 + w + d),
    }


def reference_run_np(dim_x: int = 100, dim_y: int = 100,
                     src: tuple[int, int] = (19, 3),
                     snapshot_value: float = 2.2, rate: float = 0.1,
                     init: float = 1.0, steps: int = 1,
                     dtype=np.float64) -> np.ndarray:
    """The reference's live run: a 100×100 grid of 1.0, one Exponencial
    moving ``0.1 * 2.2`` out of (19, 3) per step (the snapshot value never
    updates)."""
    values = np.full((dim_x, dim_y), init, dtype=dtype)
    for _ in range(steps):
        values = point_flow_step_np(values, *src, rate * snapshot_value)
    return values
