"""Cell views and neighborhood topology (counterpart of
``mpi_model_tpu/core/cell.py``).

The offset tuples are copies of the reference's, in the same order: the
transport sums neighbor shares in this order, so the order is part of the
numerical contract (a test pins the copies to the originals).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .attribute import Attribute

#: Moore-8 neighborhood offsets (dx, dy), row-major order.
MOORE_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)

#: Von Neumann (4-neighbor) offsets.
VON_NEUMANN_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, 0), (0, -1), (0, 1), (1, 0),
)


def moore_neighbors(
    x: int, y: int, dim_x: int, dim_y: int,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
) -> list[tuple[int, int]]:
    """In-bounds neighbors of global cell (x, y) on a non-periodic grid."""
    return [
        (x + dx, y + dy)
        for dx, dy in offsets
        if 0 <= x + dx < dim_x and 0 <= y + dy < dim_y
    ]


def neighbor_count_grid(
    dim_x: int,
    dim_y: int,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    dtype=np.float64,
    x_init: int = 0,
    y_init: int = 0,
    global_dim_x: Optional[int] = None,
    global_dim_y: Optional[int] = None,
) -> np.ndarray:
    """[dim_x, dim_y] numpy array of per-cell in-bounds neighbor counts,
    evaluated against the global bounds for a partition."""
    gdx = dim_x if global_dim_x is None else global_dim_x
    gdy = dim_y if global_dim_y is None else global_dim_y
    counts = np.zeros((dim_x, dim_y), dtype=dtype)
    xs = x_init + np.arange(dim_x)
    ys = y_init + np.arange(dim_y)
    for dx, dy in offsets:
        x_ok = (xs + dx >= 0) & (xs + dx < gdx)
        y_ok = (ys + dy >= 0) & (ys + dy < gdy)
        counts += np.outer(x_ok, y_ok).astype(dtype)
    return counts


@dataclasses.dataclass
class Cell:
    """Host-side scalar view of one cell; ``x`` indexes rows, ``y``
    columns."""

    x: int
    y: int
    attribute: Attribute
    neighbors: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def count_neighbors(self) -> int:
        return len(self.neighbors)

    def set_neighbor(self, dim_x: int, dim_y: int,
                     offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS) -> "Cell":
        """Compute this cell's neighborhood against the global bounds."""
        self.neighbors = moore_neighbors(self.x, self.y, dim_x, dim_y, offsets)
        return self

    def neighbor_xs(self) -> list[int]:
        return [nx for nx, _ in self.neighbors]

    def neighbor_ys(self) -> list[int]:
        return [ny for _, ny in self.neighbors]
