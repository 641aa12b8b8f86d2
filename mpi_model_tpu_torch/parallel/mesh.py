"""Device meshes and grid sharding: the decomposition layer (counterpart of
``mpi_model_tpu/parallel/mesh.py``).

The reference decomposes its grid into 1-D row stripes
(``/root/reference/src/Model.hpp:62-76``) or a ``LINES_REC × COLUMNS_REC``
block grid (``ModelRectangular.hpp:69-80``). Here a ``Mesh`` is one
process's view of that decomposition: axis names, an ``[L, C]`` shape and
the ``torch.device`` of every position. One Python process drives every
position (the JAX package's ``shard_map`` is single-controller too); the
device list may name one device several times, so a 2×2 or 1×4
decomposition runs on one card (or on the CPU, as the tests run it) with
every shard a tensor of its own.

- ``make_mesh`` / ``make_mesh_2d`` build a mesh from an explicit
  ``devices=`` list, by default every visible CUDA card placed round-robin
  over the positions; with no card they raise (nothing moves to the CPU by
  itself).
- ``factor2d`` and ``resolve_grid2d`` are the JAX package's, unchanged.
- ``shard_space`` cuts each channel into per-shard contiguous tensors on
  the shards' devices; ``assemble`` puts them back together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..core.cellular_space import CellularSpace

#: shards of one channel: ``grid[i][j]`` is the tensor at mesh position (i, j)
ShardGrid = list[list[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``[L, C]`` arrangement of devices with named axes (one name for a
    1-D mesh, whose columns are then unsplit: ``C == 1``)."""

    axis_names: tuple[str, ...]
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """Extent per axis name, as ``jax.sharding.Mesh.shape`` gives it."""
        ext = (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axis_names, ext))

    @property
    def grid_shape(self) -> tuple[int, int]:
        """(lines, columns) of the decomposition; 1-D meshes have 1 column."""
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        lines, columns = self.grid_shape
        return lines * columns

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    def distinct_devices(self) -> list[torch.device]:
        """The devices the mesh names, each once, in first-seen order."""
        seen: list[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def _devices(devices=None, n: Optional[int] = None) -> list[torch.device]:
    """``devices`` as a list of ``torch.device``, or by default every
    visible CUDA card placed round-robin over ``n`` positions (one per card
    when ``n`` is None). Raises without a card: the default is the card."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; a mesh runs on the card by "
            "default. Pass devices=[torch.device('cpu')] * n to run on the "
            "CPU.")
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is None:
        return cards
    return [cards[i % len(cards)] for i in range(n)]


def make_mesh(n: Optional[int] = None, axis: str = "x",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh of ``n`` positions: the row-striping decomposition (the
    reference's NWORKERS stripes, ``Defines.hpp:7-8``). ``n`` defaults to
    the number of devices given (or of visible cards)."""
    devs = _devices(devices, n)
    n = len(devs) if n is None else int(n)
    if n < 1 or n > len(devs):
        raise ValueError(f"mesh of {n} needs {n} devices, have {len(devs)}")
    return Mesh((axis,), tuple((d,) for d in devs[:n]))


def factor2d(n: int) -> tuple[int, int]:
    """Most-square (lines, columns) factorization of n devices."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def resolve_grid2d(lines: Optional[int], columns: Optional[int],
                   n: int) -> tuple[int, int]:
    """The (lines, columns) a 2-D decomposition of ``n`` devices resolves
    to: most-square factorization when both are None, ``n // given``
    one-sided. The single source of this defaulting — ``make_mesh_2d`` and
    ``ModelRectangular``'s partition geometry both call it."""
    if lines is None and columns is None:
        return factor2d(n)
    if lines is None:
        return n // columns, columns
    if columns is None:
        return lines, n // lines
    return lines, columns


def make_mesh_2d(lines: Optional[int] = None, columns: Optional[int] = None,
                 axes: tuple[str, str] = ("x", "y"),
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh, the block decomposition (``DefinesRectangular.hpp:7-8``:
    LINES_REC × COLUMNS_REC). With ``lines`` and ``columns`` both given and
    no ``devices``, the visible cards are placed round-robin over the
    ``lines × columns`` positions; otherwise the positions come from the
    device count (most-square factorization when neither is given)."""
    want = (lines * columns if lines is not None and columns is not None
            else None)
    devs = _devices(devices, want)
    lines, columns = resolve_grid2d(lines, columns, len(devs))
    n = lines * columns
    if n == 0 or n > len(devs):
        raise ValueError(
            f"mesh {lines}x{columns} needs {n} devices, have {len(devs)}")
    return Mesh(tuple(axes), tuple(tuple(devs[i * columns:(i + 1) * columns])
                                   for i in range(lines)))


def shard_bounds(space: CellularSpace, mesh: Mesh) -> tuple[int, int]:
    """Per-shard (rows, columns) of ``space`` on ``mesh``; raises the JAX
    package's error for a grid a mesh extent does not divide."""
    lines, columns = mesh.grid_shape
    dims = (space.dim_x, space.dim_y)
    for axis_idx, (name, n) in enumerate(zip(mesh.axis_names,
                                             (lines, columns))):
        if dims[axis_idx] % n != 0:
            raise ValueError(
                f"grid dim {dims[axis_idx]} along '{name}' not divisible by "
                f"mesh extent {n} (the reference's PROC_DIMX=DIMX/NWORKERS "
                f"divisibility requirement, Defines.hpp:8)")
    return space.dim_x // lines, space.dim_y // columns


def shard_tensor(t: torch.Tensor, mesh: Mesh, h: int, w: int) -> ShardGrid:
    """``t`` cut into the mesh's ``[h, w]`` blocks, each a contiguous copy on
    its position's device."""
    lines, columns = mesh.grid_shape
    return [[t[i * h:(i + 1) * h, j * w:(j + 1) * w].to(
        mesh.device(i, j), copy=True).contiguous()
        for j in range(columns)] for i in range(lines)]


def shard_space(space: CellularSpace, mesh: Mesh) -> dict[str, ShardGrid]:
    """Place the space's channels onto the mesh (the live ``Scatter``): per
    channel, a grid of per-shard contiguous tensors on the shards' devices.
    Requires dims divisible by the mesh extent along each sharded axis."""
    h, w = shard_bounds(space, mesh)
    return {k: shard_tensor(v, mesh, h, w) for k, v in space.values.items()}


def assemble(grid: ShardGrid, device: torch.device) -> torch.Tensor:
    """The global tensor of one channel's shards, on ``device``."""
    h, w = grid[0][0].shape
    lines, columns = len(grid), len(grid[0])
    out = torch.empty((lines * h, columns * w), dtype=grid[0][0].dtype,
                      device=device)
    for i in range(lines):
        for j in range(columns):
            out[i * h:(i + 1) * h, j * w:(j + 1) * w].copy_(
                grid[i][j], non_blocking=True)
    return out
