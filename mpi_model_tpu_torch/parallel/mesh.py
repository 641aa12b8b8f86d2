"""Device meshes and grid sharding: the decomposition layer (counterpart of
``mpi_model_tpu/parallel/mesh.py``).

The reference decomposes its grid into 1-D row stripes
(``/root/reference/src/Model.hpp:62-76``) or a ``LINES_REC × COLUMNS_REC``
block grid (``ModelRectangular.hpp:69-80``). Here a ``Mesh`` is that
decomposition: axis names, an ``[L, C]`` shape, the ``torch.device`` of
every position and the process that owns it. In one process every position
is its own (the JAX package's ``shard_map`` is single-controller too); the
device list may name one device several times, so a 2×2 or 1×4
decomposition runs on one card (or on the CPU, as the tests run it) with
every shard a tensor of its own. In a ``torch.distributed`` world of P
processes (``parallel.multihost``) the positions go row-major by rank, P
equal runs of them, as the JAX package's ``np.array(jax.devices())
.reshape(...)`` lays out the global devices; each process drives its own
positions, on its own devices.

- ``make_mesh`` / ``make_mesh_2d`` build a mesh from an explicit
  ``devices=`` list, by default every visible CUDA card placed round-robin
  over the positions (in a world above one, this process's card at each of
  its positions); with no card they raise (nothing moves to the CPU by
  itself).
- ``factor2d``, ``resolve_grid2d`` and ``grid_spec`` are the JAX
  package's, unchanged (a spec is a tuple where JAX has a
  ``PartitionSpec``).
- ``put_global`` cuts one global tensor into per-shard contiguous tensors
  on the shards' devices, this process's positions only (``None`` at the
  others: each process supplies its own blocks from its identical copy, as
  JAX's multi-host ``put_global`` does); ``shard_space`` does so for each
  channel; ``assemble`` puts them back together, gathering the positions
  other processes own. ``mesh_spans_processes`` says whether a mesh's
  positions belong to more than one process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..core.cellular_space import CellularSpace
from . import multihost

#: shards of one channel: ``grid[i][j]`` is the tensor at mesh position (i, j),
#: None where another process owns the position
ShardGrid = list[list[Optional[torch.Tensor]]]


def layout_owners(lines: int, columns: int, nprocs: int
                  ) -> Optional[tuple[tuple[int, ...], ...]]:
    """The owner of each position of an ``[L, C]`` mesh over ``nprocs``
    processes: row-major, ``L·C / nprocs`` positions each; None for one
    process. Raises when the positions do not divide over the processes."""
    if nprocs == 1:
        return None
    n = lines * columns
    if n % nprocs:
        raise ValueError(
            f"a {lines}x{columns} mesh ({n} positions) does not divide over "
            f"{nprocs} processes: each process must own as many positions")
    per = n // nprocs
    return tuple(tuple((i * columns + j) // per for j in range(columns))
                 for i in range(lines))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``[L, C]`` arrangement of devices with named axes (one name for a
    1-D mesh, whose columns are then unsplit: ``C == 1``)."""

    axis_names: tuple[str, ...]
    devices: tuple[tuple[torch.device, ...], ...]
    #: the process that owns each position (``layout_owners``); None: one
    #: process owns every position
    owners: Optional[tuple[tuple[int, ...], ...]] = None

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

    def owner(self, i: int, j: int) -> int:
        """The process that owns position (i, j)."""
        return 0 if self.owners is None else self.owners[i][j]

    def cells_of(self, rank: int) -> list[tuple[int, int]]:
        """Process ``rank``'s positions, row-major."""
        lines, columns = self.grid_shape
        return [(i, j) for i in range(lines) for j in range(columns)
                if self.owner(i, j) == rank]

    def local_cells(self) -> list[tuple[int, int]]:
        """This process's positions, row-major (every position in one
        process)."""
        if self.owners is None:
            lines, columns = self.grid_shape
            return [(i, j) for i in range(lines) for j in range(columns)]
        return self.cells_of(multihost.process_index())

    @property
    def multiprocess(self) -> bool:
        """Whether positions belong to more than one process."""
        return self.owners is not None and len(
            {r for row in self.owners for r in row}) > 1

    def home_device(self) -> torch.device:
        """The device of this process's first position: where its run's
        global tensors are assembled."""
        i, j = self.local_cells()[0]
        return self.device(i, j)

    def distinct_devices(self) -> list[torch.device]:
        """The devices of this process's positions, each once, in
        first-seen order."""
        seen: list[torch.device] = []
        for i, j in self.local_cells():
            d = self.device(i, j)
            if d not in seen:
                seen.append(d)
        return seen


def _devices(devices=None, n: Optional[int] = None) -> list[torch.device]:
    """``devices`` as a list of ``torch.device``, or by default every
    visible CUDA card placed round-robin over ``n`` positions (one per card
    when ``n`` is None); in a world above one process, this process's card
    (``torch.cuda.current_device()``) at each of the ``n`` positions.
    Raises without a card: the default is the card."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; a mesh runs on the card by "
            "default. Pass devices=[torch.device('cpu')] * n to run on the "
            "CPU.")
    if multihost.process_count() > 1 and n is not None:
        return [torch.device("cuda", torch.cuda.current_device())] * n
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is None:
        return cards
    return [cards[i % len(cards)] for i in range(n)]


def _mesh(axes: tuple[str, ...], rows: list[list[torch.device]]) -> Mesh:
    """The mesh of ``rows``, its positions laid over the world's
    processes."""
    return Mesh(tuple(axes), tuple(tuple(r) for r in rows),
                layout_owners(len(rows), len(rows[0]),
                              multihost.process_count()))


def make_mesh(n: Optional[int] = None, axis: str = "x",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh of ``n`` positions: the row-striping decomposition (the
    reference's NWORKERS stripes, ``Defines.hpp:7-8``). ``n`` defaults to
    the number of devices given (or of visible cards)."""
    devs = _devices(devices, n)
    n = len(devs) if n is None else int(n)
    if n < 1 or n > len(devs):
        raise ValueError(f"mesh of {n} needs {n} devices, have {len(devs)}")
    return _mesh((axis,), [[d] for d in devs[:n]])


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
    return _mesh(tuple(axes), [devs[i * columns:(i + 1) * columns]
                               for i in range(lines)])


def grid_spec(mesh: Mesh) -> tuple[Optional[str], Optional[str]]:
    """The spec that shards grid rows over the first mesh axis and (for a
    2-D mesh) columns over the second: one entry a grid dimension, a mesh
    axis name or None (the JAX package's ``PartitionSpec``)."""
    names = mesh.axis_names
    return (names[0], names[1] if len(names) > 1 else None)


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh's positions belong to more than one process of a
    ``torch.distributed`` world (multi-host: a rank is a process)."""
    return mesh.multiprocess


def _block_shape(dims: tuple[int, int], mesh: Mesh) -> tuple[int, int]:
    """Per-shard (rows, columns) of a grid of ``dims`` on ``mesh``; raises
    the JAX package's error for a grid a mesh extent does not divide."""
    lines, columns = mesh.grid_shape
    for axis_idx, (name, n) in enumerate(zip(mesh.axis_names,
                                             (lines, columns))):
        if dims[axis_idx] % n != 0:
            raise ValueError(
                f"grid dim {dims[axis_idx]} along '{name}' not divisible by "
                f"mesh extent {n} (the reference's PROC_DIMX=DIMX/NWORKERS "
                f"divisibility requirement, Defines.hpp:8)")
    return dims[0] // lines, dims[1] // columns


def shard_bounds(space: CellularSpace, mesh: Mesh) -> tuple[int, int]:
    """Per-shard (rows, columns) of ``space`` on ``mesh``."""
    return _block_shape((space.dim_x, space.dim_y), mesh)


def shard_tensor(t: torch.Tensor, mesh: Mesh, h: int, w: int) -> ShardGrid:
    """``t`` cut into the mesh's ``[h, w]`` blocks, each a contiguous copy on
    its position's device; None at the positions another process owns."""
    lines, columns = mesh.grid_shape
    grid: ShardGrid = [[None] * columns for _ in range(lines)]
    for i, j in mesh.local_cells():
        grid[i][j] = t[i * h:(i + 1) * h, j * w:(j + 1) * w].to(
            mesh.device(i, j), copy=True).contiguous()
    return grid


def put_global(value: torch.Tensor, mesh: Mesh) -> ShardGrid:
    """Place one global ``[H, W]`` tensor onto the mesh: its blocks, each a
    contiguous copy on its position's device, this process's positions
    only (None at the others). Requires dims divisible by the mesh extent
    along each axis."""
    h, w = _block_shape(tuple(value.shape), mesh)
    return shard_tensor(value, mesh, h, w)


def shard_space(space: CellularSpace, mesh: Mesh) -> dict[str, ShardGrid]:
    """Place the space's channels onto the mesh (the live ``Scatter``):
    ``put_global`` of each channel."""
    return {k: put_global(v, mesh) for k, v in space.values.items()}


def assemble(grid: ShardGrid, device: torch.device) -> torch.Tensor:
    """The global tensor of one channel's shards, on ``device``; positions
    another process owns (None) are gathered from it
    (``collectives.gather_grid``: one all-gather)."""
    if any(t is None for row in grid for t in row):
        from .collectives import gather_grid

        return gather_grid(grid, device, collective=True)
    h, w = grid[0][0].shape
    lines, columns = len(grid), len(grid[0])
    out = torch.empty((lines * h, columns * w), dtype=grid[0][0].dtype,
                      device=device)
    for i in range(lines):
        for j in range(columns):
            out[i * h:(i + 1) * h, j * w:(j + 1) * w].copy_(
                grid[i][j], non_blocking=True)
    return out
