"""CellularSpace: the grid state as a dict of named channel tensors
(counterpart of ``mpi_model_tpu/core/cellular_space.py``).

Every channel is a ``[dim_x, dim_y]`` tensor on ONE explicit device. A space
made without a device lives on the card: ``device=None`` means ``"cuda"``,
and with no CUDA device ``create`` raises instead of quietly running on the
CPU. Pass ``device="cpu"`` to ask for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..abstraction import get_abstraction_data_type, to_torch
from .attribute import Attribute
from .cell import MOORE_OFFSETS, Cell

#: Default attribute channel name.
DEFAULT_ATTR = "value"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is asked for (explicitly or by default)
    and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default. Pass device='cpu' to run on the CPU.")
    return dev


def first_float_dtype(values: Mapping[str, Any]):
    """Dtype of the first FLOATING channel (the flow/transport dtype of a
    mixed-dtype space), falling back to the first channel."""
    first = None
    for v in values.values():
        if first is None:
            first = v.dtype
        if v.dtype.is_floating_point:
            return v.dtype
    return first


@dataclasses.dataclass(frozen=True)
class Partition:
    """One shard of the global grid: origin + extent (+ owner rank)."""

    x_init: int
    y_init: int
    height: int
    width: int
    rank: int = 0

    def contains(self, x: int, y: int) -> bool:
        return (self.x_init <= x < self.x_init + self.height
                and self.y_init <= y < self.y_init + self.width)

    def local(self, x: int, y: int) -> tuple[int, int]:
        return x - self.x_init, y - self.y_init

    def describe(self) -> str:
        return f"{self.x_init}|{self.y_init}:{self.height}|{self.width}"

    @staticmethod
    def parse(s: str) -> "Partition":
        xy, hw = s.split(":")
        x, y = xy.split("|")
        h, w = hw.split("|")
        return Partition(int(x), int(y), int(h), int(w))


def row_partitions(dim_x: int, dim_y: int, n: int) -> list[Partition]:
    """1-D row-striped decomposition; remainder rows go to the last."""
    base = dim_x // n
    parts = []
    for r in range(n):
        h = base if r < n - 1 else dim_x - base * (n - 1)
        parts.append(Partition(r * base, 0, h, dim_y, rank=r))
    return parts


def block_partitions(dim_x: int, dim_y: int, lines: int,
                     columns: int) -> list[Partition]:
    """2-D block decomposition, remainder-safe, row-major ranks."""
    bx, by = dim_x // lines, dim_y // columns
    parts = []
    for i in range(lines):
        h = bx if i < lines - 1 else dim_x - bx * (lines - 1)
        for j in range(columns):
            w = by if j < columns - 1 else dim_y - by * (columns - 1)
            parts.append(Partition(i * bx, j * by, h, w, rank=i * columns + j))
    return parts


@dataclasses.dataclass
class CellularSpace:
    """The grid: named attribute channels over a dim_x × dim_y cell space.

    ``dim_x``/``dim_y`` are the local extent (every channel's shape). A
    partition of a larger grid carries its global origin and the global
    dims, against which neighbor counts are evaluated.
    """

    values: dict[str, torch.Tensor]
    dim_x: int
    dim_y: int
    x_init: int = 0
    y_init: int = 0
    global_dim_x: Optional[int] = None
    global_dim_y: Optional[int] = None

    @staticmethod
    def create(
        dim_x: int,
        dim_y: int,
        attributes: Union[None, float, Mapping[str, Any]] = None,
        dtype: Any = "float32",
        x_init: int = 0,
        y_init: int = 0,
        global_dim_x: Optional[int] = None,
        global_dim_y: Optional[int] = None,
        device=None,
    ) -> "CellularSpace":
        """Build a grid with every cell of every channel set to its init
        value. A channel's entry may be a scalar (stored in ``dtype``) or
        an ``(init, dtype)`` pair. ``device=None`` means the card."""
        dev = resolve_device(device)
        tdt = to_torch(get_abstraction_data_type(dtype))
        if attributes is None:
            attributes = {DEFAULT_ATTR: 1.0}
        elif isinstance(attributes, (int, float)):
            attributes = {DEFAULT_ATTR: float(attributes)}
        vals = {}
        for name, init in attributes.items():
            if isinstance(init, tuple):
                iv, idt = init
                cdt = to_torch(get_abstraction_data_type(idt))
            else:
                iv, cdt = init, tdt
            vals[name] = torch.full((dim_x, dim_y), iv, dtype=cdt, device=dev)
        return CellularSpace(vals, dim_x, dim_y, x_init, y_init,
                             global_dim_x, global_dim_y)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dim_x, self.dim_y)

    @property
    def global_shape(self) -> tuple[int, int]:
        return (self.global_dim_x or self.dim_x, self.global_dim_y or self.dim_y)

    @property
    def is_partition(self) -> bool:
        return self.global_shape != self.shape or (self.x_init, self.y_init) != (0, 0)

    @property
    def dtype(self) -> torch.dtype:
        """The flow/transport dtype: the first floating channel's."""
        return first_float_dtype(self.values)

    @property
    def device(self) -> torch.device:
        return next(iter(self.values.values())).device

    def _local_index(self, x: int, y: int) -> tuple[int, int]:
        lx, ly = x - self.x_init, y - self.y_init
        if not (0 <= lx < self.dim_x and 0 <= ly < self.dim_y):
            raise IndexError(
                f"global cell ({x}, {y}) is outside this partition "
                f"[{self.x_init}:{self.x_init + self.dim_x}, "
                f"{self.y_init}:{self.y_init + self.dim_y})")
        return lx, ly

    def get_cell(self, x: int, y: int, attr: str = DEFAULT_ATTR) -> Cell:
        lx, ly = self._local_index(x, y)
        v = float(self.values[attr][lx, ly])
        return Cell(x, y, Attribute(attr, v)).set_neighbor(*self.global_shape)

    def total(self, attr: Optional[str] = None):
        """Sum of one channel (or all channels). Accumulation dtypes follow
        the JAX package: f64 sums in f64, other floats in f32, integer
        channels on the host in int64. Returns a 0-dim tensor (an int for
        integer channels)."""
        if attr is not None:
            v = self.values[attr]
            if not v.dtype.is_floating_point:
                return int(v.cpu().numpy().sum(dtype=np.int64))
            acc = torch.float64 if v.dtype == torch.float64 else torch.float32
            return torch.sum(v, dtype=acc)
        return sum(self.total(a) for a in self.values)

    def neighbor_counts(self, offsets=MOORE_OFFSETS) -> torch.Tensor:
        """Per-cell neighbor-count grid on the space's device (the
        transport divisor), against the global bounds."""
        from ..ops.stencil import neighbor_counts

        return neighbor_counts(self.shape, offsets, (self.x_init, self.y_init),
                               self.global_shape, self.dtype, self.device)

    def with_values(self, values: Mapping[str, torch.Tensor]) -> "CellularSpace":
        return dataclasses.replace(self, values=dict(values))

    def slice_partition(self, p: Partition) -> "CellularSpace":
        """One partition of this space as a space of its own (views of the
        channels), with its global origin and this space's global dims."""
        lx, ly = p.x_init - self.x_init, p.y_init - self.y_init
        vals = {k: v[lx:lx + p.height, ly:ly + p.width]
                for k, v in self.values.items()}
        gdx, gdy = self.global_shape
        return CellularSpace(vals, p.height, p.width, p.x_init, p.y_init,
                             gdx, gdy)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every channel (bf16 channels come back as float32,
        which holds every bf16 value exactly)."""
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                for k, v in self.values.items()}
