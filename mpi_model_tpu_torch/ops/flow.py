"""Flow: update rules attached to the cellular space (counterpart of
``mpi_model_tpu/ops/flow.py``).

A Flow produces an **outflow field**: a ``[dim_x, dim_y]`` tensor of how much
each cell sheds this step. Flows on one channel sum their outflows and one
``transport`` redistributes them. ``PointFlow``/``Exponencial`` anchored at a
``Cell`` snapshot that cell's value (``frozen_source_value``), as the
reference holds its flow's source cell by value. ``cell_coords`` gives a
pointwise flow its cells' global coordinates, also when the field kernel K4
lowers the flow (``ops.field_lower``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..core.cell import Cell
from ..core.cellular_space import DEFAULT_ATTR, CellularSpace
from .stencil import scalar_const


def _rate_tensor(rate, like: torch.Tensor) -> torch.Tensor:
    """A flow's rate as a tensor in ``like``'s dtype: a Python float is
    rounded once; a tensor (the ensemble engine's ``[B, 1, 1]`` lane, already
    in the channel's dtype) is taken as it is."""
    if isinstance(rate, torch.Tensor):
        return rate
    return scalar_const(rate, like.dtype, like.device)


def _source_xy(source) -> tuple[int, int]:
    if isinstance(source, Cell):
        return source.x, source.y
    x, y = source
    return int(x), int(y)


class Flow(abc.ABC):
    """An update rule producing the per-cell outflow of one channel.

    ``footprint`` says what the outflow reads: ``"pointwise"`` (the cell's
    own channels), ``"ring1"`` (the 3x3 neighborhood; implement
    ``outflow_padded``) or ``"unknown"``.
    """

    attr: str = DEFAULT_ATTR
    flow_rate: float = 0.0
    footprint: str = "unknown"

    def outflow(self, values: dict[str, torch.Tensor],
                origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        """Outflow field for ``self.attr``; ring1 flows get their channels
        zero-padded one cell and delegated to ``outflow_padded``."""
        if self.footprint == "ring1":
            padded = {k: F.pad(v, (1, 1, 1, 1)) for k, v in values.items()}
            return self.outflow_padded(padded, origin)
        raise NotImplementedError(
            f"{type(self).__name__} must implement outflow() (or declare "
            "footprint='ring1' and implement outflow_padded)")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if (cls.__dict__.get("footprint") == "ring1"
                and "outflow_padded" not in cls.__dict__
                and "outflow" not in cls.__dict__):
            raise TypeError(
                f"{cls.__name__} declares footprint='ring1' but implements "
                "neither outflow_padded nor outflow")

    def outflow_padded(self, padded_values: dict[str, torch.Tensor],
                       origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        """ring1 flows: outflow ``[h, w]`` from one-cell padded channels."""
        raise NotImplementedError(
            f"{type(self).__name__} declares footprint='ring1' but does "
            "not implement outflow_padded")

    def execute(self, space_or_values=None,
                origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        """Total amount moved this step."""
        if isinstance(space_or_values, CellularSpace):
            origin = (space_or_values.x_init, space_or_values.y_init)
            values = space_or_values.values
        else:
            values = space_or_values
        return torch.sum(self.outflow(values, origin))

    def fingerprint(self) -> tuple:
        """Hashable identity of this flow's parameters (a step-cache key
        component, so mutating a flow invalidates cached steps)."""
        if dataclasses.is_dataclass(self):
            attrs = {f.name: getattr(self, f.name)
                     for f in dataclasses.fields(self)}
        else:
            attrs = vars(self)
        items = tuple(
            (k, v if isinstance(v, (int, float, str, bool, tuple, type(None)))
             else repr(v))
            for k, v in sorted(attrs.items()))
        return (type(self).__name__, items)


@dataclasses.dataclass
class PointFlow(Flow):
    """A flow anchored at one source cell; sheds to the source's neighbors.
    ``source`` is a ``Cell`` or an ``(x, y)`` pair."""

    source: Union[Cell, tuple[int, int]]
    flow_rate: float
    attr: str = DEFAULT_ATTR
    frozen_source_value: Optional[float] = None
    footprint = "pointwise"

    def __post_init__(self):
        if (isinstance(self.source, Cell)
                and self.frozen_source_value is None
                and self.source.attribute is not None):
            # constructing from a Cell snapshots its attribute value
            self.frozen_source_value = self.source.attribute.value

    @property
    def source_xy(self) -> tuple[int, int]:
        return _source_xy(self.source)

    def local_source(self, values: dict[str, torch.Tensor],
                     origin: tuple[int, int] = (0, 0)) -> tuple[int, int, bool]:
        """(local_x, local_y, in_partition) for this source under origin."""
        x, y = self.source_xy
        lx, ly = x - origin[0], y - origin[1]
        h, w = values[self.attr].shape[-2], values[self.attr].shape[-1]
        return lx, ly, (0 <= lx < h and 0 <= ly < w)

    def amount(self, values: dict[str, torch.Tensor],
               origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        """Amount shed this step: rate × (snapshot or current value); zero
        when the source lies outside this partition."""
        ch = values[self.attr]
        lx, ly, inside = self.local_source(values, origin)
        if not inside:
            return torch.zeros((), dtype=ch.dtype, device=ch.device)
        if self.frozen_source_value is not None:
            return torch.tensor(self.flow_rate * self.frozen_source_value,
                                dtype=ch.dtype, device=ch.device)
        return self.flow_rate * ch[lx, ly]

    def outflow(self, values: dict[str, torch.Tensor],
                origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        z = torch.zeros_like(values[self.attr])
        lx, ly, inside = self.local_source(values, origin)
        if inside:
            z[lx, ly] = self.amount(values, origin)
        return z


@dataclasses.dataclass
class Exponencial(PointFlow):
    """``execute() = flow_rate * source_value``."""

    def execute_scalar(self, cell: Optional[Cell] = None) -> float:
        if cell is not None:
            return self.flow_rate * cell.attribute.value
        if self.frozen_source_value is not None:
            return self.flow_rate * self.frozen_source_value
        raise ValueError("no source value snapshot; pass a cell")


@dataclasses.dataclass
class Diffusion(Flow):
    """Every cell is a source: ``outflow = rate * value`` grid-wide."""

    flow_rate: float = 0.1
    attr: str = DEFAULT_ATTR
    footprint = "pointwise"

    def outflow(self, values: dict[str, torch.Tensor],
                origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        v = values[self.attr]
        return _rate_tensor(self.flow_rate, v) * v


@dataclasses.dataclass
class Coupled(Flow):
    """``outflow = rate * values[attr] * values[modulator]``."""

    flow_rate: float = 0.1
    attr: str = DEFAULT_ATTR
    modulator: str = DEFAULT_ATTR
    footprint = "pointwise"

    def outflow(self, values: dict[str, torch.Tensor],
                origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
        v = values[self.attr]
        return _rate_tensor(self.flow_rate, v) * v * values[self.modulator]


def cell_coords(v, origin: tuple[int, int] = (0, 0)):
    """Global ``(rows, cols)`` index tensors (int64, ``v``'s shape) of the
    cells of ``v``, a partition starting at ``origin``: the way for a
    pointwise flow to read its cells' coordinates. When the field kernel
    lowers a flow, ``v`` is symbolic and this returns the cell's row and
    column leaves instead (``ops.field_lower``); ``torch.arange`` cannot be
    traced that way. Cast them with ``.to(v.dtype)`` before arithmetic."""
    symbolic = getattr(v, "symbolic_cell_coords", None)
    if symbolic is not None:
        return symbolic()
    h, w = v.shape[-2], v.shape[-1]
    rows = origin[0] + torch.arange(h, device=v.device)
    cols = origin[1] + torch.arange(w, device=v.device)
    return rows[:, None].expand(h, w), cols[None, :].expand(h, w)


def build_outflow(flows: Sequence[Flow], values: dict[str, torch.Tensor],
                  origin: tuple[int, int] = (0, 0)) -> dict[str, torch.Tensor]:
    """Sum the outflow fields of all flows, grouped by channel."""
    out: dict[str, torch.Tensor] = {}
    for f in flows:
        o = f.outflow(values, origin)
        out[f.attr] = out[f.attr] + o if f.attr in out else o
    return out
