"""Carry state across from the JAX package without importing it.

State crosses as numpy arrays and plain dicts:

- ``space_from_numpy`` / ``space_to_numpy``: grid channels. bf16 channels
  arrive as any array whose values are bf16 (e.g. ml_dtypes bfloat16) or
  are marked by a ``"bfloat16"`` dtype name, and leave as float32 arrays,
  which hold every bf16 value exactly.
- ``flows_from_specs``: flows from plain dicts such as
  ``{"type": "Diffusion", "flow_rate": 0.1, "attr": "value"}`` or an
  ``Exponencial`` with ``source`` (an ``(x, y)`` pair or a Cell dict as
  ``dataclasses.asdict`` gives it) and ``frozen_source_value``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .core.attribute import Attribute
from .core.cell import Cell
from .core.cellular_space import CellularSpace, resolve_device
from .ops.flow import Coupled, Diffusion, Exponencial, Flow, PointFlow

_FLOW_TYPES = {"Diffusion": Diffusion, "Coupled": Coupled,
               "PointFlow": PointFlow, "Exponencial": Exponencial}


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def space_from_numpy(values: dict[str, np.ndarray], *, x_init: int = 0,
                     y_init: int = 0,
                     global_shape: Optional[tuple[int, int]] = None,
                     device=None) -> CellularSpace:
    """A space holding copies of ``values`` (all ``[dim_x, dim_y]``) on
    ``device`` (None means the card)."""
    dev = resolve_device(device)
    tensors = {k: _to_tensor(np.asarray(v), dev) for k, v in values.items()}
    shapes = {tuple(t.shape) for t in tensors.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError(f"every channel must share one [dim_x, dim_y] "
                         f"shape; got {shapes}")
    dim_x, dim_y = next(iter(shapes))
    gx, gy = global_shape if global_shape is not None else (None, None)
    return CellularSpace(tensors, dim_x, dim_y, x_init, y_init, gx, gy)


def space_to_numpy(space: CellularSpace) -> dict[str, np.ndarray]:
    """Host copies of every channel (bf16 as float32)."""
    return space.to_numpy()


def _source(src):
    if isinstance(src, dict):
        attr = src.get("attribute")
        return Cell(int(src["x"]), int(src["y"]),
                    Attribute(attr["key"], attr["value"]) if attr else None)
    x, y = src
    return (int(x), int(y))


def flows_from_specs(specs: Sequence[dict]) -> list[Flow]:
    """Build the port's flows from plain dict specs (see module doc)."""
    flows = []
    for spec in specs:
        spec = dict(spec)
        kind = spec.pop("type")
        cls = _FLOW_TYPES.get(kind)
        if cls is None:
            raise ValueError(f"unknown flow type {kind!r}; expected one of "
                             f"{sorted(_FLOW_TYPES)}")
        if "source" in spec:
            spec["source"] = _source(spec["source"])
        flows.append(cls(**spec))
    return flows
