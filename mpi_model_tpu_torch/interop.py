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
- ``ensemble_from_numpy``: a batch of scenarios (numpy channels and flow
  specs per lane) as an ``EnsembleSpace`` and one ``Model`` per lane.
- ``ring_from_numpy``: a shard's ghost ring (the JAX package's
  ``exchange_ring`` output or ``oracle.ring_from_global_np``'s, as numpy
  arrays) as the dict of tensors the halo kernels take, so both packages
  step the same ring.
- ``ir_model_from_structure``: a Flow IR model from the JAX package's
  ``FlowIRModel.term_structure()`` and ``term_rates()`` (plain tuples, the
  expressions as ``fingerprint`` trees); its ``term_structure()`` equals
  the one it was built from.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import torch

from .core.attribute import Attribute
from .core.cell import Cell
from .core.cellular_space import CellularSpace, resolve_device
from .ops.flow import Coupled, Diffusion, Exponencial, Flow, PointFlow

if TYPE_CHECKING:
    from .ensemble.batch import EnsembleSpace
    from .models.model import Model

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


def ring_from_numpy(ring: dict, device=None) -> dict[str, torch.Tensor]:
    """A ghost ring's eight pieces (``n``/``s`` ``[d, w]``, ``w``/``e``
    ``[h, d]``, four ``[d, d]`` corners, numpy arrays or anything
    ``np.asarray`` takes) as contiguous tensors on ``device`` (None means
    the card); bf16 pieces as in ``space_from_numpy``."""
    from .ops.fused_stencil import RING_PIECES

    dev = resolve_device(device)
    missing = [p for p in RING_PIECES if p not in ring]
    if missing:
        raise ValueError(f"the ring lacks the pieces {missing}")
    return {p: _to_tensor(np.asarray(ring[p]), dev) for p in RING_PIECES}


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


def ensemble_from_numpy(values_per_lane: Sequence[dict[str, np.ndarray]],
                        flow_specs_per_lane: Sequence[Sequence[dict]], *,
                        device=None) -> tuple["EnsembleSpace", list["Model"]]:
    """A batch of scenarios: lane i's channels (``space_from_numpy``) and
    its flows (``flows_from_specs``) become an ``EnsembleSpace`` on
    ``device`` (None means the card) and lane i's ``Model``. The lanes must
    share geometry, channels and flow structure (``EnsembleSpace.stack``
    and ``run_ensemble`` refuse them otherwise)."""
    from .ensemble.batch import EnsembleSpace
    from .models.model import Model

    if len(values_per_lane) != len(flow_specs_per_lane):
        raise ValueError(
            f"{len(values_per_lane)} lanes of values for "
            f"{len(flow_specs_per_lane)} lanes of flow specs")
    spaces = [space_from_numpy(v, device=device) for v in values_per_lane]
    models = [Model(flows_from_specs(specs)) for specs in flow_specs_per_lane]
    return EnsembleSpace.stack(spaces), models


def ir_model_from_structure(term_structure, rates: Sequence[float],
                            offsets=None, time: float = 1.0,
                            time_step: float = 1.0,
                            active_opts: Optional[dict] = None):
    """The port's ``FlowIRModel`` from a ``term_structure()`` pair (the
    terms' ``structure()`` tuples, then the offsets) and the per-term
    ``rates``. ``offsets`` overrides the pair's. Each structure is
    ``("Transport", name, channel, weights)``, ``("Transfer", name, src,
    dst, expr)``, ``("Source", name, channel, expr)`` or ``("Sink", name,
    channel, expr)``, an expression as ``ir.expr.fingerprint`` gives it."""
    from .ir import FlowIRModel, Sink, Source, Transfer, Transport
    from .ir.expr import from_fingerprint

    structures, pair_offsets = term_structure
    structures = tuple(structures)
    if len(rates) != len(structures):
        raise ValueError(f"{len(rates)} rates for {len(structures)} terms")
    terms = []
    for st, rate in zip(structures, rates):
        kind, name = st[0], st[1]
        if kind == "Transport":
            terms.append(Transport(st[2], rate=rate, weights=st[3],
                                   name=name))
        elif kind == "Transfer":
            terms.append(Transfer(st[2], st[3], from_fingerprint(st[4]),
                                  rate=rate, name=name))
        elif kind in ("Source", "Sink"):
            cls = Source if kind == "Source" else Sink
            terms.append(cls(st[2], from_fingerprint(st[3]), rate=rate,
                             name=name))
        else:
            raise ValueError(f"unknown term kind {kind!r}; expected "
                             "Transport, Transfer, Source or Sink")
    offsets = pair_offsets if offsets is None else offsets
    return FlowIRModel(terms, time, time_step,
                       offsets=tuple(tuple(int(v) for v in o)
                                     for o in offsets),
                       active_opts=active_opts)
