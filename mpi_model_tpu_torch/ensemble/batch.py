"""Ensemble batching: B independent scenarios stepped together (counterpart
of ``mpi_model_tpu/ensemble/batch.py``).

- ``EnsembleSpace``: B same-geometry scenarios stacked per channel into
  ``[B, H, W]`` tensors on one device. One scenario is always one whole lane.
- Shared structure, per-scenario parameters: two scenarios batch together
  when their models differ only in numeric flow parameters (rates, frozen
  snapshots), the ``structure_key``. Parameters travel as ``[B, F]`` float64
  host arrays and enter the step as per-lane tensors.
- ``impl="xla"``: one set of torch ops over ``[B, H, W]`` per step, rates as
  ``[B, 1, 1]`` lanes in each channel's dtype (rounded once from the host's
  f64, as the serial step rounds its Python float), point flows scattered
  with a batch index. Each lane is bit for bit the scenario's
  ``SerialExecutor("xla")`` run, report totals included.
- ``impl="pipeline"``: the pipelined-window kernel K5
  (``ops.pipeline_stencil``), one launch per fused call for every lane, two
  ``[B, H, W]`` buffers per written channel used in turn, allocated per
  dispatch (a result never aliases a buffer a later dispatch writes). All
  lanes share one rate set (``_uniform_rates``).
- ``impl="active"`` / ``"active_fused"``: the active-tile engine run lane by
  lane with each lane's concrete rates (the JAX package maps its runner over
  lanes with traced rates); the fused engine takes the exact iterated path
  in every pass, never the composed taps, as the JAX package's traced rates
  force it to.
- Conservation is checked per lane; a violation raises (or, for the
  scheduler, marks) ``EnsembleConservationError`` naming the lane.
- ``launch_ensemble`` queues the work on the current CUDA stream and returns
  without synchronizing: the runner, then right behind it the final totals
  and the per-lane outflow sums, their copies into pinned host memory, and
  a ``torch.cuda.Event`` after them. ``complete_ensemble`` waits on that
  event alone (never on the whole device), so a flight finishes while a
  later flight queued behind it still runs. ``run_ensemble`` is the two
  back to back.
- ``windows > 1`` (``impl="xla"``) advances a dispatch in that many runner
  calls over the same step sequence (``_window_steps``), bit for bit the
  one-call dispatch; ``donate=True`` (``impl="xla"``) steps in two buffers
  per written channel that the dispatch owns (the stacked batch and one
  more), so each window's ``[B, H, W]`` state moves to the next with no
  copy and no fresh allocation. ``EnsembleInFlight.donated_windows`` counts
  the windows whose results the storage check (``data_ptr``) finds in those
  buffers.
- The chaos seams ``lane_nan`` (captured and applied at launch, ahead of
  the totals) and ``fetch_nan`` (at completion) of ``resilience.inject``.

- ``compute_dtype=torch.bfloat16`` reaches K5 (``impl="pipeline"``): its
  closed TPU tiles compute in bf16; where ``_pipeline_blocks`` leaves none
  (8 × 4096²) the result is the f32 dispatch's bit for bit. The other
  impls take the knob as the JAX package does (the active engines' dense
  fallback is K1 at one step, where it changes nothing).

- Flow IR models (``ir.FlowIRModel``): a linear model rides every path
  above through its ``Diffusion`` flows view (it even batches with the
  equivalent flow-built model). A nonlinear one batches on its term
  structure; its term rates travel as ``[B, T]`` lanes (``[B, 1, 1]``
  tensors) into the same registered lowering the serial dense step runs
  (``ir.lower.dense_apply``), so each lane is bit for bit its serial run;
  zero-rate padding lanes are no-ops. Its lanes are checked through
  ``conservation_view``, a violation naming the term. ``"pipeline"``,
  ``"active"`` and ``"active_fused"`` refuse it, as the JAX package's do.

Not ported (``NotImplementedError`` naming ROADMAP.md): ``mesh=``.
"""

from __future__ import annotations

import copy
import dataclasses
import time as _time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.cellular_space import CellularSpace, first_float_dtype
from ..models.model import (ConservationError, Model, Report,
                            _not_ported, default_conservation_rtol,
                            kernel_launches)
from ..ops.flow import Diffusion, PointFlow, build_outflow
from ..ops.fused_stencil import resolve_compute_dtype
from ..ops.stencil import neighbor_counts, transport
from ..resilience import inject, lockdep

Values = dict[str, torch.Tensor]


def _dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class EnsembleConservationError(ConservationError):
    """Per-scenario mass-conservation contract violated; ``scenario`` is the
    index of the failing lane within its batch (the scheduler also attaches
    ``ticket`` when the lane came from a submission)."""

    def __init__(self, message: str, scenario: int):
        super().__init__(message)
        self.scenario = int(scenario)
        self.ticket: Optional[int] = None


@dataclasses.dataclass
class EnsembleSpace:
    """B stacked scenarios: one ``[B, H, W]`` tensor per attribute channel,
    all on one device. Only full grids stack."""

    values: dict[str, torch.Tensor]
    batch: int
    dim_x: int
    dim_y: int

    @staticmethod
    def stack(spaces: Sequence[CellularSpace]) -> "EnsembleSpace":
        """Stack same-geometry scenarios along a new leading batch axis (a
        copy). Every space must be a full grid with identical shape, channel
        names, per-channel dtypes and device."""
        spaces = list(spaces)
        if not spaces:
            raise ValueError("EnsembleSpace.stack needs at least one scenario")
        first = spaces[0]
        names = tuple(first.values.keys())
        for i, s in enumerate(spaces):
            if s.is_partition:
                raise ValueError(
                    f"scenario {i} is a partition; the ensemble engine "
                    "batches FULL grids — shard inside a scenario with a "
                    "mesh executor instead")
            if s.shape != first.shape:
                raise ValueError(
                    f"scenario {i} geometry {s.shape} != {first.shape}")
            if tuple(s.values.keys()) != names:
                raise ValueError(
                    f"scenario {i} channels {tuple(s.values)} != {names}")
            for k in names:
                if s.values[k].dtype != first.values[k].dtype:
                    raise ValueError(
                        f"scenario {i} channel {k!r} dtype "
                        f"{_dname(s.values[k].dtype)} != "
                        f"{_dname(first.values[k].dtype)}")
            if s.device != first.device:
                raise ValueError(
                    f"scenario {i} device {s.device} != {first.device}")
        vals = {k: torch.stack([s.values[k] for s in spaces]) for k in names}
        return EnsembleSpace(vals, len(spaces), first.dim_x, first.dim_y)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dim_x, self.dim_y)

    @property
    def dtype(self) -> torch.dtype:
        """First floating channel's dtype (the flow/transport dtype)."""
        return first_float_dtype(self.values)

    @property
    def device(self) -> torch.device:
        return next(iter(self.values.values())).device

    def scenario(self, i: int) -> CellularSpace:
        """Lane ``i`` as its own full-grid ``CellularSpace`` (views of the
        lane)."""
        if not 0 <= i < self.batch:
            raise IndexError(f"scenario {i} out of range [0, {self.batch})")
        return CellularSpace({k: v[i] for k, v in self.values.items()},
                             self.dim_x, self.dim_y)

    def unstack(self) -> list[CellularSpace]:
        return [self.scenario(i) for i in range(self.batch)]


# -- structure vs parameters -------------------------------------------------

def _ir_nonlinear(model) -> bool:
    """True for a FlowIRModel whose terms need the general IR lowering
    (nonlinear, coupled or source/sink physics). Linear IR models present
    an exact ``Diffusion`` flows view and take every flow-based path."""
    return (getattr(model, "ir_terms", None) is not None
            and not model.ir_linear)


def structure_key(model, space) -> tuple:
    """Hashable batch-compatibility key: everything two (model, space) pairs
    must share to ride one runner: flow structure (types, attrs, sources,
    modulators, frozen-ness), offsets, grid geometry, per-channel dtypes and
    the device. Numeric parameters (``flow_rate``, the frozen snapshot's
    value) are excluded. ``space`` is a ``CellularSpace`` or an
    ``EnsembleSpace``. Nonlinear IR models key on their term structure
    (rates excluded: each term's rate is its parameter lane)."""
    if _ir_nonlinear(model):
        chans = tuple(sorted((k, str(v.dtype))
                             for k, v in space.values.items()))
        return (("__ir__",) + model.term_structure(),
                (space.dim_x, space.dim_y), chans, str(space.device))
    flows = []
    for f in model.flows:
        name, items = f.fingerprint()
        items = list(
            (k, (v is not None) if k == "frozen_source_value" else v)
            for k, v in items if k != "flow_rate")
        if isinstance(f, PointFlow):
            # the source Cell's repr embeds its attribute snapshot, a
            # numeric parameter; only the coordinates are structural
            items = [(k, v) for k, v in items if k != "source"]
            items.append(("source_xy", f.source_xy))
        flows.append((name, tuple(sorted(items))))
    chans = tuple(sorted((k, str(v.dtype)) for k, v in space.values.items()))
    return (tuple(flows), tuple(model.offsets),
            (space.dim_x, space.dim_y), chans, str(space.device))


def flow_params(models: Sequence) -> tuple[np.ndarray, np.ndarray]:
    """Per-scenario flow parameters as ``[B, F]`` float64 host arrays:
    rates, and frozen snapshot values (0.0 filler for flows without one).
    For nonlinear IR models the rate lanes are the per-term rates (frozens
    stay zero filler)."""
    B = len(models)
    if B and _ir_nonlinear(models[0]):
        T = len(models[0].ir_terms)
        rates = np.zeros((B, T), np.float64)
        for b, m in enumerate(models):
            rates[b] = m.term_rates()
        return rates, np.zeros((B, T), np.float64)
    F = len(models[0].flows) if B else 0
    rates = np.zeros((B, F), np.float64)
    frozens = np.zeros((B, F), np.float64)
    for b, m in enumerate(models):
        for i, f in enumerate(m.flows):
            rates[b, i] = float(f.flow_rate)
            fv = getattr(f, "frozen_source_value", None)
            if fv is not None:
                frozens[b, i] = float(fv)
    return rates, frozens


def _substituted(template_flows, rates, frozens) -> list:
    """Copies of the template flows with per-flow parameters taken from
    ``rates``/``frozens`` (per-lane tensors inside the batched step, floats
    for padding scenarios; ``frozens=None`` keeps the snapshots). Works for
    dataclass flows and plain-attribute user subclasses."""
    out = []
    for i, f in enumerate(template_flows):
        kw = {"flow_rate": rates[i]}
        if (isinstance(f, PointFlow) and f.frozen_source_value is not None
                and frozens is not None):
            kw["frozen_source_value"] = frozens[i]
        if dataclasses.is_dataclass(f):
            out.append(dataclasses.replace(f, **kw))
        else:
            g = copy.copy(f)
            for k, v in kw.items():
                setattr(g, k, v)
            out.append(g)
    return out


def padding_scenarios(model, space: CellularSpace,
                      n: int) -> tuple[list[CellularSpace], list[Model]]:
    """``n`` zero scenarios structure-compatible with ``(model, space)``:
    all-zero channels and zero-rate flows. Padded lanes move nothing, total
    nothing and are never checked or reported. A nonlinear IR model pads
    with every term's rate at zero: each term contributes ``rate *
    amount``, so that is a no-op for any term set."""
    if _ir_nonlinear(model):
        zvals = {k: torch.zeros_like(v) for k, v in space.values.items()}
        zspace = CellularSpace(zvals, space.dim_x, space.dim_y)
        zmodel = model.with_rates([0.0] * len(model.ir_terms))
        return [zspace] * n, [zmodel] * n
    F = len(model.flows)
    zvals = {k: torch.zeros_like(v) for k, v in space.values.items()}
    zspace = CellularSpace(zvals, space.dim_x, space.dim_y)
    zflows = _substituted(model.flows, [0.0] * F, [0.0] * F)
    zmodel = Model(zflows, model.time, model.time_step, offsets=model.offsets)
    return [zspace] * n, [zmodel] * n


# -- the batched parametric step ---------------------------------------------

@dataclasses.dataclass
class _Point:
    """One point flow inside the grid: its flow index, channel, source and
    whether it sheds a frozen snapshot."""
    index: int
    attr: str
    x: int
    y: int
    frozen: bool


@dataclasses.dataclass
class _Scatter:
    """The static scatter of one channel's point flows, on the device: the
    sources, and per offset the sources whose neighbour there is on the grid
    (None when there is none)."""
    points: list
    xs: torch.Tensor
    ys: torch.Tensor
    by_offset: list


class ScenarioStep:
    """The batched counterpart of ``Model.make_step``'s plain-op path for
    one ensemble geometry: ``step(values, lanes)`` advances every lane of
    ``[B, H, W]`` values one model step, term for term the serial step
    (plain Diffusions through ``ir.lower.dense_apply``, other field flows
    ``build_outflow`` → ``transport`` on the summed outflows; point amounts
    read the pre-step values, then the point scatter). ``lanes(rates,
    frozens)`` turns the ``[B, F]`` host parameters into the per-lane
    tensors once per dispatch. Non-float flow channels are refused like
    ``make_step``; int/bool bystander channels ride along untouched.

    Nothing in a step or in ``lanes`` waits for the device: index tensors
    are made once, here, and parameters reach the card through pinned
    memory, so a dispatch is queued without a synchronization."""

    def __init__(self, model, space):
        for f in model.flows:
            ch = space.values.get(f.attr)
            if ch is None:
                raise ValueError(
                    f"flow {type(f).__name__} targets channel {f.attr!r} "
                    f"which the space does not carry "
                    f"(has {tuple(space.values)})")
            if not ch.dtype.is_floating_point:
                raise TypeError(
                    f"flow transport requires a floating dtype, got "
                    f"{ch.dtype} for channel {f.attr!r} (integer/bool "
                    "channels are supported for storage/comm/masks, "
                    "not flows)")
        self.template = list(model.flows)
        self.offsets = tuple(model.offsets)
        self.shape = (space.dim_x, space.dim_y)
        self.device = space.device
        self.dtype = space.dtype
        self.chan_dtype = {k: v.dtype for k, v in space.values.items()}
        h, w = self.shape
        self.points: list[_Point] = []
        for i, f in enumerate(self.template):
            if not isinstance(f, PointFlow):
                continue
            x, y = f.source_xy
            if 0 <= x < h and 0 <= y < w:  # full grids: a static test
                self.points.append(_Point(i, f.attr, x, y,
                                          f.frozen_source_value is not None))
        by_attr: dict[str, list[_Point]] = {}
        for p in self.points:
            by_attr.setdefault(p.attr, []).append(p)
        self.scatters = {a: self._scatter_plan(pts)
                         for a, pts in by_attr.items()}
        self._counts: Optional[torch.Tensor] = None
        # plain-Diffusion field flows run the Flow IR's registered
        # lowering, as Model.make_step's plain path does
        from ..ir.lower import StepMeta, diffusion_terms

        self._field_idx = [i for i, f in enumerate(self.template)
                           if not isinstance(f, PointFlow)]
        self._ir_terms = diffusion_terms(
            [self.template[i] for i in self._field_idx])
        self._ir_meta = StepMeta(shape=self.shape, origin=(0, 0),
                                 global_shape=self.shape, dtype=self.dtype,
                                 offsets=self.offsets)
        self._ir_cache: dict = {}

    def _scatter_plan(self, pts: list) -> _Scatter:
        h, w = self.shape
        dev = self.device
        by_offset = []
        for dx, dy in self.offsets:
            ok = [i for i, p in enumerate(pts)
                  if 0 <= p.x + dx < h and 0 <= p.y + dy < w]
            by_offset.append(torch.tensor(ok, device=dev) if ok else None)
        return _Scatter(pts, torch.tensor([p.x for p in pts], device=dev),
                        torch.tensor([p.y for p in pts], device=dev),
                        by_offset)

    def counts(self) -> torch.Tensor:
        if self._counts is None:
            self._counts = neighbor_counts(self.shape, self.offsets, (0, 0),
                                           self.shape, self.dtype,
                                           self.device)
        return self._counts

    def lanes(self, rates: np.ndarray, frozens: np.ndarray) -> dict:
        """Per-dispatch parameter tensors: ``"rates"``, per flow a
        ``[B, 1, 1]`` tensor in its channel's dtype; ``"amounts"``, per
        frozen point flow its ``[B]`` amounts (rate × snapshot formed in
        f64, rounded once, as the serial ``PointFlow.amount``)."""
        B = rates.shape[0]
        out = {"rates": [], "amounts": {}}
        for i, f in enumerate(self.template):
            out["rates"].append(self._to_device(
                rates[:, i], self.chan_dtype[f.attr]).reshape(B, 1, 1))
        for p in self.points:
            if p.frozen:
                out["amounts"][p.index] = self._to_device(
                    rates[:, p.index] * frozens[:, p.index],
                    self.chan_dtype[p.attr])
        return out

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        """Host f64 values rounded once to ``dtype`` on the host, then
        copied to the device without a synchronization (pinned memory)."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def amount(self, p: _Point, values: Values, lanes: dict) -> torch.Tensor:
        """``[B]`` amounts one point flow sheds this step."""
        if p.frozen:
            return lanes["amounts"][p.index]
        rate = lanes["rates"][p.index].reshape(-1)
        return rate * values[p.attr][:, p.x, p.y]

    def field_flows(self, lanes: dict) -> list:
        """The field flows with their rates replaced by the rate lanes (the
        point flows' parameters enter through ``amount``)."""
        idx = self._field_idx
        return _substituted([self.template[i] for i in idx],
                            [lanes["rates"][i] for i in idx], None)

    @property
    def written(self) -> tuple[str, ...]:
        """The channels a step writes (the flows' channels); the others ride
        along as the same tensors."""
        return tuple(dict.fromkeys(f.attr for f in self.template))

    def __call__(self, values: Values, lanes: dict,
                 into: Optional[Values] = None) -> Values:
        """One step. ``into`` (per written channel, a buffer that aliases
        none of ``values``) receives each written channel's result in place
        of a fresh tensor, with the same operations."""
        new = dict(values)
        # a channel with point flows ends in the scatter's buffer
        dsts = ({} if into is None else
                {a: into[a] for a in self.written if a not in self.scatters})
        if self._ir_terms is not None:
            from ..ir.lower import dense_apply

            new.update(dense_apply(
                self._ir_terms, values,
                [lanes["rates"][i] for i in self._field_idx], self._ir_meta,
                self.counts(), self._ir_cache, out=dsts))
        else:
            field_flows = self.field_flows(lanes)
            for attr, o in build_outflow(field_flows, values,
                                         (0, 0)).items():
                new[attr] = transport(values[attr], o, self.counts(),
                                      self.offsets, out=dsts.get(attr))
        for attr, sc in self.scatters.items():
            # amounts read the PRE-step values (the serial discipline)
            amts = torch.stack([self.amount(p, values, lanes)
                                for p in sc.points], dim=1)
            new[attr] = self._scatter(new[attr], sc, amts,
                                      None if into is None else into[attr])
        return new

    def _scatter(self, v: torch.Tensor, sc: _Scatter, amts: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``ops.stencil.point_flow_step`` with a batch index: per source,
        ``-amount`` on the source and ``amount / counts[source]`` on each
        in-bounds neighbour, one accumulating ``index_put_`` per offset in
        ``offsets`` order, lanes in order within each. ``out`` receives the
        result in place of a clone of ``v``."""
        B = v.shape[0]
        xs, ys = sc.xs, sc.ys
        share = amts / self.counts()[xs, ys]
        lane = torch.arange(B, device=v.device)

        def lanes_by(idx: torch.Tensor) -> tuple:
            # (lane, idx) for every lane, lane-major: lane 0's sources first
            n = idx.numel()
            return (lane[:, None].expand(B, n).reshape(-1),
                    idx[None, :].expand(B, n).reshape(-1))

        out = v.clone() if out is None else out.copy_(v)
        li, xi = lanes_by(xs)
        out.index_put_((li, xi, lanes_by(ys)[1]), (-amts).reshape(-1),
                       accumulate=True)
        for (dx, dy), sel in zip(self.offsets, sc.by_offset):
            if sel is None:
                continue
            li, xi = lanes_by(xs[sel] + dx)
            out.index_put_((li, xi, lanes_by(ys[sel] + dy)[1]),
                           share[:, sel].reshape(-1), accumulate=True)
        return out


class IRScenarioStep:
    """The batched step of a nonlinear IR model: the same registered
    lowering the serial dense step runs (``ir.lower.dense_apply``) over
    ``[B, H, W]`` channels, each term's rate a ``[B, 1, 1]`` lane in the
    space dtype (rounded once on the host from f64, as the serial step
    rounds its Python float), so one lane is bit for bit that scenario's
    ``SerialExecutor("xla")`` run. ``ScenarioStep``'s interface."""

    def __init__(self, model, space):
        from ..ir import lower

        model._validate_space(space)
        self.terms = model.ir_terms
        self.shape = (space.dim_x, space.dim_y)
        self.device = space.device
        self.dtype = space.dtype
        self.meta = lower.StepMeta(shape=self.shape, origin=(0, 0),
                                   global_shape=self.shape, dtype=self.dtype,
                                   offsets=tuple(model.offsets))
        self.written = tuple(lower.written_channels(self.terms))
        self._cache: dict = {}
        self._counts: Optional[torch.Tensor] = None

    def lanes(self, rates: np.ndarray, frozens: np.ndarray) -> dict:
        """``"rates"``: per term a ``[B, 1, 1]`` tensor in the space
        dtype, copied to the device without a synchronization."""
        B = rates.shape[0]
        out = []
        for i in range(len(self.terms)):
            t = torch.from_numpy(np.ascontiguousarray(rates[:, i])).to(
                self.dtype)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t.reshape(B, 1, 1))
        return {"rates": out}

    def __call__(self, values: Values, lanes: dict,
                 into: Optional[Values] = None) -> Values:
        """One step; ``into`` (per written channel, a buffer that aliases
        none of ``values``) receives each written channel's result."""
        from ..ir.lower import dense_apply

        if self._counts is None:
            self._counts = neighbor_counts(self.shape, self.meta.offsets,
                                           (0, 0), self.shape, self.dtype,
                                           self.device)
        new = dense_apply(self.terms, values, lanes["rates"], self.meta,
                          self._counts, self._cache)
        if into is not None:
            for k in self.written:
                new[k] = into[k].copy_(new[k])
        return new


def make_scenario_step(model, space):
    """The batched plain-op step for ``space``'s geometry (see
    ``ScenarioStep``; ``IRScenarioStep`` for a nonlinear IR model)."""
    if _ir_nonlinear(model):
        return IRScenarioStep(model, space)
    return ScenarioStep(model, space)


def _lane_sums(v: torch.Tensor, acc) -> torch.Tensor:
    """``[B]`` sums of each lane, each reduced exactly as the serial
    ``CellularSpace.total`` reduces a ``[H, W]`` grid (one reduction per
    lane), so ensemble reports carry the serial totals bit for bit."""
    return torch.stack([torch.sum(v[b], dtype=acc) for b in range(v.shape[0])])


def batched_totals(values_b: Values) -> dict:
    """Per-scenario channel totals, ``[B]`` tensors on the values' device
    (no synchronization): integer channels in int64 (exact), f64 in f64,
    everything else (bool included) in f32 or wider."""
    out = {}
    for k, v in values_b.items():
        if v.dtype.is_floating_point:
            acc = torch.float64 if v.dtype == torch.float64 else torch.float32
            out[k] = _lane_sums(v, acc)
        elif v.dtype == torch.bool:
            out[k] = _lane_sums(v, torch.float32)
        else:
            out[k] = v.reshape(v.shape[0], -1).sum(dim=1, dtype=torch.int64)
    return out


def _fetch_async(t: torch.Tensor) -> torch.Tensor:
    """A card tensor's copy into pinned host memory, queued on the current
    stream (valid once the stream has passed it); a host tensor as is."""
    if t.device.type != "cuda":
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True)


def _host(totals: dict) -> dict[str, np.ndarray]:
    return {k: v.numpy().astype(np.float64) for k, v in totals.items()}


# -- per-scenario conservation -----------------------------------------------

def conservation_thresholds(initial: dict[str, np.ndarray],
                            shape: tuple[int, int], dtype,
                            tolerance: float = 1e-3,
                            rtol: Optional[float] = None) -> np.ndarray:
    """Per-scenario allowed |Δtotal|: ``tolerance + rtol * scale_i`` with
    ``scale_i`` scenario i's largest |initial channel total|; the default
    rtol is the serial run's, so a lane's threshold equals its serial
    run's."""
    if rtol is None:
        rtol = default_conservation_rtol(shape, dtype)
    scale = np.max(np.abs(np.stack(list(initial.values()), axis=0)), axis=0)
    return tolerance + rtol * scale


def conservation_violations(initial: dict[str, np.ndarray],
                            final: dict[str, np.ndarray],
                            thresholds: np.ndarray,
                            count: int) -> tuple[np.ndarray, list[int]]:
    """(per-lane max |Δtotal| ``[B]``, violating lane indices ``< count``).
    Lanes at index >= ``count`` are padding and never counted. A non-finite
    lane error is always a violation (``NaN > threshold`` is False)."""
    errs = np.max(np.abs(np.stack(
        [final[k] - initial[k] for k in initial], axis=0)), axis=0)
    head = errs[:count]
    bad = np.nonzero((head > thresholds[:count]) | ~np.isfinite(head))[0]
    return errs, [int(i) for i in bad]


def _worst_violation_keys(initial: dict, final: dict) -> list[str]:
    """Per lane, the key with the largest |Δ| (a non-finite one first):
    what names the violating term in an IR model's message."""
    ks = list(initial)
    stack = np.abs(np.stack(
        [np.asarray(final[k], np.float64)
         - np.asarray(initial[k], np.float64) for k in ks], axis=0))
    stack = np.where(np.isfinite(stack), stack, np.inf)
    idx = np.argmax(stack, axis=0)
    return [ks[int(j)] for j in np.atleast_1d(idx)]


def _violation_error(errs: np.ndarray, thresholds: np.ndarray, i: int,
                     nbad: Optional[int] = None,
                     count: Optional[int] = None,
                     key: Optional[str] = None,
                     model=None) -> EnsembleConservationError:
    """The one place the per-lane violation message is built. ``key``
    (the lane's worst view key) and an IR model word it through
    ``FlowIRModel.violation_message``, so a violated source or sink names
    its term as the serial check does."""
    if not np.isfinite(errs[i]):
        msg = (f"non-finite state in scenario {i}: its channel totals "
               "are NaN/Inf (divergence or a poisoned lane)")
    elif key is not None and hasattr(model, "violation_message"):
        msg = (f"scenario {i}: "
               + model.violation_message(key, float(errs[i]),
                                         float(thresholds[i])))
    else:
        msg = (f"mass conservation violated in scenario {i}: |Δ| = "
               f"{errs[i]:.3e} > {thresholds[i]:.3e}")
    if nbad is not None:
        msg += f" ({nbad} of {count} scenarios violated)"
    return EnsembleConservationError(msg, scenario=i)


def check_batch_conserved(initial: dict[str, np.ndarray],
                          final: dict[str, np.ndarray],
                          thresholds: np.ndarray,
                          count: int) -> np.ndarray:
    """Enforce the contract per lane; raises ``EnsembleConservationError``
    naming the first violating scenario. Returns the per-lane errors."""
    errs, bad = conservation_violations(initial, final, thresholds, count)
    if bad:
        raise _violation_error(errs, thresholds, bad[0], len(bad), count)
    return errs


# -- the batched executor ----------------------------------------------------

class EnsembleExecutor:
    """Batched execution strategy: one runner advances every scenario lane.

    ``impl``: ``"xla"`` (default; the batched plain-op step, every flow
    combination the serial plain step supports, per-scenario rates and
    snapshots), ``"pipeline"`` (K5: all-Diffusion models sharing ONE rate
    set across the batch, f32/bf16 grids that cut into 16-row/128-column
    strips, ``substeps <= 8``; ``ValueError`` otherwise, no silent
    fallback), ``"active"`` / ``"active_fused"`` (the active-tile engine
    per lane: all-Diffusion batches, per-lane rates, every flow channel in
    the space dtype; ``active_fused`` runs K6/K7 on the exact iterated path
    only).

    ``substeps`` fuses that many model steps per step call (inside K5 on the
    pipeline path; the depth of the fused active passes); any remainder
    runs as single steps, so results do not depend on it. Runners are cached
    by ``(batch, shape, impl, substeps, compute dtype, structure, donate)``
    plus the pipeline's rate set (the JAX package's key; its mesh field is
    fixed in the port); ``builds``/``cache_hits`` count misses and hits for
    the serving counters.
    """

    comm_size = 1

    def __init__(self, impl: str = "xla", substeps: int = 1,
                 compute_dtype=None, mesh=None):
        if impl not in ("xla", "pipeline", "active", "active_fused"):
            raise ValueError(
                f"unknown ensemble impl {impl!r} (expected 'xla', "
                "'pipeline', 'active' or 'active_fused')")
        if mesh is not None:
            raise _not_ported("EnsembleExecutor(mesh=...) (the mesh-sharded "
                              "ensemble)")
        resolve_compute_dtype(compute_dtype)
        self.impl = impl
        self.substeps = max(1, int(substeps))
        self.compute_dtype = compute_dtype
        #: the last run's engine record (launches, the active engines'
        #: counters); None before any run
        self.last_backend_report: Optional[dict] = None
        #: guards the runner cache and its counters: the synchronous service
        #: dispatches on whichever client thread filled the bucket (made
        #: through the lock-order witness: a plain Lock disarmed)
        self._cache_lock = lockdep.lock("EnsembleExecutor._cache_lock")
        self._cache: dict = {}
        self.builds = 0
        self.cache_hits = 0

    def runner_for(self, model, espace: EnsembleSpace,
                   uniform_rates: Optional[dict] = None,
                   donate: bool = False) -> Callable:
        """The cached runner ``run(values, rates, frozens, q, r) -> (values,
        stats)`` for this batch (``q`` substeps-deep calls, then ``r``
        single steps). ``donate=True`` (xla impl only) builds the runner
        that steps in buffers the caller owns: ``run(values, rates,
        frozens, q, r, pairs)`` with ``pairs`` per written channel
        (``run.written``) two buffers, one holding the state; donated and
        undonated runners cache under distinct keys."""
        if donate and self.impl != "xla":
            raise ValueError(
                f"donated dispatch supports impl='xla' only (the "
                f"'{self.impl}' runner carries stat lanes alongside the "
                "state, so the carry is not a pure [B,H,W] pytree)")
        cdt = resolve_compute_dtype(self.compute_dtype)
        key = (espace.batch, espace.shape, self.impl, self.substeps,
               str(cdt) if cdt is not None else None,
               structure_key(model, espace), bool(donate))
        if uniform_rates is not None:
            key = key + (tuple(sorted(uniform_rates.items())),)
        # build inside the lock: two racing submitters get one build, one hit
        with self._cache_lock:
            runner = self._cache.get(key)
            if runner is not None:
                self.cache_hits += 1
                return runner
            self.builds += 1
            if self.impl == "pipeline":
                runner = self._build_pipeline(model, espace, uniform_rates)
            elif self.impl in ("active", "active_fused"):
                runner = self._build_active(
                    model, espace, fused=self.impl == "active_fused")
            else:
                runner = self._build_xla(model, espace, donate=donate)
            self._cache[key] = runner
            return runner

    def _build_xla(self, model, espace: EnsembleSpace,
                   donate: bool = False) -> Callable:
        step = make_scenario_step(model, espace)
        substeps = self.substeps

        if not donate:
            def run(vb, rates, frozens, q, r):
                lanes = step.lanes(rates, frozens)
                for _ in range(q * substeps + r):
                    vb = step(vb, lanes)
                return vb, None

            return run

        def run_donated(vb, rates, frozens, q, r, pairs):
            lanes = step.lanes(rates, frozens)
            for _ in range(q * substeps + r):
                # each written channel's step lands in the pair's buffer
                # that does not hold its state
                into = {k: b if vb[k].data_ptr() == a.data_ptr() else a
                        for k, (a, b) in pairs.items()}
                vb = step(vb, lanes, into=into)
            return vb, None

        run_donated.written = step.written
        return run_donated

    def last_execute_for(self, model, espace: EnsembleSpace) -> Callable:
        """Batched ``Flow.execute``: ``fn(values, rates, frozens)`` gives the
        ``[B, F]`` f64 per-lane outflow sums the reports carry, on the
        values' device (no synchronization), each summed as the serial
        ``Flow.execute`` sums it. Cached beside the runners but outside the
        ``builds``/``cache_hits`` counters, which count step runners
        only."""
        key = ("last_execute", espace.batch, espace.shape,
               structure_key(model, espace))
        with self._cache_lock:
            fn = self._cache.get(key)
            if fn is None and not model.flows:
                # a nonlinear IR model has no flows: no outflow sums
                def fn(values, rates, frozens):
                    return torch.zeros((rates.shape[0], 0),
                                       dtype=torch.float64,
                                       device=espace.device)

                self._cache[key] = fn
            if fn is None:
                step = make_scenario_step(model, espace)
                points = {p.index: p for p in step.points}

                def fn(values, rates, frozens):
                    B = rates.shape[0]
                    lanes = step.lanes(rates, frozens)
                    field = iter(step.field_flows(lanes))
                    cols = []
                    for i, f in enumerate(step.template):
                        if isinstance(f, PointFlow):
                            # one nonzero cell: its sum is the amount
                            p = points.get(i)
                            col = (torch.zeros(B, dtype=torch.float64,
                                               device=step.device)
                                   if p is None
                                   else step.amount(p, values, lanes))
                        else:
                            o = next(field).outflow(values, (0, 0))
                            col = torch.stack([torch.sum(o[b])
                                               for b in range(B)])
                        cols.append(col.to(torch.float64))
                    if not cols:
                        return torch.zeros((B, 0), dtype=torch.float64,
                                           device=step.device)
                    return torch.stack(cols, dim=1)

                self._cache[key] = fn
            return fn

    def _build_active(self, model, espace: EnsembleSpace,
                      fused: bool = False) -> Callable:
        """The active-tile engine lane by lane (``ops.active`` /
        ``ops.fused_active`` whole-run runners), each lane with its own
        concrete rates; a channel fed by several Diffusions takes their
        summed rate, as ``Model.pallas_rates`` sums it. The dense fallback
        is K1 when the batch is on the card in f32/bf16, else the plain
        transport, as on the serial path."""
        from ..ops import active as act
        from ..ops import fused_active as fa

        impl_name = "active_fused" if fused else "active"
        flows = list(model.flows)
        if not flows or any(type(f) is not Diffusion for f in flows):
            raise ValueError(
                f"impl={impl_name!r} supports all-Diffusion scenario "
                "batches (the tile-skip rule is only bitwise-exact for "
                "uniform-rate linear flows); got "
                f"flows={[type(f).__name__ for f in flows]}. "
                "Use impl='xla'.")
        for f in flows:
            adt = espace.values[f.attr].dtype
            if not adt.is_floating_point:
                raise TypeError(
                    f"flow transport requires a floating dtype, got "
                    f"{adt} for channel {f.attr!r}")
            if adt != espace.dtype:
                raise ValueError(
                    f"impl={impl_name!r} computes every flow channel in "
                    f"the space dtype ({_dname(espace.dtype)}); "
                    f"channel {f.attr!r} is {_dname(adt)}. Use impl='xla'.")
        attr_idx: dict[str, list[int]] = {}
        for i, f in enumerate(flows):
            attr_idx.setdefault(f.attr, []).append(i)
        plan = act.plan_for(espace.shape)
        k = fa.choose_fused_k(self.substeps, plan) if fused else 1
        substeps = self.substeps
        lane_space = espace.scenario(0)
        offsets = model.offsets

        def run(vb, rates, frozens, q, r):
            n = q * substeps + r
            outs: dict[str, list] = {a: [] for a in attr_idx}
            fb, at, ff = [], [], []
            for b in range(espace.batch):
                live = {}
                for a, idx in attr_idx.items():
                    s = 0.0
                    for i in idx:
                        s += float(rates[b, i])
                    live[a] = s
                dense = {}
                for a, rate in live.items():
                    fn = model.dense_fallback(lane_space, rate)
                    if fn is not None:
                        dense[a] = fn
                if fused:
                    lane = fa.build_fused_runner(
                        espace.shape, live, offsets, espace.dtype, plan=plan,
                        k=k, dense_fns=dense, use_taps=False)
                else:
                    lane = act.build_active_runner(
                        espace.shape, live, offsets, espace.dtype, plan=plan,
                        dense_fns=dense)
                out, stats = lane({a: vb[a][b] for a in attr_idx}, n)
                for a in attr_idx:
                    outs[a].append(out[a])
                fb.append(int(stats[0]))
                at.append(int(stats[1]))
                if fused:
                    ff.append(int(stats[2]))
            new = dict(vb)
            for a, lanes in outs.items():
                new[a] = torch.stack(lanes)
            return new, {"fallback": fb, "active": at,
                         "flags_fused": ff if fused else None,
                         "plan": plan, "k": k}

        return run

    def _build_pipeline(self, model, espace: EnsembleSpace,
                        rates: Optional[dict]) -> Callable:
        from ..ops.pipeline_stencil import _pipeline_blocks, \
            pipeline_dense_step

        if rates is None or not any(r != 0.0 for r in rates.values()):
            raise ValueError(
                "impl='pipeline' requires all flows to be plain Diffusion "
                "with a nonzero rate shared across the batch; got "
                f"flows={[type(f).__name__ for f in model.flows]}")
        for attr in rates:
            if espace.values[attr].dtype.itemsize > 4:
                raise ValueError(
                    "impl='pipeline' computes in f32 — f64 grids stay on "
                    f"impl='xla' (channel {attr!r} is "
                    f"{_dname(espace.values[attr].dtype)})")
        if _pipeline_blocks(*espace.shape) is None or self.substeps > 8:
            raise ValueError(
                "impl='pipeline' needs a grid divisible into 16-row/"
                f"128-col strips and substeps <= 8; got {espace.shape} "
                f"substeps={self.substeps}. Use impl='xla'.")
        offsets = model.offsets
        substeps = self.substeps
        cdt = self.compute_dtype

        def run(vb, rates_b, frozens_b, q, r):
            new = dict(vb)
            for attr, rate in rates.items():
                if rate == 0.0:
                    continue
                cur = vb[attr]
                # two buffers per written channel, used in turn; made per
                # dispatch, so the result is never a buffer that a later
                # dispatch writes
                bufs = ((torch.empty_like(cur), torch.empty_like(cur))
                        if cur.device.type == "cuda" else None)
                for ns, count in ((substeps, q), (1, r)):
                    for _ in range(count):
                        out = None
                        if bufs is not None:
                            out = bufs[0] if cur is not bufs[0] else bufs[1]
                        cur = pipeline_dense_step(cur, rate, offsets,
                                                  nsteps=ns, out=out,
                                                  compute_dtype=cdt)
                new[attr] = cur
            return new, None

        return run


def _uniform_rates(model, models, rates_np: np.ndarray) -> dict:
    """Validate the pipeline engine's batch-uniform-rate requirement and
    return the attr → summed-rate map (``Model.pallas_rates``)."""
    if any(isinstance(f, PointFlow) for f in model.flows):
        raise ValueError(
            "impl='pipeline' supports field (Diffusion) flows only; got "
            f"flows={[type(f).__name__ for f in model.flows]}")
    rates = models[0].pallas_rates()
    if rates is None:
        raise ValueError(
            "impl='pipeline' requires all flows to be plain Diffusion "
            "(a uniform rate is what the kernel compiles in); got "
            f"flows={[type(f).__name__ for f in model.flows]}")
    if rates_np.size and not np.all(rates_np == rates_np[0:1]):
        raise ValueError(
            "impl='pipeline' requires every scenario in the batch to "
            "share one rate set (the kernel's rate is compile-time "
            "static); got differing per-scenario rates — use impl='xla'")
    return rates


@dataclasses.dataclass
class EnsembleInFlight:
    """One launched-but-not-fetched dispatch: the work is queued on the
    device's stream, nothing has been waited for, and everything
    ``complete_ensemble`` needs travels here."""

    executor: EnsembleExecutor
    model: object
    espace: EnsembleSpace
    #: the runner's ``(values, stats)``: values queued, not waited for
    out: object
    rates: np.ndarray
    frozens: np.ndarray
    count: int
    num_steps: int
    #: the initial totals, final totals and ``[B, F]`` outflow sums
    #: (``{"initial": {ch: [B]}, "final": {ch: [B]}, "last": [B, F]}``):
    #: host tensors, which on the card are pinned copies that ``done``
    #: covers
    totals: dict
    #: recorded after the totals' copies (on the card; None elsewhere):
    #: the one thing completion waits on
    done: Optional[object]
    #: perf_counter at dispatch, and when the launch returned: the wall
    #: bills launch + fetch, not any gap between them
    t0: float
    t_launched: float
    #: kernel launches the runner queued, by kernel source
    launches: dict
    #: runner calls the dispatch made (the effective window count), and
    #: how many of them the storage check found donated
    windows: int = 1
    donated_windows: int = 0


def _window_steps(num_steps: int, windows: int) -> list[int]:
    """Split ``num_steps`` across ``windows`` runner calls (earlier windows
    take the remainder): the same step sequence, so windowed results are
    bit for bit the one-call dispatch's."""
    windows = max(1, min(int(windows), max(num_steps, 1)))
    base, rem = divmod(num_steps, windows)
    return [base + (1 if w < rem else 0) for w in range(windows)]


def _run_windows(runner, executor, values: Values, rates, frozens,
                 steps_list: list, donate: bool) -> tuple:
    """The runner over each window in turn: ``(runner output, donated
    windows)``. Donated: the dispatch owns two buffers per written channel
    (the stacked batch and one more), and a window counts as donated when
    every channel's result lies in its channel's buffers."""
    pairs = owned = None
    if donate:
        pairs = {k: (values[k], torch.empty_like(values[k]))
                 for k in runner.written}
        owned = {k: ({p.data_ptr() for p in pairs[k]} if k in pairs
                     else {v.data_ptr()}) for k, v in values.items()}
    out, donated = (values, None), 0
    for w_steps in steps_list:
        q, r = divmod(w_steps, executor.substeps)
        if donate:
            out = runner(out[0], rates, frozens, q, r, pairs)
            donated += all(v.data_ptr() in owned[k]
                           for k, v in out[0].items())
        else:
            out = runner(out[0], rates, frozens, q, r)
    return out, donated


def launch_ensemble(model, spaces, *, models=None, executor=None,
                    steps=None, count: Optional[int] = None,
                    windows: int = 1,
                    donate: bool = False) -> EnsembleInFlight:
    """Validate, stack, resolve (or build) the runner and queue one ensemble
    batch without waiting for it: the launch half of ``run_ensemble``. On
    the card, the work, its totals and their copies to the host are on the
    current CUDA stream when this returns, with the flight's event after
    them.

    ``windows > 1`` advances the batch in that many runner calls over the
    same step sequence; ``donate=True`` carries the ``[B, H, W]`` state
    between them in the dispatch's own buffers (both ``impl="xla"``
    only)."""
    spaces = list(spaces)
    B = len(spaces)
    if B == 0:
        raise ValueError("run_ensemble needs at least one scenario")
    models = list(models) if models is not None else [model] * B
    if len(models) != B:
        raise ValueError(
            f"{len(models)} models for {B} spaces — one model per scenario")
    skey = structure_key(model, spaces[0])
    for i, (m, s) in enumerate(zip(models, spaces)):
        if structure_key(m, s) != skey:
            raise ValueError(
                f"scenario {i} is not batch-compatible with the template: "
                "models must share flow structure (types/attrs/sources/"
                "frozen-ness), offsets, geometry and channel dtypes; only "
                "numeric parameters (rates, frozen snapshots) may vary")
    espace = EnsembleSpace.stack(spaces)
    if executor is None:
        executor = EnsembleExecutor()
    count = B if count is None else int(count)
    num_steps = model.num_steps if steps is None else int(steps)
    windows = max(1, int(windows))
    if windows > 1 and executor.impl != "xla":
        raise ValueError(
            f"windowed dispatch supports impl='xla' only, got "
            f"{executor.impl!r} (the stat-lane carry of the active "
            "impls does not window)")
    rates_np, frozens_np = flow_params(models)
    # the uniform-rate rule binds REAL lanes only: padding lanes are zero
    # values, which the shared rate keeps zero
    uniform = (None if executor.impl != "pipeline"
               else _uniform_rates(model, models, rates_np[:count]))
    runner = executor.runner_for(model, espace, uniform, donate=donate)
    # queued before the (possibly donating) runner: the stream orders the
    # runner's writes after these reads
    initial_d = batched_totals(espace.values)
    st = inject.active()
    poisons = (st.ensemble_poisons(st.bump("ensemble"))
               if st is not None else [])
    t0 = _time.perf_counter()
    before = kernel_launches()
    steps_list = _window_steps(num_steps, windows)
    out, donated = _run_windows(runner, executor, espace.values, rates_np,
                                frozens_np, steps_list, donate)
    launched = {k: v - before[k] for k, v in kernel_launches().items()}
    values = out[0]
    for lane, fault in poisons:
        inject.poison_lane_values(values, lane, fault)
    # right behind the runner on the same stream: the totals the reports
    # carry and their copies to the host, then the flight's event, so that
    # completing this flight waits for nothing queued after it
    totals = {
        "initial": {k: _fetch_async(v) for k, v in initial_d.items()},
        "final": {k: _fetch_async(v)
                  for k, v in batched_totals(values).items()},
        "last": _fetch_async(executor.last_execute_for(model, espace)(
            values, rates_np, frozens_np)),
    }
    done = None
    if espace.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(espace.device))
    return EnsembleInFlight(
        executor=executor, model=model, espace=espace, out=out,
        rates=rates_np, frozens=frozens_np, count=count,
        num_steps=num_steps, totals=totals, done=done, t0=t0,
        t_launched=_time.perf_counter(), launches=launched,
        windows=len(steps_list), donated_windows=donated)


def _active_report(executor, model, espace, num_steps, count,
                   stats: dict) -> tuple[dict, list]:
    """The active engines' batch record and per-lane records (the JAX
    package's folding of its ``[B]`` stat lanes)."""
    from ..ops.fused_active import pass_count

    plan, k = stats["plan"], stats["k"]
    fb = stats["fallback"]
    at = stats["active"]
    ff = stats["flags_fused"]
    nattr = len({f.attr for f in model.flows})
    passes = pass_count(num_steps, k) if ff is not None else num_steps
    denom = passes * nattr * plan.ntiles
    report = {
        "impl": executor.impl,
        "steps": num_steps,
        "lanes": count,
        "fallback_steps": int(sum(fb[:count])),
        "per_lane_fallback_steps": [int(x) for x in fb[:count]],
        "tile": list(plan.tile),
        "tiles": plan.ntiles,
        "capacity": plan.capacity,
        "fallback_tiles": plan.fallback_tiles,
        "mean_active_fraction": (float(sum(at[:count])) / (count * denom)
                                 if count and denom else None),
    }
    if ff is not None:
        report.update({
            "composed_k": k,
            "passes": passes,
            "flags_fused": int(sum(ff[:count])),
            "per_lane_flags_fused": [int(x) for x in ff[:count]],
        })
    lanes = []
    for i in range(count):
        lane = {"impl": executor.impl, "fallback_steps": int(fb[i]),
                "mean_active_fraction": (float(at[i]) / denom
                                         if denom else None)}
        if ff is not None:
            lane["flags_fused"] = int(ff[i])
        lanes.append(lane)
    return report, lanes


def complete_ensemble(inflight: EnsembleInFlight, *,
                      check_conservation: bool = True,
                      tolerance: float = 1e-3,
                      rtol: Optional[float] = None,
                      on_violation: str = "raise") -> list:
    """Wait for a launched dispatch (its own event: work queued after it
    keeps running) and build the per-lane results: the completion half of
    ``run_ensemble`` (its return contract). The ``fetch_nan`` chaos seam
    fires here, downstream of the device work: a poisoned lane's totals are
    taken again, and the per-lane conservation machinery must catch it like
    a diverged lane."""
    if on_violation not in ("raise", "mark"):
        raise ValueError(f"unknown on_violation {on_violation!r}")
    executor = inflight.executor
    model = inflight.model
    espace = inflight.espace
    count = inflight.count
    num_steps = inflight.num_steps
    fetch_t0 = _time.perf_counter()
    if inflight.done is not None:
        inflight.done.synchronize()
    # the batch wall bills the host-observed segments: launch (assembly and
    # enqueue) plus fetch (the wait)
    wall = ((inflight.t_launched - inflight.t0)
            + (_time.perf_counter() - fetch_t0))
    out, stats = inflight.out
    totals = inflight.totals
    st = inject.active()
    if st is not None:
        f = st.take("fetch", st.bump("fetch"), kinds=("fetch_nan",))
        if f is not None:
            inject.poison_lane_values(out, f.lane if f.lane is not None
                                      else 0, f)
            # the chaos path alone waits here, for the poisoned totals
            totals = dict(totals, final={
                k: v.cpu() for k, v in batched_totals(out).items()},
                last=executor.last_execute_for(model, espace)(
                    out, inflight.rates, inflight.frozens).cpu())
    lane_reports: list = [None] * count
    if executor.impl in ("active", "active_fused"):
        executor.last_backend_report, lane_reports = _active_report(
            executor, model, espace, num_steps, count, stats)
    elif executor.impl == "pipeline":
        executor.last_backend_report = {
            "impl": "pipeline", "kernel": "K5 pipeline_stencil",
            "substeps": executor.substeps,
            "launches": inflight.launches["pipeline_stencil"]}
        lane_reports = [dict(executor.last_backend_report)
                        for _ in range(count)]
    else:
        executor.last_backend_report = None
    initial = _host(totals["initial"])
    final = _host(totals["final"])
    last_exec = totals["last"].numpy()
    # IR models are checked on their conservation view (summed mass minus
    # the integrated budgets, and the per-term contract keys), flow models
    # on the per-channel totals
    viewfn = getattr(model, "conservation_view", None)
    vinitial = viewfn(initial) if viewfn is not None else initial
    vfinal = viewfn(final) if viewfn is not None else final
    bad: list[int] = []
    errs = thresholds = None
    wkeys: Optional[list[str]] = None
    if check_conservation:
        thresholds = conservation_thresholds(
            vinitial, espace.shape, espace.dtype, tolerance, rtol)
        if viewfn is not None and "mass" in vinitial:
            # the reconciliation sums every channel and budget reduction:
            # each gets its own rounding share (the serial check's rule)
            thresholds = thresholds * max(len(initial), 1)
        errs, bad = conservation_violations(vinitial, vfinal, thresholds,
                                            count)
        if bad:
            wkeys = _worst_violation_keys(vinitial, vfinal)
            if on_violation == "raise":
                raise _violation_error(errs, thresholds, bad[0], len(bad),
                                       count, key=wkeys[bad[0]], model=model)

    out_es = dataclasses.replace(espace, values=dict(out))
    results: list = []
    badset = set(bad)
    for i in range(count):
        if i in badset:
            e = _violation_error(errs, thresholds, i,
                                 key=wkeys[i] if wkeys else None,
                                 model=model)
            # the batch's wall rides the error too, so serving counters stay
            # honest even when every lane violated
            e.wall_time_s = wall
            results.append(e)
            continue
        results.append((out_es.scenario(i), Report(
            comm_size=1,
            rank_id=0,
            steps=num_steps,
            initial_total={k: float(initial[k][i]) for k in initial},
            final_total={k: float(final[k][i]) for k in final},
            last_execute=[float(x) for x in last_exec[i]],
            wall_time_s=wall,
            backend_report=lane_reports[i],
            impl=executor.impl,
        )))
    return results


def run_ensemble(model, spaces, *, models=None, executor=None, steps=None,
                 check_conservation: bool = True, tolerance: float = 1e-3,
                 rtol: Optional[float] = None, count: Optional[int] = None,
                 on_violation: str = "raise") -> list:
    """Step B scenarios together; the engine behind ``Model.execute_many``
    and the scheduler.

    ``models`` (default: ``model`` for every lane) supplies per-scenario
    numeric parameters; every entry must share ``model``'s structure
    (``structure_key``). ``count`` limits conservation checks and returned
    results to the first ``count`` lanes (the scheduler's padding).
    ``on_violation``: ``"raise"`` raises ``EnsembleConservationError`` on
    the first bad lane; ``"mark"`` returns that lane's error object in its
    result slot instead.

    Returns ``(CellularSpace, Report)`` per real lane; each Report carries
    the scenario's own totals and ``last_execute`` (bit for bit the serial
    run's on the ``xla`` impl), ``wall_time_s`` the batch's wall time.
    ``launch_ensemble`` + ``complete_ensemble`` back to back."""
    if on_violation not in ("raise", "mark"):
        raise ValueError(f"unknown on_violation {on_violation!r}")
    inflight = launch_ensemble(model, spaces, models=models,
                               executor=executor, steps=steps, count=count)
    return complete_ensemble(inflight, check_conservation=check_conservation,
                             tolerance=tolerance, rtol=rtol,
                             on_violation=on_violation)
