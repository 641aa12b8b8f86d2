"""Model: the simulation orchestrator (counterpart of
``mpi_model_tpu/models/model.py``, serial path).

- ``Model.make_step`` builds the per-step function for a space's geometry:
  ``impl="xla"`` is the plain-op torch path (every flow), ``"pallas"`` the
  hand-written fused kernel K1 (all field flows plain ``Diffusion``), and
  ``"auto"`` picks ``"pallas"`` where it is statically eligible, else
  ``"xla"``. Unlike the JAX package, ``"auto"`` never probes the kernel and
  never catches its failure: a build or launch error propagates.
- ``SerialExecutor`` runs the step loop on one device; on the kernel path it
  ping-pongs two preallocated device buffers per channel instead of
  allocating per call, and never writes the input space's tensors.
- ``Model.execute`` checks mass conservation and returns a ``Report``.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Optional, Sequence, Union

import torch

from ..core.cell import MOORE_OFFSETS
from ..core.cellular_space import CellularSpace
from ..ops.flow import Diffusion, Flow, PointFlow, build_outflow
from ..ops.fused_stencil import KERNEL_DTYPES, PallasDiffusionStep, \
    check_nsteps, ghost_depth, resolve_block
from ..ops.stencil import neighbor_counts, point_flow_step, transport

Values = dict[str, torch.Tensor]

#: impls the JAX package has that this port does not carry yet
_NOT_PORTED = ("composed", "active", "active_fused")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA package yet; see "
        "ROADMAP.md for the queue of work")


class ConservationError(AssertionError):
    """Mass-conservation contract violated."""


def default_conservation_rtol(shape: tuple[int, int], dtype) -> float:
    """Default relative conservation tolerance ≈ 4·eps·log2(N), the
    pairwise-summation error bound of a reduction."""
    n = max(shape[0] * shape[1], 2)
    return 4.0 * float(torch.finfo(dtype).eps) * math.log2(n)


@dataclasses.dataclass
class Report:
    """Run report. ``impl`` names the step path that ran (``"pallas"``,
    ``"xla"`` or ``"point"``); ``backend_report`` carries the kernel launch
    count on the kernel path."""

    comm_size: int
    rank_id: int
    steps: int
    initial_total: dict[str, float]
    final_total: dict[str, float]
    last_execute: list[float]
    wall_time_s: float
    backend_report: Optional[dict] = None
    impl: Optional[str] = None

    def conservation_error(self) -> float:
        return max(
            abs(self.final_total[k] - self.initial_total[k])
            for k in self.initial_total
        )


class SerialExecutor:
    """Single-device execution of the step loop.

    ``step_impl`` is ``"xla"``, ``"pallas"`` or ``"auto"`` (see
    ``Model.make_step``). ``substeps`` batches that many model steps into
    each step call (inside the kernel on the pallas path); any remainder of
    ``num_steps`` runs as single steps, so results do not depend on it.
    """

    comm_size = 1

    def __init__(self, step_impl: str = "xla", substeps: int = 1,
                 compute_dtype=None):
        if step_impl in _NOT_PORTED:
            raise _not_ported(f"step_impl={step_impl!r}")
        self.step_impl = step_impl
        self.substeps = max(1, int(substeps))
        self.compute_dtype = compute_dtype
        #: the step path the last run actually used
        self.last_impl: Optional[str] = None
        #: kernel launches of the last run, on the kernel path
        self.last_backend_report: Optional[dict] = None

    def run_model(self, model: "Model", space: CellularSpace,
                  num_steps: int) -> Values:
        self.last_backend_report = None
        values = dict(space.values)
        # all-point-flow models: the point scatter per step, plain ops
        if (self.step_impl in ("xla", "auto") and num_steps > 0
                and model.flows
                and all(isinstance(f, PointFlow) for f in model.flows)):
            step = model.make_step(space, impl="xla")
            self.last_impl = "point"
            for _ in range(num_steps):
                values = step(values)
            return values

        q, r = divmod(num_steps, self.substeps)
        stepk = (model.make_step(space, impl=self.step_impl,
                                 substeps=self.substeps,
                                 compute_dtype=self.compute_dtype)
                 if q else None)
        step1 = (model.make_step(space, impl=self.step_impl,
                                 compute_dtype=self.compute_dtype)
                 if r else None)
        steps = [s for s in (stepk, step1) if s is not None]
        self.last_impl = steps[0].impl if steps else None
        steppers = [st for s in steps for st in s.steppers.values()]
        before = sum(st.launches for st in steppers)
        kernel_attrs = {a for s in steps for a in s.steppers}
        on_card = space.device.type == "cuda"
        # two preallocated buffers per kernel channel, used in turn: a call
        # reads one and writes the other, never the input space's tensor
        bufs = ({a: (torch.empty_like(values[a]), torch.empty_like(values[a]))
                 for a in kernel_attrs} if on_card else {})
        for step, count in ((stepk, q), (step1, r)):
            for _ in range(count if step is not None else 0):
                out = {a: (b[0] if values[a] is not b[0] else b[1])
                       for a, b in bufs.items()}
                values = step(values, out=out or None)
        if steppers:
            self.last_backend_report = {
                "kernel": "K1 fused_stencil",
                "substeps": self.substeps,
                "launches": sum(st.launches for st in steppers) - before,
            }
        return values


class Model:
    """Orchestrates flows over a CellularSpace for ``time/time_step``
    steps: ``Model(flow, final_time, time_step)``."""

    offsets: tuple[tuple[int, int], ...] = MOORE_OFFSETS

    def __init__(self, flow: Union[Flow, Sequence[Flow]], time: float = 1.0,
                 time_step: float = 1.0, *,
                 offsets: Optional[Sequence[tuple[int, int]]] = None):
        self.flows: list[Flow] = (list(flow) if isinstance(flow, (list, tuple))
                                  else [flow])
        self.time = float(time)
        self.time_step = float(time_step)
        if offsets is not None:
            self.offsets = tuple(offsets)
        self._step_cache: dict = {}
        self._default_executor: Optional[SerialExecutor] = None

    @property
    def flow(self) -> Flow:
        return self.flows[0]

    @property
    def num_steps(self) -> int:
        return max(1, int(round(self.time / self.time_step)))

    def pallas_rates(self) -> Optional[dict[str, float]]:
        """attr → summed uniform rate when every field flow is a plain
        ``Diffusion`` (what the fused kernel computes); None otherwise."""
        rates: dict[str, float] = {}
        for f in self.flows:
            if isinstance(f, PointFlow):
                continue
            if type(f) is not Diffusion:
                return None
            rates[f.attr] = rates.get(f.attr, 0.0) + f.flow_rate
        return rates

    @staticmethod
    def pallas_dtype_ok(space: CellularSpace) -> bool:
        """The kernel stores f32 or bf16 and computes in f32; f64 grids
        stay on the plain path."""
        return space.dtype in KERNEL_DTYPES

    def make_step(self, space: CellularSpace, impl: str = "xla",
                  substeps: int = 1,
                  compute_dtype=None) -> Callable[..., Values]:
        """Build ``step(values, out=None) -> values`` for this space.

        ``impl``: ``"xla"`` (plain torch ops, every flow), ``"pallas"`` (the
        fused kernel; requires every field flow to be a plain ``Diffusion``
        on a full, non-partition f32/bf16 grid, with no point flows when
        ``substeps > 1``; raises ``ValueError`` otherwise) or ``"auto"``
        (``"pallas"`` when those conditions hold and the kernel's ghost
        depth admits ``substeps``, else ``"xla"``; no probe and no
        fallback on failure). ``substeps > 1`` advances that many steps
        per call. ``out`` optionally maps kernel channels to preallocated
        output tensors. The step carries ``.impl``, ``.substeps`` and
        ``.steppers`` (channel → ``PallasDiffusionStep``)."""
        for f in self.flows:
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
        if impl in _NOT_PORTED:
            raise _not_ported(f"impl={impl!r}")
        if impl not in ("xla", "pallas", "auto"):
            raise ValueError(f"unknown step impl {impl!r}")
        if compute_dtype not in (None, torch.float32, "float32"):
            raise _not_ported("compute_dtype other than float32 (bf16 "
                              "interior math)")
        substeps = int(substeps)
        if substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {substeps}")
        key = (space.shape, space.global_shape, (space.x_init, space.y_init),
               str(space.dtype), str(space.device), self.offsets, impl,
               substeps, tuple(f.fingerprint() for f in self.flows))
        cached = self._step_cache.get(key)
        if cached is not None:
            return cached

        offsets = self.offsets
        origin = (space.x_init, space.y_init)
        gshape = space.global_shape
        shape = space.shape
        device = space.device
        point_flows = [f for f in self.flows if isinstance(f, PointFlow)]
        field_flows = [f for f in self.flows if not isinstance(f, PointFlow)]
        pt_by_attr: dict[str, list[PointFlow]] = {}
        for f in point_flows:
            # sources outside this partition contribute nothing here
            if f.local_source({f.attr: next(iter(space.values.values()))},
                              origin)[2]:
                pt_by_attr.setdefault(f.attr, []).append(f)

        steppers: dict[str, PallasDiffusionStep] = {}
        if impl in ("pallas", "auto"):
            rates = self.pallas_rates()
            live = {a: r for a, r in (rates or {}).items() if r != 0.0}
            eligible = (bool(live) and not space.is_partition
                        and self.pallas_dtype_ok(space)
                        and all(space.values[a].dtype == space.dtype
                                for a in live)
                        and (substeps == 1 or not pt_by_attr))
            if impl == "pallas" and not eligible:
                if (rates is None and field_flows and all(
                        f.footprint == "pointwise" for f in field_flows)):
                    raise _not_ported(
                        "impl='pallas' for non-Diffusion pointwise flows "
                        "(the fused field kernel K4)")
                raise ValueError(
                    "impl='pallas' requires all field flows to be plain "
                    "Diffusion with a nonzero rate on a full "
                    "(non-partition) f32/bf16 grid, every flow channel in "
                    "the space dtype — the kernel computes in f32, so f64 "
                    "stays on the plain path — (and no point flows when "
                    "substeps > 1); got "
                    f"flows={[type(f).__name__ for f in self.flows]}, "
                    f"is_partition={space.is_partition}, "
                    f"dtype={space.dtype}, substeps={substeps}. "
                    "Use impl='xla' or 'auto'.")
            if (impl == "auto" and eligible
                    and substeps > ghost_depth(shape, space.dtype)):
                eligible = False  # a static shape rule, not a probe
            if eligible:
                # refuse a too-deep substeps now, not at the first call
                check_nsteps(substeps, resolve_block(shape, space.dtype),
                             space.dtype)
                steppers = {
                    a: PallasDiffusionStep(shape, r, dtype=space.dtype,
                                           offsets=offsets, nsteps=substeps)
                    for a, r in live.items()}

        counts_cache: list = []

        def counts() -> torch.Tensor:
            if not counts_cache:
                counts_cache.append(neighbor_counts(
                    shape, offsets, origin, gshape, space.dtype, device))
            return counts_cache[0]

        def single(values: Values, out: Optional[Values] = None) -> Values:
            new = dict(values)
            if steppers:
                for attr, stepper in steppers.items():
                    new[attr] = stepper(values[attr],
                                        out=(out or {}).get(attr))
            elif field_flows:
                for attr, o in build_outflow(field_flows, values,
                                             origin).items():
                    new[attr] = transport(values[attr], o, counts(), offsets)
            # point amounts read the PRE-step values
            for attr, pflows in pt_by_attr.items():
                locs = [f.local_source(values, origin) for f in pflows]
                xs = torch.tensor([lx for lx, _, _ in locs], device=device)
                ys = torch.tensor([ly for _, ly, _ in locs], device=device)
                amts = torch.stack([f.amount(values, origin)
                                    for f in pflows])
                new[attr] = point_flow_step(new[attr], xs, ys, amts,
                                            counts(), offsets)
            return new

        if substeps == 1 or steppers:
            step = single
        else:
            def step(values: Values, out: Optional[Values] = None) -> Values:
                for _ in range(substeps):
                    values = single(values)
                return values

        step.impl = "pallas" if steppers else "xla"
        step.substeps = substeps
        step.steppers = steppers
        self._step_cache[key] = step
        return step

    def conservation_threshold(self, space: CellularSpace,
                               tolerance: float = 1e-3,
                               rtol: Optional[float] = None,
                               initial_totals: Optional[dict] = None) -> float:
        """Allowed |Δtotal|: ``tolerance + rtol * |initial_total|``."""
        if rtol is None:
            rtol = default_conservation_rtol(space.shape, space.dtype)
        if initial_totals is None:
            initial_totals = {k: float(space.total(k)) for k in space.values}
        scale = max(abs(t) for t in initial_totals.values())
        return tolerance + rtol * scale

    def execute(
        self,
        space: CellularSpace,
        executor: Optional[SerialExecutor] = None,
        *,
        steps: Optional[int] = None,
        check_conservation: bool = True,
        tolerance: float = 1e-3,
        rtol: Optional[float] = None,
    ) -> tuple[CellularSpace, Report]:
        """Run the model; returns the final space and a Report. Raises
        ``ConservationError`` when the global sum drifts past
        ``conservation_threshold`` (skipped for a partition space)."""
        if executor is None:
            if self._default_executor is None:
                self._default_executor = SerialExecutor()
            executor = self._default_executor
        num_steps = self.num_steps if steps is None else steps
        initial = {k: float(space.total(k)) for k in space.values}
        t0 = _time.perf_counter()
        out_values = executor.run_model(self, space, num_steps)
        if space.device.type == "cuda":
            torch.cuda.synchronize(space.device)
        wall = _time.perf_counter() - t0
        out_space = space.with_values(out_values)
        final = {k: float(out_space.total(k)) for k in out_space.values}
        last_exec = [float(f.execute(out_space)) for f in self.flows]
        report = Report(
            comm_size=getattr(executor, "comm_size", 1),
            rank_id=0,
            steps=num_steps,
            initial_total=initial,
            final_total=final,
            last_execute=last_exec,
            wall_time_s=wall,
            backend_report=getattr(executor, "last_backend_report", None),
            impl=getattr(executor, "last_impl", None),
        )
        if check_conservation and not space.is_partition:
            thresh = self.conservation_threshold(space, tolerance, rtol,
                                                 initial_totals=initial)
            err = max(abs(final[k] - initial[k]) for k in initial)
            if err > thresh:
                raise ConservationError(
                    f"mass conservation violated: |Δ| = "
                    f"{err:.3e} > {thresh:.3e} "
                    f"(initial={initial}, final={final})")
        return out_space, report

    def execute_many(self, *args, **kwargs):
        """The ensemble engine is not ported yet."""
        raise _not_ported("Model.execute_many (the ensemble engine)")
