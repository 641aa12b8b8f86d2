"""Model: the simulation orchestrator (counterpart of
``mpi_model_tpu/models/model.py``, serial path).

- ``Model.make_step`` builds the per-step function for a space's geometry:
  ``impl="xla"`` is the plain-op torch path (every flow), ``"pallas"`` the
  hand-written fused kernel K1 (all field flows plain ``Diffusion``) or the
  fused field kernel K4 (any other pointwise field flows, lowered to
  programs when the step is built),
  ``"composed"`` the composed k-step filter K3, ``"active"`` the plain
  active-tile engine, ``"active_fused"`` the fused active kernels K6 + K7,
  and ``"auto"`` picks ``"pallas"`` where it is statically eligible, else
  ``"xla"``. Unlike the JAX package, nothing probes a kernel or catches its
  failure: a build or launch error propagates.
- ``SerialExecutor`` runs the step loop on one device; on the K1 and K4
  paths it ping-pongs two preallocated device buffers per written channel
  instead of allocating per call, and never writes the input space's
  tensors. For
  ``"active"`` and ``"active_fused"`` on all-``Diffusion`` models it runs
  the amortized whole-run runners (pad once, carry the tile map).
- The active impls' dense fallback is chosen statically: K1 (one step per
  call) when the space is on the card, f32/bf16 and not a partition, else
  the plain transport. (The JAX package probes its kernel and catches a
  failure.)
- The plain path's dense transport of ``Diffusion`` flows (one per
  channel), on every impl and in the ensemble's ``ScenarioStep``, is the
  Flow IR's registered lowering (``ir.lower.dense_apply``), as in the JAX
  package.
- ``Model.execute`` checks mass conservation (``_raise_if_violated``, which
  ``ir.FlowIRModel`` overrides with its budget reconciliation) and returns
  a ``Report``;
  ``Model.execute_many`` runs a batch of scenarios through the ensemble
  engine (``ensemble.batch``).
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
import warnings
from typing import Callable, Optional, Protocol, Sequence, Union, \
    runtime_checkable

import torch

from ..core.cell import MOORE_OFFSETS
from ..core.cellular_space import CellularSpace
from ..ops import composed_stencil as _k3
from ..ops import field_stencil as _k4
from ..ops import fused_active as _k67
from ..ops import fused_stencil as _k1
from ..ops import pipeline_stencil as _k5
from ..ops.active import ActiveDiffusionStep, build_active_runner, plan_for
from ..ops.composed_stencil import ComposedDiffusionStep, choose_k, max_k
from ..ops.field_stencil import FieldPlanError, PallasFieldStep
from ..ops.flow import Diffusion, Flow, PointFlow, build_outflow
from ..ops.fused_active import FusedActiveStep, build_fused_runner, \
    choose_fused_k, pass_count
from ..ops.fused_stencil import KERNEL_DTYPES, PallasDiffusionStep, \
    check_nsteps, ghost_depth, resolve_block, resolve_compute_dtype
from ..ops.point_kernel import build_point_plans, serial_point_runner
from ..ops.stencil import neighbor_counts, point_flow_step, transport
from ..resilience import inject

Values = dict[str, torch.Tensor]

IMPLS = ("xla", "pallas", "auto", "composed", "active", "active_fused")


def kernel_launches() -> dict[str, int]:
    """Launch counts of every kernel of the port, by kernel source name."""
    return {"fused_stencil": _k1.launches(),
            "composed_stencil": _k3.launches(),
            "field_stencil": _k4.launches(),
            "pipeline_stencil": _k5.launches(),
            **_k67.launches(),
            "fused_stencil_halo": _k1.halo_launches(),
            "composed_stencil_halo": _k3.halo_launches(),
            "field_stencil_halo": _k4.halo_launches()}


def _launches_since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


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
    ``"composed"``, ``"active"``, ``"active_fused"``, ``"xla"`` or
    ``"point"``); ``backend_report`` carries the kernel launch counts and the
    composed / active engines' records."""

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


@runtime_checkable
class Executor(Protocol):
    """Execution strategy: how the step loop runs over devices
    (``SerialExecutor``, ``parallel.ShardMapExecutor``,
    ``parallel.AutoShardedExecutor``, or a user's own)."""

    def run_model(self, model: "Model", space: CellularSpace,
                  num_steps: int) -> Values: ...

    @property
    def comm_size(self) -> int: ...


class SerialExecutor:
    """Single-device execution of the step loop.

    ``step_impl`` is ``"xla"``, ``"pallas"``, ``"composed"``, ``"active"``,
    ``"active_fused"`` or ``"auto"`` (see ``Model.make_step``). ``substeps``
    batches that many model steps into each step call (inside the kernel on
    the pallas and composed paths, as composed-k passes on active_fused);
    any remainder of ``num_steps`` runs as single steps, so results do not
    depend on it. ``active_opts`` tunes the active engine (keys ``tile``,
    ``capacity``, ``max_active_frac``; see ``ops.active.plan_for``);
    ``composed_variant`` picks K3's form under ``"composed"`` (``"auto"``,
    JAX's rule, by default).
    """

    comm_size = 1

    def __init__(self, step_impl: str = "xla", substeps: int = 1,
                 compute_dtype=None, active_opts: Optional[dict] = None,
                 composed_variant: str = "auto"):
        self.step_impl = step_impl
        self.substeps = max(1, int(substeps))
        self.compute_dtype = compute_dtype
        #: K3's variant under "composed" (Model.make_step)
        self.composed_variant = composed_variant
        #: active-tile engine knobs (ops.active.plan_for); ignored by the
        #: other impls
        self.active_opts = active_opts
        #: the step path the last run actually used
        self.last_impl: Optional[str] = None
        #: per-run detail (Report.backend_report): kernel launches, and the
        #: composed / active engines' records
        self.last_backend_report: Optional[dict] = None
        #: union of every tile the last active run wrote: {"tile", "grid",
        #: "map"} with a bool [gi, gj] host array; None after any run that
        #: cannot vouch for it
        self.last_dirty_tiles: Optional[dict] = None
        self._cache: dict = {}

    def run_model(self, model: "Model", space: CellularSpace,
                  num_steps: int) -> Values:
        # chaos seam (resilience.inject): one module-global read when no
        # plan is armed, and the run below is untouched
        st = inject.active()
        if st is None:
            return self._run_inner(model, space, num_steps)
        idx = st.bump("executor")
        fault = st.take("executor", idx, kinds=("exc", "nan"))
        if fault is not None and fault.kind == "exc":
            # the call index in the message: two injected faults never
            # share a signature (that would read as one deterministic fault)
            raise inject.InjectedFault(
                f"injected executor fault on call {idx} "
                f"({num_steps}-step chunk)")
        out = self._run_inner(model, space, num_steps)
        if fault is not None:  # "nan": poison the chunk's output
            out = inject.poison_values(out, fault, st.plan)
            # the poison wrote outside the engine's tracked tiles
            self.last_dirty_tiles = None
        return out

    def _run_inner(self, model: "Model", space: CellularSpace,
                   num_steps: int) -> Values:
        self.last_backend_report = None
        self.last_dirty_tiles = None
        values = dict(space.values)
        # all-point-flow models step only the involved cells (one gather
        # and one scatter a run, bitwise the full-grid path) when
        # build_point_plans admits them; otherwise the step the impl asks
        if (self.step_impl in ("xla", "auto", "active", "active_fused")
                and num_steps > 0
                and model.flows
                and all(isinstance(f, PointFlow) for f in model.flows)):
            key = ("pointmini", space.shape, space.global_shape,
                   (space.x_init, space.y_init), str(space.dtype),
                   model.offsets,
                   tuple(f.fingerprint() for f in model.flows))
            runner = self._cache.get(key)
            if runner is None:
                plans = build_point_plans(model.flows, space, model.offsets)
                # False caches the "ineligible" verdict
                runner = (serial_point_runner(plans, space.dtype)
                          if plans is not None else False)
                self._cache[key] = runner
            if runner:
                self.last_impl = "point"
                return runner(values, num_steps)

        if self.step_impl in ("active", "active_fused") and num_steps > 0:
            live = self._amortized_live(model, space)
            if live:
                return self._run_active(model, space, live, num_steps)

        q, r = divmod(num_steps, self.substeps)
        stepk = (model.make_step(space, impl=self.step_impl,
                                 substeps=self.substeps,
                                 compute_dtype=self.compute_dtype,
                                 composed_variant=self.composed_variant)
                 if q else None)
        step1 = (model.make_step(space, impl=self.step_impl,
                                 compute_dtype=self.compute_dtype,
                                 composed_variant=self.composed_variant)
                 if r else None)
        steps = [s for s in (stepk, step1) if s is not None]
        step_any = steps[0] if steps else None
        self.last_impl = step_any.impl if step_any is not None else None
        # a nonlinear IR model's active steps count their calls, dense
        # steps and active tiles (one dict per distinct step)
        stats = list({id(d): d for d in (getattr(s, "stats", None)
                                         for s in steps) if d}.values())
        before_stats = {k: sum(d[k] for d in stats)
                        for k in ("calls", "fallback_steps",
                                  "active_tiles")}
        before = kernel_launches()
        on_card = space.device.type == "cuda"
        # K1 and K4 paths: two preallocated buffers per channel the kernel
        # writes, used in turn: a call reads one and writes the other, never
        # the input space's tensor
        kernel_attrs = {a for s in steps if s.impl == "pallas"
                        for a in s.steppers}
        bufs = ({a: (torch.empty_like(values[a]), torch.empty_like(values[a]))
                 for a in kernel_attrs} if on_card else {})
        for step, count in ((stepk, q), (step1, r)):
            # a step with a whole-run form (a nonlinear IR model's active
            # step) owns its buffers across the run
            run = getattr(step, "run", None)
            if run is not None:
                values = run(values, count)
                continue
            for _ in range(count if step is not None else 0):
                out = {a: (b[0] if values[a] is not b[0] else b[1])
                       for a, b in bufs.items()}
                values = step(values, out=out or None)
        ran = _launches_since(before)
        if step_any is None:
            return values
        if step_any.impl == "pallas" and step_any.field_stepper is not None:
            self.last_backend_report = {
                "kernel": "K4 field_stencil",
                "substeps": self.substeps,
                "launches": ran["field_stencil"],
                "channels_written": list(
                    step_any.field_stepper.program.outputs),
            }
        elif step_any.impl == "pallas":
            self.last_backend_report = {
                "kernel": "K1 fused_stencil",
                "substeps": self.substeps,
                "launches": ran["fused_stencil"],
            }
        elif step_any.impl == "composed":
            # the chosen k and the remainder chunk's depth, so a composed
            # run that degenerated to k=1 is observable (a nonlinear IR
            # model's composed step runs no kernel: form None)
            self.last_backend_report = {
                "impl": "composed",
                "kernel": ("K3 composed_stencil"
                           if step_any.form is not None else None),
                "substeps": self.substeps,
                "composed_k": step_any.composed_k,
                "composed_passes_per_call": step_any.composed_passes,
                "remainder_steps": r,
                "remainder_k": (step1.composed_k if step1 is not None
                                else None),
                #: the variant asked for, and the form it resolved to
                #: (the vpu or the mxu kernel)
                "variant": step_any.variant,
                "form": step_any.form,
                "launches": ran["composed_stencil"],
            }
        elif step_any.impl == "active" and stats:
            # a nonlinear IR model's active step: its counters over this run
            ran_stats = {k: sum(d[k] for d in stats) - before_stats[k]
                         for k in before_stats}
            plan = step_any.plan
            self.last_backend_report = {
                "impl": "active",
                "steps": int(num_steps),
                "fallback_steps": ran_stats["fallback_steps"],
                "tile": list(plan.tile),
                "tiles": plan.ntiles,
                "capacity": plan.capacity,
                "fallback_tiles": plan.fallback_tiles,
                "mean_active_fraction": (
                    ran_stats["active_tiles"] / (ran_stats["calls"]
                                                 * plan.ntiles)
                    if ran_stats["calls"] else None),
                "host_syncs": ran_stats["calls"],
                "kernel_launches": ran,
                "launches": sum(ran.values()),
            }
        elif step_any.impl == "active_fused":
            # the stateless fused form (point-flow compositions land here)
            self.last_backend_report = {
                "impl": "active_fused",
                "substeps": self.substeps,
                "composed_k": step_any.composed_k,
                "composed_passes_per_call": step_any.composed_passes,
                "remainder_steps": r,
                "kernel_launches": ran,
                "launches": sum(ran.values()),
            }
        return values

    @staticmethod
    def _amortized_live(model: "Model",
                        space: CellularSpace) -> Optional[dict]:
        """The live attr → rate map when the amortized active runners
        apply: all-Diffusion field flows, no point flows, every live channel
        floating and in the space dtype. None sends the run to the generic
        loop, whose ``make_step`` raises the clean errors."""
        rates = model.pallas_rates()
        live = {a: r for a, r in (rates or {}).items() if r != 0.0}
        if (rates is None or not live
                or any(isinstance(f, PointFlow) for f in model.flows)):
            return None
        if not all(space.values[a].dtype.is_floating_point
                   and space.values[a].dtype == space.dtype for a in live):
            return None
        return live

    def _run_active(self, model: "Model", space: CellularSpace,
                    live: dict, num_steps: int) -> Values:
        """The amortized active runners (``ops.active`` /
        ``ops.fused_active``): pad once, carry the tile map across the run,
        and record the engine's counters."""
        impl = self.step_impl
        resolve_compute_dtype(self.compute_dtype)
        opts = dict(self.active_opts or {})
        key = (impl, space.shape, space.global_shape,
               (space.x_init, space.y_init), str(space.dtype),
               str(space.device), model.offsets,
               tuple(sorted(live.items())),
               self.substeps if impl == "active_fused" else 1,
               tuple(sorted(opts.items())))
        entry = self._cache.get(key)
        if entry is None:
            plan = plan_for(space.shape, tile=opts.get("tile"),
                            capacity=opts.get("capacity"),
                            max_active_frac=opts.get("max_active_frac",
                                                     0.25))
            dense_fns = {}
            for a, r in live.items():
                fn = model.dense_fallback(space, r)
                if fn is not None:
                    dense_fns[a] = fn
            common = dict(origin=(space.x_init, space.y_init),
                          global_shape=space.global_shape, plan=plan,
                          dense_fns=dense_fns, track_dirty=True)
            if impl == "active":
                k = 1
                run = build_active_runner(space.shape, live, model.offsets,
                                          space.dtype, **common)
            else:
                k = choose_fused_k(self.substeps, plan)
                run = build_fused_runner(space.shape, live, model.offsets,
                                         space.dtype, k=k, **common)
            entry = (run, plan, k)
            self._cache[key] = entry
        run, plan, k = entry
        before = kernel_launches()
        out, stats = run(dict(space.values), num_steps)
        ran = _launches_since(before)
        dirty = stats[-1]
        self.last_impl = impl
        self.last_dirty_tiles = {"tile": plan.tile, "grid": plan.grid,
                                 "map": dirty.cpu().numpy()}
        nattr = len(live)
        report = {"impl": impl, "steps": int(num_steps)}
        if impl == "active":
            fb, at = stats[0], stats[1]
            passes = num_steps
        else:
            fb, at, ff = stats[0], stats[1], stats[2]
            passes = pass_count(num_steps, k)
            report.update(composed_k=k, passes=passes)
        #: (attr, step/pass) pairs that ran the dense fallback
        report["fallback_steps"] = int(fb)
        if impl == "active_fused":
            #: (attr, pass) pairs whose next tile map came from the
            #: kernel's flags: flags_fused + fallback_steps == passes × attrs
            report["flags_fused"] = int(ff)
        report.update({
            "tile": list(plan.tile),
            "tiles": plan.ntiles,
            "capacity": plan.capacity,
            "fallback_tiles": plan.fallback_tiles,
            "mean_active_fraction": (
                float(at) / (passes * nattr * plan.ntiles)
                if passes and nattr else None),
            "kernel_launches": ran,
            "launches": sum(ran.values()),
        })
        self.last_backend_report = report
        return out


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
        self._default_ensemble = None

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

    def _active_live_rates(self, space: CellularSpace,
                           impl: str) -> dict[str, float]:
        """Shared eligibility gate of the active-tile impls (``"active"``
        and ``"active_fused"``): all-Diffusion field flows (the tile-skip
        rule is only bitwise-exact for uniform-rate linear flows), at least
        one nonzero rate, every live channel in the space dtype. Returns the
        live attr → rate map; raises the JAX package's errors."""
        rates = self.pallas_rates()
        if rates is None:
            raise ValueError(
                f"impl='{impl}' requires all field flows to be plain "
                "Diffusion (the tile-skip rule is only bitwise-exact "
                "for uniform-rate linear flows); got "
                f"flows={[type(f).__name__ for f in self.flows]}. "
                "Use impl='xla'/'auto'.")
        live = {a: r for a, r in rates.items() if r != 0.0}
        if rates and not live:
            raise ValueError(
                f"impl='{impl}' has nothing to step: every Diffusion "
                "rate is 0.0 (no field transport). Use "
                "impl='xla'/'auto' for a no-op field step.")
        if not rates:
            raise ValueError(
                f"impl='{impl}' needs a Diffusion field flow; "
                "all-point models already take the point-subsystem "
                "fast path (the executors route them automatically).")
        for a in live:
            adt = space.values[a].dtype
            if adt != space.dtype:
                raise ValueError(
                    f"impl='{impl}' computes every flow channel in "
                    f"the space dtype "
                    f"({str(space.dtype).removeprefix('torch.')});"
                    f" channel {a!r} is "
                    f"{str(adt).removeprefix('torch.')}. Use impl='xla'.")
        return live

    def dense_fallback(self, space: CellularSpace,
                       rate: float) -> Optional[PallasDiffusionStep]:
        """The active impls' dense fallback stepper, chosen statically: K1
        (one step per call) when the space is on the card, f32/bf16 and not
        a partition; None (the plain, bitwise transport) otherwise. Nothing
        is probed: a K1 build or launch error propagates."""
        if (space.device.type != "cuda" or space.is_partition
                or not self.pallas_dtype_ok(space)):
            return None
        return PallasDiffusionStep(space.shape, rate, dtype=space.dtype,
                                   offsets=self.offsets, nsteps=1)

    @staticmethod
    def pallas_dtype_ok(space: CellularSpace) -> bool:
        """The kernel stores f32 or bf16 and computes in f32; f64 grids
        stay on the plain path."""
        return space.dtype in KERNEL_DTYPES

    def _field_stepper(self, space: CellularSpace, field_flows: list,
                       substeps: int,
                       shape: Optional[tuple[int, int]] = None,
                       compute_dtype=None) -> PallasFieldStep:
        """K4's stepper for this space (or for its shards of ``shape``),
        planned now from static facts: the flows lowered, the program
        within the kernel's limits, every channel it loads in the space
        dtype, ``substeps`` within the ghost depth and the block within
        shared memory. Raises ``FieldPlanError`` otherwise; nothing is built
        or launched here."""
        stepper = PallasFieldStep(shape or space.shape, field_flows,
                                  dtype=space.dtype,
                                  offsets=self.offsets, nsteps=substeps,
                                  compute_dtype=compute_dtype,
                                  names=tuple(space.values))
        off = [n for n in stepper.program.channels
               if space.values[n].dtype != space.dtype]
        if off:
            raise FieldPlanError(
                f"the field kernel loads every channel its flows read in the "
                f"space dtype ({str(space.dtype).removeprefix('torch.')}); "
                f"{off} are not. Use impl='xla'.")
        return stepper

    def make_step(self, space: CellularSpace, impl: str = "xla",
                  substeps: int = 1, compute_dtype=None,
                  composed_variant: str = "auto") -> Callable[..., Values]:
        """Build ``step(values, out=None) -> values`` for this space.

        ``impl``: ``"xla"`` (plain torch ops, every flow), ``"pallas"`` (a
        fused kernel on a full, non-partition f32/bf16 grid, with no point
        flows when ``substeps > 1``: K1 when every field flow is a plain
        ``Diffusion``, else K4 when every field flow is pointwise and
        lowers to a program (``ops.field_lower``); raises ``ValueError``
        otherwise), ``"composed"``
        (K3, same eligibility; k is the largest window-composable divisor
        of ``substeps`` and a call runs ``substeps/k`` composed passes),
        ``"active"`` (the plain active-tile engine; all-Diffusion field
        flows, composes with point flows and partitions), ``"active_fused"``
        (K6 + K7; k is the largest divisor of ``substeps`` the tile admits,
        no point flows when ``substeps > 1``) or ``"auto"`` (``"pallas"``
        when eligible and the kernel's static rules admit the call: the
        ghost depth, and for K4 the lowering, the program limits and the
        shared memory; else ``"xla"``; no probe and no fallback on
        failure). ``substeps > 1`` advances that many steps per call.
        ``composed_variant`` (``"composed"`` only: ``"auto"``, ``"vpu"``
        or ``"mxu"``, resolved by the JAX package's rule) picks K3's form.
        ``out`` optionally maps the channels a kernel writes to
        preallocated output tensors. The step carries ``.impl``,
        ``.substeps``, ``.steppers`` (channel → kernel stepper; K4's one
        stepper under each channel it writes), ``.field_stepper`` (K4's, or
        None), ``.composed_k``, ``.composed_passes``, ``.variant`` (asked)
        and ``.form`` (resolved)."""
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
        if impl not in IMPLS:
            raise ValueError(f"unknown step impl {impl!r}")
        cdt = resolve_compute_dtype(compute_dtype)
        substeps = int(substeps)
        if substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {substeps}")
        key = (space.shape, space.global_shape, (space.x_init, space.y_init),
               str(space.dtype), str(space.device), self.offsets, impl,
               substeps, composed_variant,
               str(cdt) if cdt is not None else None,
               tuple(f.fingerprint() for f in self.flows))
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

        steppers: dict = {}
        composed_steppers: dict[str, ComposedDiffusionStep] = {}
        composed_k = composed_passes = None
        variant = form = None
        if impl == "composed":
            rates = self.pallas_rates()
            if rates is not None and not any(r != 0.0
                                             for r in rates.values()):
                raise ValueError(
                    "impl='composed' has nothing to compose: every "
                    "Diffusion rate is 0.0 (no field transport). Use "
                    "impl='xla'/'auto' for a no-op field step.")
            eligible = (bool(rates) and not space.is_partition
                        and self.pallas_dtype_ok(space)
                        and (substeps == 1 or not pt_by_attr))
            if not eligible:
                raise ValueError(
                    "impl='composed' requires all field flows to be plain "
                    "Diffusion (a uniform rate is what composes into an "
                    "explicit tap table) on a full (non-partition) "
                    "f32/bf16 grid, with no point flows when "
                    "substeps > 1; got "
                    f"flows={[type(f).__name__ for f in self.flows]}, "
                    f"is_partition={space.is_partition}, "
                    f"dtype={space.dtype}, substeps={substeps}. Use "
                    "impl='xla'/'auto', or ShardMapExecutor("
                    "step_impl='composed', halo_depth=k) for sharded "
                    "runs.")
            composed_k = choose_k(substeps, shape, space.dtype)
            composed_passes = substeps // composed_k
            if composed_k == 1 and substeps > 1:
                warnings.warn(
                    f"impl='composed' auto-k degenerated to k=1 for "
                    f"substeps={substeps} (no divisor <= the window's "
                    f"composable depth {max_k(shape, space.dtype)}): each "
                    "call runs iterated radius-1 passes, equaling the "
                    "iterated path. Pick substeps with a small divisor "
                    "to actually compose.", RuntimeWarning)
            composed_steppers = {
                a: ComposedDiffusionStep(shape, r, composed_k,
                                         dtype=space.dtype, offsets=offsets,
                                         variant=composed_variant,
                                         compute_dtype=cdt)
                for a, r in rates.items() if r != 0.0}
            steppers = composed_steppers
            first = next(iter(composed_steppers.values()))
            variant, form = first.variant, first.form
        active_steppers: dict[str, ActiveDiffusionStep] = {}
        if impl == "active":
            live = self._active_live_rates(space, "active")
            active_steppers = {
                a: ActiveDiffusionStep(
                    shape, r, dtype=space.dtype, offsets=offsets,
                    origin=origin, global_shape=gshape,
                    dense_fn=self.dense_fallback(space, r))
                for a, r in live.items()}
        fused_steppers: dict[str, FusedActiveStep] = {}
        if impl == "active_fused":
            live = self._active_live_rates(space, "active_fused")
            if substeps > 1 and pt_by_attr:
                raise ValueError(
                    "impl='active_fused' with substeps > 1 composes the "
                    "sub-steps inside the kernel pass; a point flow must "
                    "fire between sub-steps. Use substeps=1 or drop the "
                    "point flows.")
            composed_k = choose_fused_k(substeps, plan_for(shape))
            composed_passes = substeps // composed_k
            if composed_k == 1 and substeps > 1:
                warnings.warn(
                    f"impl='active_fused' auto-k degenerated to k=1 for "
                    f"substeps={substeps} (no divisor fits the tile "
                    "geometry): each pass advances one step, equaling "
                    "the k=1 fused path. Pick substeps with a small "
                    "divisor to actually compose.", RuntimeWarning)
            fused_steppers = {
                a: FusedActiveStep(
                    shape, r, dtype=space.dtype, offsets=offsets,
                    origin=origin, global_shape=gshape, k=composed_k,
                    passes=composed_passes,
                    dense_fn=self.dense_fallback(space, r))
                for a, r in live.items()}
            steppers = fused_steppers
        field_stepper: Optional[PallasFieldStep] = None
        if impl in ("pallas", "auto"):
            rates = self.pallas_rates()
            live = {a: r for a, r in (rates or {}).items() if r != 0.0}
            base_ok = (not space.is_partition
                       and self.pallas_dtype_ok(space)
                       and (substeps == 1 or not pt_by_attr))
            eligible = (bool(live) and base_ok
                        and all(space.values[a].dtype == space.dtype
                                for a in live))
            # K4 is for models that need it: some pointwise field flow that
            # is not a plain Diffusion (rates is None)
            field_eligible = (rates is None and bool(field_flows)
                              and all(f.footprint == "pointwise"
                                      for f in field_flows)
                              and base_ok)
            if impl == "pallas" and not (eligible or field_eligible):
                raise ValueError(
                    "impl='pallas' requires all field flows to be "
                    "POINTWISE (Diffusion/Coupled/...) on a full "
                    "(non-partition) f32/bf16 grid — the kernel computes "
                    "in f32, so f64 stays on the XLA path — (and no "
                    "point flows when substeps > 1); got "
                    f"flows={[type(f).__name__ for f in self.flows]}, "
                    f"is_partition={space.is_partition}, "
                    f"dtype={space.dtype}, "
                    f"substeps={substeps}. Use impl='xla' "
                    "or 'auto'; for sharded DIFFUSION models use "
                    "ShardMapExecutor(mesh, step_impl='pallas') — the "
                    "per-shard halo kernel — or halo_depth>1; other "
                    "sharded flows run the XLA shard step.")
            if (impl == "auto" and eligible
                    and substeps > ghost_depth(shape, space.dtype)):
                eligible = False  # a static shape rule, not a probe
            if eligible:
                # refuse a too-deep substeps now, not at the first call
                check_nsteps(substeps, resolve_block(shape, space.dtype),
                             space.dtype)
                steppers = {
                    a: PallasDiffusionStep(shape, r, dtype=space.dtype,
                                           offsets=offsets, nsteps=substeps,
                                           compute_dtype=cdt)
                    for a, r in live.items()}
            elif field_eligible:
                # static rules only (lowering, program limits, channel
                # dtypes, ghost depth, shared memory): "auto" takes the
                # plain path where one fails, "pallas" raises it
                try:
                    field_stepper = self._field_stepper(space, field_flows,
                                                        substeps,
                                                        compute_dtype=cdt)
                except FieldPlanError:
                    if impl == "pallas":
                        raise
                else:
                    steppers = {a: field_stepper
                                for a in field_stepper.program.outputs}

        counts_cache: list = []
        # the step closes over the space's dtype, never the space: a cached
        # step must not keep the state it was built for alive
        dtype = space.dtype
        # the point sources' cells and frozen amounts are static: made on
        # the device once, here (a tensor made from host values each step
        # is a host-to-device copy the card waits for)
        pt_static = {}
        for attr, pflows in pt_by_attr.items():
            locs = [f.local_source(space.values, origin) for f in pflows]
            pt_static[attr] = (
                torch.tensor([lx for lx, _, _ in locs], device=device),
                torch.tensor([ly for _, ly, _ in locs], device=device),
                [f.amount(space.values, origin)
                 if f.frozen_source_value is not None else None
                 for f in pflows])

        def counts() -> torch.Tensor:
            if not counts_cache:
                counts_cache.append(neighbor_counts(
                    shape, offsets, origin, gshape, dtype, device))
            return counts_cache[0]

        # the dense transport of plain-Diffusion field flows, on every impl
        # that takes the plain path, is the Flow IR's one registered
        # lowering: they become IR Transport terms and the step runs
        # ir.lower.dense_apply (the JAX package's models/model.py:867-930).
        # Flows the IR cannot represent exactly (user flows, several
        # Diffusions on one channel) keep the summed-outflow path.
        dense_ir = None
        ir_cache: dict = {}
        if field_flows:
            from ..ir.lower import StepMeta, diffusion_terms

            dense_ir = diffusion_terms(field_flows)
            dense_ir_meta = StepMeta(shape=shape, origin=origin,
                                     global_shape=gshape, dtype=space.dtype,
                                     offsets=offsets)

        def single(values: Values, out: Optional[Values] = None) -> Values:
            new = dict(values)
            if field_stepper is not None:
                # every flow channel, substeps steps, one K4 launch
                new.update(field_stepper(values, out=out))
            elif composed_steppers:
                # substeps/k composed passes per call
                for attr, stepper in composed_steppers.items():
                    cur = values[attr]
                    for _ in range(composed_passes):
                        cur = stepper(cur)
                    new[attr] = cur
            elif active_steppers or fused_steppers:
                for attr, stepper in (active_steppers
                                      or fused_steppers).items():
                    new[attr] = stepper(values[attr])
            elif steppers:
                for attr, stepper in steppers.items():
                    new[attr] = stepper(values[attr],
                                        out=(out or {}).get(attr))
            elif dense_ir is not None:
                from ..ir.lower import dense_apply

                new.update(dense_apply(dense_ir, values,
                                       [t.rate for t in dense_ir],
                                       dense_ir_meta, counts(), ir_cache))
            elif field_flows:
                for attr, o in build_outflow(field_flows, values,
                                             origin).items():
                    # analysis: ignore[hardcoded-physics] — legacy FLOW
                    # fallback for what the IR cannot represent exactly (user
                    # flows, summed same-attr outflows); the convertible dense
                    # path above runs the IR lowering
                    new[attr] = transport(values[attr], o, counts(), offsets)
            # point amounts read the PRE-step values
            for attr, pflows in pt_by_attr.items():
                xs, ys, fixed = pt_static[attr]
                amts = torch.stack([f.amount(values, origin) if a is None
                                    else a for f, a in zip(pflows, fixed)])
                # analysis: ignore[hardcoded-physics] — the point-source
                # scatter (the reference's live workload) is outside the IR
                # field-term grammar by design
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

        step.field_stepper = field_stepper
        step.impl = ("active_fused" if fused_steppers
                     else "active" if active_steppers
                     else "composed" if composed_steppers
                     else "pallas" if steppers else "xla")
        step.substeps = substeps
        step.steppers = steppers
        step.composed_k = composed_k
        step.composed_passes = composed_passes
        step.variant = variant
        step.form = form
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

    def conservation_error(self, initial: dict, final: dict) -> float:
        """Largest |Δ| between two sets of channel totals over what the
        model's conservation contract holds constant: the per-channel
        totals here (``ir.FlowIRModel`` judges its budget-reconciled
        view)."""
        return max(abs(float(final[k]) - float(initial[k]))
                   for k in initial)

    def report_conservation_error(self, report: Report) -> float:
        """``conservation_error`` of a run's report (what the CLI
        judges)."""
        return self.conservation_error(report.initial_total,
                                       report.final_total)

    def execute(
        self,
        space: CellularSpace,
        executor: Optional[Executor] = None,
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
        from ..utils.tracing import trace_span

        # the spans add no host wait: the run's one synchronize and the
        # totals' reads are the waits the untraced run has
        with trace_span("model.execute", steps=num_steps,
                        executor=type(executor).__name__):
            initial = {k: float(space.total(k)) for k in space.values}
            t0 = _time.perf_counter()
            with trace_span("executor.run"):
                out_values = executor.run_model(self, space, num_steps)
                for dev in {t.device for t in out_values.values()}:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            wall = _time.perf_counter() - t0
            with trace_span("model.report"):
                out_space = space.with_values(out_values)
                final = {k: float(out_space.total(k))
                         for k in out_space.values}
                last_exec = [float(f.execute(out_space))
                             for f in self.flows]
        from ..parallel.multihost import process_index

        report = Report(
            comm_size=getattr(executor, "comm_size", 1),
            # this process's rank: the reference's comm_rank (Main.cpp:23)
            rank_id=process_index(),
            steps=num_steps,
            initial_total=initial,
            final_total=final,
            last_execute=last_exec,
            wall_time_s=wall,
            backend_report=getattr(executor, "last_backend_report", None),
            impl=getattr(executor, "last_impl", None),
        )
        if check_conservation and not space.is_partition:
            self._raise_if_violated(space, initial, final, tolerance, rtol)
        return out_space, report

    def _raise_if_violated(self, space: CellularSpace, initial: dict,
                           final: dict, tolerance: float,
                           rtol: Optional[float]) -> None:
        """The conservation check, as a method a subclass overrides: the
        per-channel |Δtotal| contract here; ``ir.FlowIRModel`` replaces it
        with per-term budget reconciliation (violations name the term)."""
        thresh = self.conservation_threshold(space, tolerance, rtol,
                                             initial_totals=initial)
        err = max(abs(final[k] - initial[k]) for k in initial)
        if err > thresh:
            raise ConservationError(
                f"mass conservation violated: |Δ| = "
                f"{err:.3e} > {thresh:.3e} "
                f"(initial={initial}, final={final})")

    def execute_many(
        self,
        spaces,
        *,
        models=None,
        executor=None,
        steps: Optional[int] = None,
        check_conservation: bool = True,
        tolerance: float = 1e-3,
        rtol: Optional[float] = None,
    ) -> list:
        """Run B independent scenarios together (the ensemble engine,
        ``ensemble.batch``); returns ``(space, Report)`` per scenario,
        matching B independent ``SerialExecutor`` runs of them.

        ``models`` (default: this model for every lane) may vary numeric
        flow parameters per scenario (rates, frozen snapshots) but must
        share this model's structure and the spaces' geometry, channel
        dtypes and device; anything else raises ``ValueError``.
        ``executor`` is an ``ensemble.EnsembleExecutor`` (default: one
        ``impl="xla"`` executor kept by this model, so its runner cache
        serves repeated calls). Conservation is checked per scenario; a
        violation raises ``ensemble.EnsembleConservationError`` naming the
        lane."""
        from ..ensemble.batch import EnsembleExecutor, run_ensemble

        if executor is None:
            if self._default_ensemble is None:
                self._default_ensemble = EnsembleExecutor()
            executor = self._default_ensemble
        return run_ensemble(
            self, spaces, models=models, executor=executor, steps=steps,
            check_conservation=check_conservation, tolerance=tolerance,
            rtol=rtol)
