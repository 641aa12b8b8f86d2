"""The sharded executors: the distributed runtime of the port (counterparts
of ``mpi_model_tpu/parallel/executors.py``'s ``ShardMapExecutor`` and
``AutoShardedExecutor``; the second, at the end of this module, keeps the
GSPMD path's contract over the first's xla runner).

The reference's ``Model::execute`` splits the grid across MPI ranks and
sends the Moore shares that cross a rank edge as a ghost update
(``/root/reference/src/Model.hpp:53-262``). The JAX package runs per-shard
code under ``shard_map`` with ``ppermute`` ghost exchanges: one controller
drives every device. This port keeps that shape: one process, a ``Mesh``
of ``torch.device``s (``parallel.mesh``), each shard a tensor on its
device, the ghost ring copied between shard tensors (``parallel.halo``).
A mesh may name one device several times, so a decomposition runs on one
card with real rings at every shard edge.

Per shard, ``step_impl`` picks the step:

- ``"xla"``: plain torch ops, every flow. ``halo_depth == 1`` is the
  pad-gather step (shares exchanged one ring deep each step; point flows as
  one scatter on the owning shard; ``ring1`` footprints get halo-padded
  channels; undeclared footprints are refused). ``halo_depth = d > 1``
  exchanges a depth-d ring once per d steps and steps the padded shard,
  shrinking one ring a step (pointwise flows only).
- ``"pallas"``: the hand-written halo kernels, one depth-``d`` exchange and
  one launch per shard per chunk of d steps: K2 (``pallas_halo_step``) for
  all-``Diffusion`` models, K4-halo (``pallas_field_halo_step``) for other
  pointwise flows (every channel exchanges its ring: outflows read
  modulators on ghost cells).
- ``"composed"``: K3-halo (``composed_halo_step``), one composed pass of
  ``S^d`` per depth-d exchange (all-``Diffusion`` models), in the form
  ``composed_variant`` resolves to (``"auto"``: the JAX package's rule).
- ``"auto"``: ``"pallas"`` where it is statically eligible (the flows, the
  dtype, the depth within the shard and the slab capacity, K4's plan),
  else ``"xla"``. Nothing is probed: a build or launch error propagates.

A run of ``n`` steps is ``n // d`` chunks of depth d and one remainder chunk
of depth ``n % d`` with a ring only that deep. The kernels are out of
place: each shard writes its own ping-pong buffer, so no exchange reads a
value written in the same chunk.

- ``"active"`` / ``"active_fused"``: shard-local active sets
  (``_build_active_runner``), all-``Diffusion`` models at
  ``halo_depth == 1``. Each shard lives in a ring-1 padded buffer for the
  run; each step its ring is refreshed from the neighbours' pre-step
  values (a one-cell value exchange), its tile map is the dilation of its
  carried map OR the ghost ring's activations
  (``ops.active.ghost_flags``), and it takes the compacted active pass
  (``"active"``: ``ops.active.active_pass``, plain torch; ``"active_fused"``:
  K6 + K7 at the shard's global origin) or, above the threshold, the dense
  step on the same ring (``ops.active.dense_from_ghost_padded``). Every
  shard's count is read in one host transfer a step.

All-frozen-point models at ``halo_depth == 1`` under ``xla``, ``auto``,
``active`` or ``active_fused`` take the point subsystem
(``ops.point_kernel.shard_point_runner``): no exchange, ``last_impl`` is
``"point"``.

``run_model`` takes the global space and returns global tensors, assembled
once per call on the mesh's first device (one grid copy per run).

Across processes (a ``torch.distributed`` world, ``parallel.multihost``;
the mesh's positions laid over the ranks, ``parallel.mesh``) every process
runs ``run_model`` on the same global space and steps only its own
positions. Every runner above crosses processes: each exchange is one
collective (``halo.exchange_rings`` / ``pad_rings`` / ``refresh_rings``,
whose remote pieces ride one ``batch_isend_irecv``), so the rings are the
only traffic a step; the sharded active runners gather every shard's count
over the world before any shard chooses its pass; and ``run_model``
returns the global tensors on every process, with one all-gather a channel
a run (``last_assembly_s`` covers it). So ``Model.execute``, its ``Report``
and the conservation check run unchanged on every process, and each
process's grid is the one-process run's bit for bit. ``last_exchange_s`` is
the host seconds the last run spent in exchanges that crossed processes
(after a synchronize of this process's devices, so a chunk's compute is
not counted in them).

Nonlinear Flow IR models (``ir.FlowIRModel``; linear ones take the paths
above through their ``Diffusion`` flows view) run ``_build_ir_runner`` under
``"xla"`` or ``"auto"`` at ``halo_depth == max(1, max_footprint)``: one
ring-1 value exchange a step of the channels some ring-1 term reads
(``pad_with_halo_1d/2d``), then the registered lowering in its padded
context (``ir.lower.padded_apply``) with the partition mask and the global
counts, so every shard computes its serial run's values bit for bit.

Chaos seam (``resilience.inject``): ``run_model`` fires the executor
faults: ``exc`` raises, ``nan`` poisons the chunk's output, ``halo``
perturbs every ghost ring the chunk exchanges (``parallel.halo``; the IR
runner's exchange too).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..core.cellular_space import CellularSpace
from ..models.model import SerialExecutor, _launches_since, \
    kernel_launches
from ..ops.composed_stencil import composed_halo_step, resolve_form
from ..ops.field_stencil import FieldPlanError, PallasFieldStep
from ..ops import active as act
from ..ops.flow import PointFlow
from ..ops.fused_active import fused_compute, fused_scatter
from ..ops.fused_stencil import check_ring_depth, pallas_halo_step, \
    resolve_compute_dtype
from ..ops.point_kernel import build_point_plans, shard_point_runner
from ..ops.stencil import neighbor_counts
from ..resilience import inject
from ..utils.tracing import get_tracer
from . import multihost
from .halo import (exchange_rings, gather_from_padded, pad_rings,
                   refresh_rings, zero_ring)
from .mesh import (Mesh, ShardGrid, assemble, grid_spec, shard_bounds,
                   shard_space)

Values = dict[str, torch.Tensor]
Shards = dict[str, ShardGrid]

STEP_IMPLS = ("xla", "pallas", "auto", "composed", "active", "active_fused")


def _dtype_name(dtype) -> str:
    """A dtype as the JAX package's messages spell it ("float32")."""
    return str(dtype).removeprefix("torch.")


class ShardMapExecutor:
    """Explicit sharded execution over a 1-D or 2-D ``Mesh``: per-shard
    steps with hand-placed ghost exchanges (see the module docstring for
    ``step_impl``). ``halo_mode="zero"`` is a DIAGNOSTIC for measuring the
    exchange's cost: every ring is zeros (the same compute, no traffic,
    WRONG results at shard edges). ``halo_depth`` is the ring depth: one
    exchange per ``halo_depth`` steps."""

    def __init__(self, mesh: Mesh, step_impl: str = "xla",
                 halo_mode: str = "exchange", halo_depth: int = 1,
                 compute_dtype=None, composed_variant: str = "auto"):
        if len(mesh.axis_names) not in (1, 2):
            raise ValueError("ShardMapExecutor needs a 1-D or 2-D mesh")
        if step_impl not in STEP_IMPLS:
            raise ValueError(f"unknown step impl {step_impl!r}")
        if halo_mode not in ("exchange", "zero"):
            raise ValueError(f"unknown halo mode {halo_mode!r}")
        if int(halo_depth) < 1:
            raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")
        if step_impl in ("active", "active_fused") and int(halo_depth) != 1:
            raise ValueError(
                f"step_impl={step_impl!r} exchanges a one-cell ghost ring "
                f"per step; halo_depth={halo_depth} is not supported (the "
                "active set would need depth-d frontier dilation)")
        resolve_compute_dtype(compute_dtype)
        self.mesh = mesh
        self.step_impl = step_impl
        self.halo_mode = halo_mode
        self.halo_depth = int(halo_depth)
        self.compute_dtype = compute_dtype
        #: K3-halo's variant under "composed" (composed_halo_step)
        self.composed_variant = composed_variant
        #: the step path the last ``run_model`` used ("pallas",
        #: "composed", "active", "active_fused", "point" or "xla")
        self.last_impl: Optional[str] = None
        #: per-run detail (Report.backend_report) of the kernel paths
        self.last_backend_report: Optional[dict] = None
        #: seconds the last run spent assembling its global tensors (host
        #: clock, after a synchronize of the mesh's devices)
        self.last_assembly_s: Optional[float] = None
        #: host seconds the last run spent in exchanges across processes
        #: (0.0 in one process)
        self.last_exchange_s: float = 0.0
        self._cache: dict = {}
        self._zero_rings: dict = {}

    @property
    def comm_size(self) -> int:
        return self.mesh.size

    # -- planning ------------------------------------------------------------

    def _pallas_plan(self, model, space: CellularSpace):
        """Which halo kernel applies: ``("diffusion", rates)`` (K2) when
        every flow is a plain ``Diffusion``, ``("composed", rates)`` (K3-halo)
        under ``step_impl="composed"``, ``("field", flows)`` (K4-halo) when
        every field flow is pointwise, or None (the xla step). Raises the
        JAX package's errors for an explicit ``"pallas"``/``"composed"``
        that cannot be honored."""
        if self.step_impl == "xla":
            return None
        has_point = any(isinstance(f, PointFlow) for f in model.flows)
        base_ok = (not has_point and not space.is_partition
                   and model.pallas_dtype_ok(space))
        if self.step_impl == "composed":
            rates = model.pallas_rates() if base_ok else None
            if rates and any(r != 0.0 for r in rates.values()):
                return ("composed", rates)
            if rates is not None and not any(r != 0.0
                                             for r in rates.values()):
                raise ValueError(
                    "step_impl='composed' has nothing to compose: every "
                    "Diffusion rate is 0.0 (no field transport). Use "
                    "'xla' or 'auto' for a no-op field step.")
            raise ValueError(
                "step_impl='composed' requires all field flows to be "
                "plain Diffusion (a uniform rate is what composes into "
                "an explicit tap table) on a full (non-partition) "
                "f32/bf16 grid with no point flows; got "
                f"flows={[type(f).__name__ for f in model.flows]}, "
                f"is_partition={space.is_partition}, "
                f"dtype={_dtype_name(space.dtype)}. Use 'xla', 'pallas' or "
                "'auto'.")
        if base_ok:
            rates = model.pallas_rates()
            if rates is not None:
                if rates and any(r != 0.0 for r in rates.values()):
                    return ("diffusion", rates)
            else:
                field_flows = tuple(f for f in model.flows
                                    if not isinstance(f, PointFlow))
                if field_flows and all(
                        getattr(f, "footprint", "unknown") == "pointwise"
                        for f in field_flows):
                    return ("field", field_flows)
        if self.step_impl == "pallas":
            raise ValueError(
                "step_impl='pallas' requires all field flows to be "
                "POINTWISE (Diffusion/Coupled/...) on a full "
                "(non-partition) f32/bf16 grid with no point flows (the "
                "kernels compute in f32; f64 runs the XLA shard step); "
                "got "
                f"flows={[type(f).__name__ for f in model.flows]}, "
                f"is_partition={space.is_partition}, "
                f"dtype={_dtype_name(space.dtype)}. Use 'xla' or 'auto'.")
        return None

    def _geometry(self, space: CellularSpace):
        """(lines, columns, shard rows, shard columns, one_d)."""
        lh, lw = shard_bounds(space, self.mesh)
        lines, columns = self.mesh.grid_shape
        return lines, columns, lh, lw, len(self.mesh.axis_names) == 1

    def _origins(self, space: CellularSpace, lh: int, lw: int):
        lines, columns = self.mesh.grid_shape
        return [[(space.x_init + i * lh, space.y_init + j * lw)
                 for j in range(columns)] for i in range(lines)]

    # -- execution -----------------------------------------------------------

    def run_model(self, model, space: CellularSpace, num_steps: int) -> Values:
        """``num_steps`` steps of ``model`` on the global ``space``, sharded
        over the mesh; returns the global tensors on the mesh's first
        device."""
        # chaos seam (resilience.inject): one module-global read when no
        # plan is armed; "halo" perturbs every ring this chunk exchanges
        st = inject.active()
        if st is None:
            return self._run_inner(model, space, num_steps)
        idx = st.bump("executor")
        fault = st.take("executor", idx, kinds=("exc", "nan", "halo"))
        if fault is None:
            return self._run_inner(model, space, num_steps)
        if fault.kind == "exc":
            raise inject.InjectedFault(
                f"injected executor fault on call {idx} (sharded "
                f"{num_steps}-step chunk)")
        if fault.kind == "halo":
            with st.halo_window(fault):
                return self._run_inner(model, space, num_steps)
        out = self._run_inner(model, space, num_steps)
        return inject.poison_values(out, fault, st.plan)

    def _run_inner(self, model, space: CellularSpace,
                   num_steps: int) -> Values:
        shard_bounds(space, self.mesh)  # the divisibility rule, first
        self.last_backend_report = None
        ir = (getattr(model, "ir_terms", None) is not None
              and not model.ir_linear)
        if ir:
            self._check_ir(model, space)
        # the step count is not part of the key: a runner serves any count;
        # a nonlinear IR model has no flows, and its runner holds its term
        # rates, so the terms' fingerprints are part of the key
        key = (space.shape, space.global_shape,
               (space.x_init, space.y_init), str(space.dtype),
               tuple((k, str(v.dtype)) for k, v in space.values.items()),
               model.offsets, tuple(f.fingerprint() for f in model.flows),
               model._term_fingerprints() if ir else None)
        tracer = get_tracer()
        entry = self._cache.get(key)
        fresh = entry is None
        if fresh:
            with tracer.span("shardmap.build") as sm:
                entry = (("ir", self._build_ir_runner(model, space)) if ir
                         else self._build(model, space))
                sm.update(impl=self._build_label(entry[0]),
                          depth=self.halo_depth)
            self._cache[key] = entry
        plan_kind, runner = entry
        shards = shard_space(space, self.mesh)
        self.last_exchange_s = 0.0
        before = kernel_launches()
        if fresh and plan_kind in ("diffusion", "field", "composed"):
            # a kernel's library is built or loaded at its first launch
            with tracer.span("shardmap.compile+first_run",
                             impl=self._build_label(plan_kind)):
                out = runner(shards, int(num_steps))
        else:
            out = runner(shards, int(num_steps))
        ran = _launches_since(before)
        self.last_impl = ("xla" if plan_kind in (None, "ir") else
                          "pallas" if plan_kind in ("diffusion", "field")
                          else plan_kind)
        if plan_kind in ("active", "active_fused"):
            self.last_backend_report = runner.report(int(num_steps))
        else:
            self._record_backend_report(plan_kind, int(num_steps), ran,
                                        getattr(runner, "form", None))
        first = self.mesh.home_device()
        self._synchronize()
        t0 = time.perf_counter()
        values = {k: assemble(g, first) for k, g in out.items()}
        self._synchronize()
        self.last_assembly_s = time.perf_counter() - t0
        return values

    def _build_label(self, plan_kind: Optional[str]) -> str:
        """The ``impl`` a ``shardmap.build`` span names, as the JAX
        package's sharded executor names its builds."""
        deep = self.halo_depth > 1
        if plan_kind == "ir":
            return "ir"
        if plan_kind == "point":
            return "point-subsystem"
        if plan_kind in ("active", "active_fused"):
            return plan_kind
        if plan_kind == "composed":
            return f"composed-depth{self.halo_depth}"
        if plan_kind is not None:
            return "pallas-deep" if deep else "pallas"
        return "deep-halo" if deep else "xla"

    def _synchronize(self) -> None:
        for d in self.mesh.distinct_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _build(self, model, space: CellularSpace):
        """(the plan's kind or None, runner) for this model and geometry,
        from static facts."""
        if (self.halo_depth == 1
                and self.step_impl in ("xla", "auto", "active",
                                       "active_fused")
                and model.flows
                and all(isinstance(f, PointFlow) for f in model.flows)):
            plans = build_point_plans(model.flows, space, model.offsets)
            if plans is not None and all(p.frozen_only
                                         for p in plans.values()):
                return "point", self._build_point_runner(space, plans)
        if self.step_impl in ("active", "active_fused"):
            return self.step_impl, self._build_active_runner(
                model, space, fused=self.step_impl == "active_fused")
        plan = self._pallas_plan(model, space)
        if plan is not None and self.step_impl == "auto":
            plan = self._auto_admits(model, space, plan)
        if plan is not None:
            return plan[0], self._build_pallas_runner(model, space, plan)
        if self.halo_depth > 1:
            return None, self._build_deep_runner(model, space)
        return None, self._build_runner(model, space)

    def _auto_admits(self, model, space, plan):
        """``plan`` if the kernel's static rules admit it (the depth within
        the shard and the slab capacity, every live channel in the space
        dtype, K4's plan), else None: ``"auto"`` then runs the xla step."""
        _, _, lh, lw, one_d = self._geometry(space)
        d = self.halo_depth
        if d > (lh if one_d else min(lh, lw)):
            return None
        try:
            check_ring_depth(d, (lh, lw), space.dtype, None)
            if plan[0] == "field":
                self._field_steppers(model, space, (lh, lw))
        except (ValueError, FieldPlanError):
            return None
        if plan[0] != "field" and any(
                space.values[a].dtype != space.dtype
                for a, r in plan[1].items() if r != 0.0):
            return None
        return plan

    def _record_backend_report(self, plan_kind: Optional[str],
                               num_steps: int, ran: dict,
                               form: Optional[str] = None) -> None:
        """The kernel paths' record: the kernel, the depth, the chunks and
        the launches of this run; ``"composed"`` also carries the JAX
        package's composed keys. The xla, point and IR steps record
        nothing."""
        if plan_kind in (None, "point", "ir"):
            return
        d = self.halo_depth
        name, counter = {
            "diffusion": ("K2 fused_stencil_halo", "fused_stencil_halo"),
            "composed": ("K3-halo composed_stencil", "composed_stencil_halo"),
            "field": ("K4-halo field_stencil", "field_stencil_halo"),
        }[plan_kind]
        rep = {"impl": self.last_impl, "kernel": name, "halo_depth": d,
               "shards": self.comm_size, "full_chunks": num_steps // d,
               "remainder_chunk_depth": num_steps % d,
               "launches": ran[counter]}
        if plan_kind == "composed":
            rep["composed_k"] = d
            rep["variant"] = self.composed_variant
            rep["form"] = form
        self.last_backend_report = rep

    # -- rings ---------------------------------------------------------------

    def _exchanged(self, fn, *args):
        """``fn(*args)``, an exchange; across processes its host seconds
        (after a synchronize, so queued compute is not counted) add to
        ``last_exchange_s``."""
        if not self.mesh.multiprocess:
            return fn(*args)
        self._synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        self.last_exchange_s += time.perf_counter() - t0
        return out

    def _rings(self, grid: ShardGrid, depth: int) -> dict:
        """Every held shard's depth-``depth`` ring, ``{(i, j): ring}``:
        exchanged, or under ``halo_mode="zero"`` one cached all-zero ring
        per shape (the kernels never write a ring)."""
        if self.halo_mode == "exchange":
            return self._exchanged(exchange_rings, grid, depth)
        rings = {}
        for i, j in self.mesh.local_cells():
            t = grid[i][j]
            key = (tuple(t.shape), t.dtype, t.device, depth)
            ring = self._zero_rings.get(key)
            if ring is None:
                ring = zero_ring(t, depth)
                self._zero_rings[key] = ring
            rings[i, j] = ring
        return rings

    def _pads(self, grid: ShardGrid, depth: int = 1,
              one_d: bool = False) -> dict:
        """Every held shard padded with its depth-``depth`` halo,
        ``{(i, j): padded}``."""
        if self.halo_mode == "zero":
            return {(i, j): F.pad(grid[i][j], (depth,) * 4)
                    for i, j in self.mesh.local_cells()}
        return self._exchanged(pad_rings, grid, depth, one_d)

    def _refresh(self, grid: ShardGrid) -> None:
        """``refresh_rings`` of ring-1 padded buffers (an exchange)."""
        self._exchanged(refresh_rings, grid)

    # -- the kernel runner ---------------------------------------------------

    def _field_steppers(self, model, space: CellularSpace,
                        shape: tuple[int, int]) -> Callable[[int],
                                                            PallasFieldStep]:
        """K4-halo's stepper per chunk depth, planned now for the full depth
        (raises ``FieldPlanError``) and at first use for a remainder."""
        field_flows = [f for f in model.flows if not isinstance(f, PointFlow)]
        steppers: dict[int, PallasFieldStep] = {}

        def stepper(ns: int) -> PallasFieldStep:
            st = steppers.get(ns)
            if st is None:
                st = model._field_stepper(space, field_flows, ns, shape,
                                          self.compute_dtype)
                steppers[ns] = st
            return st

        stepper(self.halo_depth)
        return stepper

    def _build_pallas_runner(self, model, space: CellularSpace, plan: tuple):
        """Per-shard halo kernels fed by the exchanged ghost rings, one
        depth-``ns`` exchange and one launch per shard per chunk (and, for
        ``"diffusion"``/``"composed"``, per channel with a nonzero rate)."""
        kind, payload = plan
        lines, columns, lh, lw, one_d = self._geometry(space)
        depth = self.halo_depth
        if depth > (lh if one_d else min(lh, lw)):
            raise ValueError(
                f"halo_depth={depth} exceeds the shard extent ({lh}x{lw})")
        blk = check_ring_depth(depth, (lh, lw), space.dtype, None)
        # the form the full-depth chunks run (raises as the JAX package
        # does for "mxu" at a width that is not 128-aligned)
        form = (resolve_form(self.composed_variant, depth, blk[1])
                if kind == "composed" else None)
        gshape = (space.dim_x, space.dim_y)
        origins = self._origins(space, lh, lw)
        offsets = model.offsets
        cells = self.mesh.local_cells()
        if kind == "field":
            stepper = self._field_steppers(model, space, (lh, lw))
            written = tuple(stepper(depth).program.outputs)
        else:
            live = {a: r for a, r in payload.items() if r != 0.0}
            written = tuple(live)

        def chunk(cur: Shards, spare: Shards, ns: int) -> None:
            """ns steps: every written channel's new shards go to its spare
            buffers, then the two swap."""
            if kind == "field":
                st = stepper(ns)
                rings = {k: self._rings(g, ns) for k, g in cur.items()}
                for i, j in cells:
                    st.halo({k: g[i][j] for k, g in cur.items()},
                            {k: r[i, j] for k, r in rings.items()},
                            origins[i][j], gshape,
                            out={a: spare[a][i][j] for a in written})
            else:
                for attr, rate in live.items():
                    g = cur[attr]
                    rings = self._rings(g, ns)
                    for i, j in cells:
                        ring = rings[i, j]
                        if kind == "composed":
                            composed_halo_step(
                                g[i][j], ring, origins[i][j], gshape, rate,
                                ns, offsets, variant=self.composed_variant,
                                compute_dtype=self.compute_dtype,
                                out=spare[attr][i][j])
                        else:
                            pallas_halo_step(
                                g[i][j], ring, origins[i][j], gshape, rate,
                                offsets, nsteps=ns,
                                compute_dtype=self.compute_dtype,
                                out=spare[attr][i][j])
            for a in written:
                cur[a], spare[a] = spare[a], cur[a]

        def run(shards: Shards, n: int) -> Shards:
            cur = dict(shards)
            spare = {a: [[None if t is None else torch.empty_like(t)
                          for t in row] for row in cur[a]] for a in written}
            q, r = divmod(n, depth)
            for ns in [depth] * q + ([r] if r else []):
                chunk(cur, spare, ns)
            return cur

        run.form = form
        return run

    # -- the point subsystem and the active runners --------------------------

    def _build_point_runner(self, space: CellularSpace, plans: dict):
        """The frozen point subsystem on every shard: each shard steps the
        whole entry table and writes back the cells it owns; no exchange."""
        lines, columns, lh, lw, _ = self._geometry(space)
        run = shard_point_runner(plans, space.dtype, lh, lw)

        cells = self.mesh.local_cells()

        def runner(shards: Shards, n: int) -> Shards:
            out = {k: [[None] * columns for _ in range(lines)]
                   for k in shards}
            for i, j in cells:
                vals = run({k: g[i][j] for k, g in shards.items()},
                           i * lh, j * lw, n)
                for k, t in vals.items():
                    out[k][i][j] = t
            return out

        return runner

    def _build_active_runner(self, model, space: CellularSpace,
                             fused: bool = False):
        """Shard-local active-tile stepping (counterpart of the JAX
        package's ``_build_active_runner``). Each shard's channel lives in a
        ring-1 padded buffer for the whole run (padded once), and the
        passes update its interior in place. Per step: every shard's ring
        is refreshed from its neighbours' interiors before any shard's pass
        writes (``halo.refresh_rings``); a shard's flags are the ring-1
        dilation of its carried tile map OR its ring's activations
        (``ghost_flags``); every (channel, shard) count comes to the host in
        one transfer; then each shard takes the compacted pass (windows
        read the padded shard, counts from global coordinates: a shard seam
        is not a grid edge) or, above ``plan.fallback_tiles``, the dense
        step on the same ring, written back into the interior. Exchanging
        values, not shares, keeps the run bitwise the share-exchanging xla
        shard step.

        The runner carries each shard's tile map (one scan per run, again
        only after a dense step) and allocates the pass buffers once per
        shard per run; ``runner.report(n)`` gives the run's
        ``backend_report``, its counters summed over shards."""
        impl_name = "active_fused" if fused else "active"
        rates = model.pallas_rates()
        live = {a: r for a, r in (rates or {}).items() if r != 0.0}
        has_point = any(isinstance(f, PointFlow) for f in model.flows)
        if rates is None or not live or has_point:
            raise ValueError(
                f"step_impl={impl_name!r} requires all field flows to be "
                "plain Diffusion with a nonzero rate and no point flows "
                "(the tile-skip rule is only bitwise-exact for "
                "uniform-rate linear flows); got "
                f"flows={[type(f).__name__ for f in model.flows]}. "
                "Use step_impl='xla' or 'auto'.")
        for a in live:
            adt = space.values[a].dtype
            if not adt.is_floating_point:
                raise TypeError(
                    f"flow transport requires a floating dtype, got "
                    f"{_dtype_name(adt)} for channel {a!r}")
            if adt != space.dtype:
                raise ValueError(
                    f"step_impl={impl_name!r} computes every flow channel "
                    f"in the space dtype ({_dtype_name(space.dtype)}); "
                    f"channel {a!r} is {_dtype_name(adt)}. Use "
                    "step_impl='xla'.")
        lines, columns, lh, lw, _ = self._geometry(space)
        plan = act.plan_for((lh, lw))
        th, tw = plan.tile
        K = plan.capacity
        offsets = model.offsets
        gshape = space.global_shape
        dtype = space.dtype
        origins = self._origins(space, lh, lw)
        cells = self.mesh.local_cells()
        nshards = self.mesh.size
        counts_pad = {}
        for i, j in cells:
            row0, col0 = origins[i][j]
            counts_pad[i, j] = torch.clamp(neighbor_counts(
                (lh + 2, lw + 2), offsets, (row0 - 1, col0 - 1), gshape,
                dtype, self.mesh.device(i, j)), min=1)
        host = self.mesh.home_device()
        # each process's (channel, shard)s, in the order its counts come
        by_rank = ([[(a, c) for a in live for c in self.mesh.cells_of(r)]
                    for r in range(multihost.process_count())]
                   if self.mesh.multiprocess else None)
        stats = {"fb": 0, "at": 0, "ff": 0, "syncs": 0}
        #: host seconds of the run's sections (the device work they enqueue
        #: runs behind them; the count read waits for it)
        host_s = dict.fromkeys(("refresh", "flags", "count_read", "passes"),
                               0.0)

        def run(shards: Shards, n: int) -> Shards:
            for key in stats:
                stats[key] = 0
            for key in host_s:
                host_s[key] = 0.0
            padded = {(a, c): F.pad(shards[a][c[0]][c[1]], (1, 1, 1, 1))
                      for a in live for c in cells}
            tmaps = {(a, c): act.tile_nonzero_map(shards[a][c[0]][c[1]],
                                                  plan)
                     for a in live for c in cells}
            bufs = {}
            for c in cells:
                dev = self.mesh.device(*c)
                if fused:
                    # K6 reads selfnz only with taps, which k=1 never takes
                    bufs[c] = (torch.empty((K, th, tw), dtype=dtype,
                                           device=dev),
                               torch.empty(K, dtype=torch.int32, device=dev),
                               torch.zeros(K, dtype=torch.int32, device=dev))
                else:
                    bufs[c] = torch.empty((K, th, tw), dtype=dtype,
                                          device=dev)
            order = [(a, c) for a in live for c in cells]
            for _ in range(n):
                t0 = time.perf_counter()
                if self.halo_mode == "exchange":
                    for a in live:
                        self._refresh(
                            [[padded.get((a, (i, j))) for j in range(columns)]
                             for i in range(lines)])
                t1 = time.perf_counter()
                flags = {ac: act.ghost_flags(padded[ac], plan, tmaps[ac])
                         for ac in order}
                t2 = time.perf_counter()
                # analysis: ignore[host-sync] — the sharded active runner's
                # one declared host read a step: every (channel, shard) count
                # in one copy; the step_audit contract counts it
                # the one host read a step: every (channel, shard) count
                counts = torch.cat([
                    flags[ac].sum(dtype=torch.int32).reshape(1).to(host)
                    for ac in order]).tolist()
                # across processes every shard's count reaches every
                # process (one all-gather of the host list) before any
                # shard chooses its pass, so the world's record is one
                # process's, whatever each shard chooses; every process
                # posts the next step's exchange either way
                world = (dict(zip(order, counts)) if by_rank is None else
                         {ac: cnt for acs, cnts in zip(
                             by_rank, multihost.all_gather_ints(counts))
                          for ac, cnt in zip(acs, cnts)})
                t3 = time.perf_counter()
                stats["syncs"] += 1
                for cnt in world.values():
                    stats["at"] += cnt
                    if cnt > plan.fallback_tiles:
                        stats["fb"] += 1
                    elif fused:
                        stats["ff"] += 1
                for (a, c), cnt in zip(order, counts):
                    rate, p, f = live[a], padded[a, c], flags[a, c]
                    if cnt > plan.fallback_tiles:
                        new = act.dense_from_ghost_padded(
                            p, rate, counts_pad[c], offsets, dtype)
                        p[1:-1, 1:-1] = new
                        tmaps[a, c] = act.tile_nonzero_map(new, plan)
                        continue
                    ids, cnt_t = act.compact_tile_ids(f, plan)
                    origin = origins[c[0]][c[1]]
                    if fused:
                        upd, anyf, selfnz = bufs[c]
                        cnt1 = cnt_t.reshape(1)
                        u, af = fused_compute(
                            p, ids, cnt1, selfnz, rate=rate, plan=plan,
                            origin=origin, global_shape=gshape,
                            offsets=offsets, dtype=dtype, k=1, ring=1,
                            upd=upd, anyf=anyf)
                        fused_scatter(p, u, ids, cnt1, plan=plan, ring=1)
                        anyf_b = af != 0
                    else:
                        _, _, anyf_b = act.active_pass(
                            p, bufs[c], ids, cnt, rate, plan, origin,
                            gshape, offsets, dtype)
                    tmaps[a, c] = act.next_tile_map(anyf_b, ids, cnt_t,
                                                    plan)
                host_s["refresh"] += t1 - t0
                host_s["flags"] += t2 - t1
                host_s["count_read"] += t3 - t2
                host_s["passes"] += time.perf_counter() - t3
            out = dict(shards)
            for a in live:
                out[a] = [[padded[a, (i, j)][1:-1, 1:-1]
                           if (a, (i, j)) in padded else None
                           for j in range(columns)] for i in range(lines)]
            return out

        def report(num_steps: int) -> dict:
            ntiles = plan.ntiles * nshards
            nattr = len(live)
            rep = {"impl": impl_name, "steps": num_steps, "shards": nshards,
                   "fallback_steps": stats["fb"], "tile": list(plan.tile),
                   "tiles": ntiles, "tiles_per_shard": plan.ntiles,
                   "capacity": plan.capacity,
                   "fallback_tiles": plan.fallback_tiles,
                   "mean_active_fraction": (
                       float(stats["at"]) / (num_steps * nattr * ntiles)
                       if num_steps and nattr else None)}
            if fused:
                rep["flags_fused"] = stats["ff"]
            #: host reads of the device counts (one a step)
            rep["host_syncs"] = stats["syncs"]
            rep["host_s"] = dict(host_s)
            return rep

        run.report = report
        return run

    # -- the xla runners -----------------------------------------------------

    def _build_deep_runner(self, model, space: CellularSpace):
        """Deep-halo xla step: one depth-D exchange per D steps for
        pointwise field flows. Every padded shard steps on a region that
        shrinks one ring a step, each flow's outflow taken on the pre-step
        padded values and masked to the partition, counts from global
        coordinates; all-``Diffusion`` models take the uniform-rate
        expression (per channel, flow-less channels never exchanged)."""
        depth = self.halo_depth
        field_flows = [f for f in model.flows
                       if not isinstance(f, PointFlow)]
        has_point = any(isinstance(f, PointFlow) for f in model.flows)
        all_pointwise = bool(field_flows) and all(
            getattr(f, "footprint", "unknown") == "pointwise"
            for f in field_flows)
        if not all_pointwise or has_point:
            raise ValueError(
                "halo_depth > 1 requires POINTWISE field flows and no "
                "point flows (a point flow must fire between steps, "
                "which deep-halo chunks cannot interleave); got "
                f"flows={[type(f).__name__ for f in model.flows]}. "
                "Use halo_depth=1 for general flows.")
        uniform_rates = model.pallas_rates()
        if uniform_rates is None:
            nonfloat = sorted(k for k, v in space.values.items()
                              if not v.dtype.is_floating_point)
            if nonfloat:
                raise ValueError(
                    f"halo_depth > 1 with general pointwise flows pads/"
                    f"masks every channel in the flow dtype; non-float "
                    f"channels {nonfloat} are not supported on this path "
                    "— use halo_depth=1 (or an all-Diffusion model)")
        lines, columns, lh, lw, one_d = self._geometry(space)
        exchanged_min = lh if one_d else min(lh, lw)
        if depth > exchanged_min:
            raise ValueError(
                f"halo_depth={depth} exceeds the shard extent "
                f"({lh}x{lw}) — the exchanged slab cannot be "
                "deeper than the shard")
        offsets = model.offsets
        gshape = space.global_shape
        dtype = space.dtype
        D = depth
        PH, PW = lh + 2 * D, lw + 2 * D
        origins = self._origins(space, lh, lw)
        cells = self.mesh.local_cells()
        # per shard: the partition-bounds mask (a standalone partition
        # drops shares at its edges every step) and the global-true counts
        # over the depth-padded region
        geo = {}
        for i, j in cells:
            dev = self.mesh.device(i, j)
            row0, col0 = origins[i][j]
            rows = (row0 - D) + torch.arange(PH, device=dev)[:, None]
            cols = (col0 - D) + torch.arange(PW, device=dev)[None, :]
            mask_b = ((rows >= space.x_init)
                      & (rows < space.x_init + space.dim_x)
                      & (cols >= space.y_init)
                      & (cols < space.y_init + space.dim_y))
            cnt = torch.clamp(neighbor_counts(
                (PH, PW), offsets, (row0 - D, col0 - D), gshape, dtype, dev),
                min=1.0)
            geo[i, j] = (mask_b, mask_b.to(dtype), cnt)
        rates_t = {}

        def transport_step(cur, of, cnt_s, m, s, hs, ws):
            share = of / cnt_s
            inflow = None
            for dx, dy in offsets:
                t = share[1 + dx:hs - 1 + dx, 1 + dy:ws - 1 + dy]
                inflow = t if inflow is None else inflow + t
            return ((cur[1:hs - 1, 1:ws - 1]
                     - of[1:hs - 1, 1:ws - 1] + inflow)
                    * m[s + 1:s + hs - 1, s + 1:s + ws - 1])

        def rate_of(attr, rate, like):
            key = (attr, like.device)
            t = rates_t.get(key)
            if t is None:
                t = torch.tensor(rate, dtype=like.dtype, device=like.device)
                rates_t[key] = t
            return t

        def chunk_uniform(c: Shards, d: int) -> Shards:
            off = D - d
            new = dict(c)
            for attr, rate in uniform_rates.items():
                if rate == 0.0:
                    continue
                grid = [[None] * columns for _ in range(lines)]
                pads = self._pads(c[attr], d, one_d)
                for i, j in cells:
                    _, mf, cntD = geo[i, j]
                    m = mf[off:PH - off, off:PW - off]
                    cnt = cntD[off:PH - off, off:PW - off]
                    cur = pads[i, j] * m
                    r_t = rate_of(attr, rate, cur)
                    for s in range(d):
                        hs, ws = cur.shape
                        cur = transport_step(cur, r_t * cur,
                                             cnt[s:s + hs, s:s + ws],
                                             m, s, hs, ws)
                    grid[i][j] = cur
                new[attr] = grid
            return new

        def chunk_general(c: Shards, d: int) -> Shards:
            off = D - d
            new = {k: [[None] * columns for _ in range(lines)] for k in c}
            pads = {k: self._pads(g, d, one_d) for k, g in c.items()}
            for i, j in cells:
                mb_full, mf, cntD = geo[i, j]
                m = mf[off:PH - off, off:PW - off]
                mb = mb_full[off:PH - off, off:PW - off]
                cnt = cntD[off:PH - off, off:PW - off]
                row0, col0 = origins[i][j]
                cur = {k: p[i, j] * m for k, p in pads.items()}
                for s in range(d):
                    hs, ws = next(iter(cur.values())).shape
                    cnt_s = cnt[s:s + hs, s:s + ws]
                    mb_s = mb[s:s + hs, s:s + ws]
                    org_s = (row0 - (d - s), col0 - (d - s))
                    outflows = {}
                    for f in field_flows:
                        o = torch.where(mb_s, f.outflow(cur, org_s), 0.0)
                        outflows[f.attr] = (outflows[f.attr] + o
                                            if f.attr in outflows else o)
                    nxt = {}
                    for k2, cw in cur.items():
                        of = outflows.get(k2)
                        if of is None:
                            nxt[k2] = cw[1:hs - 1, 1:ws - 1]
                            continue
                        nxt[k2] = transport_step(cw, of, cnt_s, m, s, hs, ws)
                    cur = nxt
                for k, t in cur.items():
                    new[k][i][j] = t
            return new

        chunk = chunk_uniform if uniform_rates is not None else chunk_general

        def run(shards: Shards, n: int) -> Shards:
            q, r = divmod(n, D)
            out = shards
            for ns in [D] * q + ([r] if r else []):
                out = chunk(out, ns)
            return out

        return run

    def _check_ir(self, model, space: CellularSpace) -> None:
        """The JAX package's refusals for a nonlinear IR model: the
        general lowering runs under ``"xla"``/``"auto"`` only, at the halo
        depth its largest term footprint needs."""
        from ..ir.lower import max_footprint

        if self.step_impl not in ("xla", "auto"):
            raise ValueError(
                f"step_impl={self.step_impl!r} is a linear-stencil "
                "engine; this model's nonlinear IR terms "
                f"({[t.name for t in model.ir_terms]}) run the "
                "general lowering — use step_impl='xla'/'auto'.")
        need = max(1, max_footprint(model.ir_terms))
        if self.halo_depth != need:
            raise ValueError(
                f"this model's terms read a footprint-"
                f"{max_footprint(model.ir_terms)} stencil: the "
                f"required halo depth is {need}, got halo_depth="
                f"{self.halo_depth} (nonlinear terms do not compose "
                "into deep-halo chunks — the tap table is a linear "
                "object)")
        model._validate_space(space)

    def _build_ir_runner(self, model, space: CellularSpace):
        """Per-shard runner of a nonlinear IR model: one ring-1 value
        exchange a step for the channels some ring-1 term reads (budget and
        pointwise channels never move), then the registered lowering in
        its padded context (``ir.lower.padded_apply``). A ghost cell's
        outflow and share are recomputed here from the same operands by the
        same expression its owning shard uses, and ghost cells beyond the
        partition are masked to zero, so the result is the serial step's
        bit for bit."""
        from ..ir.lower import StepMeta, padded_apply

        lines, columns, lh, lw, one_d = self._geometry(space)
        terms = model.ir_terms
        rates = model.term_rates()
        offsets = tuple(model.offsets)
        gshape = space.global_shape
        dtype = space.dtype
        x0, y0 = space.x_init, space.y_init
        origins = self._origins(space, lh, lw)
        cells = self.mesh.local_cells()
        ring_chs = sorted(set().union(
            *(t.reads() for t in terms if t.footprint >= 1)))
        metas, masks, counts, caches = {}, {}, {}, {}
        for i, j in cells:
            dev = self.mesh.device(i, j)
            r0, c0 = origins[i][j]
            metas[i, j] = StepMeta(shape=(lh, lw), origin=(r0, c0),
                                   global_shape=gshape, dtype=dtype,
                                   offsets=offsets)
            # the partition's bounds over the padded shard (ghost cells
            # beyond it shed nothing: the serial zero padding), and the
            # padded shard's global neighbour counts, clamped
            rowg = (r0 - 1) + torch.arange(lh + 2, device=dev)
            colg = (c0 - 1) + torch.arange(lw + 2, device=dev)
            masks[i, j] = (((rowg >= x0) & (rowg < x0 + space.dim_x))[:, None]
                           & ((colg >= y0) & (colg < y0 + space.dim_y))[None])
            counts[i, j] = torch.clamp(neighbor_counts(
                (lh + 2, lw + 2), offsets, (r0 - 1, c0 - 1), gshape, dtype,
                dev), min=1)
            caches[i, j] = {}

        def step(c: Shards) -> Shards:
            # every ring from the pre-step values, before any shard steps
            padded = {k: self._pads(c[k], 1, one_d) for k in ring_chs}
            new = {k: [[None] * columns for _ in range(lines)] for k in c}
            for i, j in cells:
                out = padded_apply(
                    terms, {k: g[i][j] for k, g in c.items()},
                    {k: p[i, j] for k, p in padded.items()}, rates,
                    metas[i, j], counts[i, j], masks[i, j], caches[i, j])
                for k in c:
                    new[k][i][j] = out[k]
            return new

        def run(shards: Shards, n: int) -> Shards:
            for _ in range(n):
                shards = step(shards)
            return shards

        return run

    def _build_runner(self, model, space: CellularSpace):
        """The pad-gather xla step, one exchange of shares a step: field
        flows by their declared footprint (``"ring1"`` outflows get
        halo-padded channels), point flows as one scatter on the shard that
        owns the source (the share crossing a shard edge rides the ordinary
        share exchange)."""
        lines, columns, lh, lw, one_d = self._geometry(space)
        offsets = model.offsets
        field_flows = [f for f in model.flows if not isinstance(f, PointFlow)]
        undeclared = sorted({type(f).__name__ for f in field_flows
                             if f.footprint not in ("pointwise", "ring1")})
        if undeclared:
            raise ValueError(
                f"ShardMapExecutor cannot prove flows {undeclared} are "
                "shardable: declare footprint='pointwise' (outflow reads "
                "only the cell's own channels) or footprint='ring1' + "
                "outflow_padded (reads the 3x3 neighborhood; inputs are "
                "halo-exchanged). Undeclared flows run correctly under "
                "SerialExecutor.")
        any_ring1 = any(f.footprint == "ring1" for f in field_flows)
        point_flows = [f for f in model.flows if isinstance(f, PointFlow)]
        gshape = space.global_shape
        dtype = space.dtype
        origins = self._origins(space, lh, lw)
        cells = self.mesh.local_cells()
        counts = {(i, j): neighbor_counts((lh, lw), offsets, origins[i][j],
                                          gshape, dtype,
                                          self.mesh.device(i, j))
                  for i, j in cells}

        def step(c: Shards, sbuf: dict) -> Shards:
            padded = ({k: self._pads(g, 1, one_d) for k, g in c.items()}
                      if any_ring1 else None)
            outflows: dict[str, dict] = {}
            for i, j in cells:
                vals = {k: g[i][j] for k, g in c.items()}
                origin = origins[i][j]
                for f in field_flows:
                    if f.footprint == "ring1":
                        o = f.outflow_padded(
                            {k: p[i, j] for k, p in padded.items()}, origin)
                    else:
                        o = f.outflow(vals, origin)
                    per = outflows.setdefault(f.attr, {})
                    per[i, j] = per[i, j] + o if (i, j) in per else o
            for f in point_flows:
                per = outflows.setdefault(f.attr, {})
                for i, j in cells:
                    if (i, j) not in per:
                        per[i, j] = torch.zeros_like(c[f.attr][i][j])
                for i, j in cells:
                    vals = {f.attr: c[f.attr][i][j]}
                    lx, ly, inside = f.local_source(vals, origins[i][j])
                    if inside:
                        amt = f.amount(vals, origins[i][j])
                        per[i, j] = per[i, j].index_put(
                            (torch.tensor([lx], device=amt.device),
                             torch.tensor([ly], device=amt.device)),
                            amt.reshape(1), accumulate=True)
            new = dict(c)
            for attr, per in outflows.items():
                # every shard's shares into the interior of its padded
                # buffer, then the rings, then the gathers
                grid = sbuf.get(attr)
                if grid is None:
                    grid = [[None] * columns for _ in range(lines)]
                    for i, j in cells:
                        grid[i][j] = torch.zeros(
                            (lh + 2, lw + 2), device=per[i, j].device,
                            dtype=torch.promote_types(per[i, j].dtype,
                                                      counts[i, j].dtype))
                    sbuf[attr] = grid
                for i, j in cells:
                    torch.div(per[i, j], counts[i, j],
                              out=grid[i][j][1:-1, 1:-1])
                if self.halo_mode == "exchange":
                    self._refresh(grid)
                new[attr] = [[None] * columns for _ in range(lines)]
                for i, j in cells:
                    new[attr][i][j] = (
                        c[attr][i][j] - per[i, j]
                        # analysis: ignore[hardcoded-physics] — the legacy
                        # share-exchanging flow shard step (general flows +
                        # point scatters); nonlinear IR models run
                        # _build_ir_runner's registered lowering instead
                        + gather_from_padded(grid[i][j], offsets))
            return new

        def run(shards: Shards, n: int) -> Shards:
            # the shares' ring-1 padded buffers, one per (channel, shard)
            # for the run: their rings are refreshed in place each step
            sbuf: dict = {}
            out = shards
            for _ in range(n):
                out = step(out, sbuf)
            return out

        return run



def _check_spec(spec, mesh: Mesh) -> tuple:
    """``spec`` as a tuple of at most two entries, each a mesh axis name or
    None, no name twice; raises otherwise."""
    s = tuple(spec)
    named = [a for a in s if a is not None]
    if (len(s) > 2 or any(a not in mesh.axis_names for a in named)
            or len(set(named)) != len(named)):
        raise ValueError(
            f"spec {s} must give each grid dimension (at most 2) a distinct "
            f"mesh axis name of {mesh.axis_names}, or None")
    return s


def _positions_admit(model) -> bool:
    """Whether ``ShardMapExecutor(mesh, "xla")`` runs ``model`` at ring
    depth 1: every field flow declares a ``pointwise`` or ``ring1``
    footprint, or a nonlinear Flow IR model's terms read at most one
    ring."""
    if getattr(model, "ir_terms", None) is not None and not model.ir_linear:
        from ..ir.lower import max_footprint

        return max(1, max_footprint(model.ir_terms)) == 1
    return all(getattr(f, "footprint", "unknown") in ("pointwise", "ring1")
               for f in model.flows if not isinstance(f, PointFlow))


class AutoShardedExecutor:
    """The GSPMD path's contract on a ``Mesh`` (counterpart of the JAX
    package's ``AutoShardedExecutor``): the result is the global step's,
    any flow runs, and the values never depend on the mesh or the spec.
    JAX jits the global step with sharding annotations and XLA inserts the
    halos; the port has no partitioner, so it runs one of three routes,
    chosen as the JAX package chooses them:

    - ``"point"``: an all-point-flow model, ``num_steps > 0``, plans that
      build: the serial point subsystem on the global view
      (``ops.point_kernel.serial_point_runner``: only the involved cells
      step; dynamic amounts allowed); ``last_impl == "point"``.
    - ``"positions"``: where every flow (or IR term) has a footprint
      ``ShardMapExecutor(mesh, "xla")`` accepts, that executor's per-shard
      plain-op runner and ghost-ring exchange (the halo GSPMD would
      insert), through its inner run, so without its chaos seam: the JAX
      package's GSPMD path has none.
    - ``"whole"``: any other model (an undeclared footprint) runs
      ``SerialExecutor("xla")``'s step loop on the whole grid on the mesh's
      home device. In a ``torch.distributed`` world each process steps the
      identical global space it holds.

    Every route is bit for bit ``SerialExecutor("xla")``'s run and returns
    global tensors on ``mesh.home_device()``; ``last_impl`` is ``"point"``
    or ``"xla"``, ``last_route`` the route. ``spec`` (default
    ``grid_spec(mesh)``) is the layout annotation JAX's sharding takes: it
    is checked and kept, and changes no value."""

    def __init__(self, mesh: Mesh, spec=None):
        self.mesh = mesh
        self.spec = grid_spec(mesh) if spec is None else _check_spec(spec,
                                                                     mesh)
        #: "xla" (the global step) or "point" (the point-subsystem fast
        #: path of all-point-flow models), as the CLI reports it
        self.last_impl: Optional[str] = "xla"
        self.last_route: Optional[str] = None
        self._positions = ShardMapExecutor(mesh, "xla")
        self._global = SerialExecutor("xla")

    @property
    def comm_size(self) -> int:
        return self.mesh.size

    def run_model(self, model, space: CellularSpace, num_steps: int) -> Values:
        shard_bounds(space, self.mesh)  # the divisibility rule, first
        point = (num_steps > 0 and bool(model.flows)
                 and all(isinstance(f, PointFlow) for f in model.flows))
        if not point and _positions_admit(model):
            self.last_impl, self.last_route = "xla", "positions"
            return self._positions._run_inner(model, space, num_steps)
        home = self.mesh.home_device()
        if space.device != home:
            space = space.with_values({k: v.to(home)
                                       for k, v in space.values.items()})
        out = self._global._run_inner(model, space, num_steps)
        # an all-point model whose plans do not build runs the global step
        point = self._global.last_impl == "point"
        self.last_impl = "point" if point else "xla"
        self.last_route = "point" if point else "whole"
        return out
