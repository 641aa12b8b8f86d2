"""The sharded executor: the distributed runtime of the port (counterpart of
``mpi_model_tpu/parallel/executors.py::ShardMapExecutor``).

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
- ``"composed"``: K3-halo (``composed_halo_step``), one composed
  ``(2d+1)²`` pass per depth-d exchange (all-``Diffusion`` models).
- ``"auto"``: ``"pallas"`` where it is statically eligible (the flows, the
  dtype, the depth within the shard and the slab capacity, K4's plan),
  else ``"xla"``. Nothing is probed: a build or launch error propagates.

A run of ``n`` steps is ``n // d`` chunks of depth d and one remainder chunk
of depth ``n % d`` with a ring only that deep. The kernels are out of
place: each shard writes its own ping-pong buffer, so no exchange reads a
value written in the same chunk.

``run_model`` takes the global space and returns global tensors, assembled
once per call on the mesh's first device (one grid copy per run).

Not ported yet (ROADMAP.md): the sharded active engines, Flow IR models,
bf16 interior math, the point-subsystem runner (an all-frozen-point model
runs the pad-gather step and reports ``"xla"`` where the JAX package says
``"point"``; both give the same values), the chaos seam.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..core.cellular_space import CellularSpace
from ..models.model import _launches_since, _not_ported, kernel_launches
from ..ops.composed_stencil import composed_halo_step
from ..ops.field_stencil import FieldPlanError, PallasFieldStep
from ..ops.flow import PointFlow
from ..ops.fused_stencil import check_ring_depth, pallas_halo_step
from ..ops.stencil import neighbor_counts
from .halo import (exchange_ring, gather_from_padded, pad_with_halo_1d,
                   pad_with_halo_2d, zero_ring)
from .mesh import Mesh, ShardGrid, assemble, shard_bounds, shard_space

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
                 compute_dtype=None):
        if len(mesh.axis_names) not in (1, 2):
            raise ValueError("ShardMapExecutor needs a 1-D or 2-D mesh")
        if step_impl not in STEP_IMPLS:
            raise ValueError(f"unknown step impl {step_impl!r}")
        if halo_mode not in ("exchange", "zero"):
            raise ValueError(f"unknown halo mode {halo_mode!r}")
        if int(halo_depth) < 1:
            raise ValueError(f"halo_depth must be >= 1, got {halo_depth}")
        if step_impl in ("active", "active_fused"):
            raise _not_ported(
                f"the sharded step_impl={step_impl!r} (shard-local active "
                "sets: ghost_flags and dense_from_ghost_padded)")
        if compute_dtype not in (None, torch.float32, "float32"):
            raise _not_ported("compute_dtype other than float32 (bf16 "
                              "interior math)")
        self.mesh = mesh
        self.step_impl = step_impl
        self.halo_mode = halo_mode
        self.halo_depth = int(halo_depth)
        self.compute_dtype = compute_dtype
        #: the step path the last ``run_model`` used ("pallas", "composed"
        #: or "xla")
        self.last_impl: Optional[str] = None
        #: per-run detail (Report.backend_report) of the kernel paths
        self.last_backend_report: Optional[dict] = None
        #: seconds the last run spent assembling its global tensors (host
        #: clock, after a synchronize of the mesh's devices)
        self.last_assembly_s: Optional[float] = None
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
        shard_bounds(space, self.mesh)  # the divisibility rule, first
        self.last_backend_report = None
        if getattr(model, "ir_terms", None) is not None:
            raise _not_ported("sharded Flow IR models")
        # the step count is not part of the key: a runner serves any count
        key = (space.shape, space.global_shape,
               (space.x_init, space.y_init), str(space.dtype),
               tuple((k, str(v.dtype)) for k, v in space.values.items()),
               model.offsets, tuple(f.fingerprint() for f in model.flows))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._build(model, space)
            self._cache[key] = entry
        plan_kind, runner = entry
        shards = shard_space(space, self.mesh)
        before = kernel_launches()
        out = runner(shards, int(num_steps))
        ran = _launches_since(before)
        self.last_impl = ("xla" if plan_kind is None else
                          "composed" if plan_kind == "composed" else "pallas")
        self._record_backend_report(plan_kind, int(num_steps), ran)
        first = self.mesh.device(0, 0)
        self._synchronize()
        t0 = time.perf_counter()
        values = {k: assemble(g, first) for k, g in out.items()}
        self._synchronize()
        self.last_assembly_s = time.perf_counter() - t0
        return values

    def _synchronize(self) -> None:
        for d in self.mesh.distinct_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _build(self, model, space: CellularSpace):
        """(the plan's kind or None, runner) for this model and geometry,
        from static facts."""
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
                               num_steps: int, ran: dict) -> None:
        """The kernel paths' record: the kernel, the depth, the chunks and
        the launches of this run; ``"composed"`` also carries the JAX
        package's composed keys. The xla step records nothing."""
        if plan_kind is None:
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
        self.last_backend_report = rep

    # -- rings ---------------------------------------------------------------

    def _ring(self, grid: ShardGrid, i: int, j: int, depth: int) -> dict:
        """Shard (i, j)'s depth-``depth`` ring: exchanged, or under
        ``halo_mode="zero"`` one cached all-zero ring per shape (the
        kernels never write a ring)."""
        if self.halo_mode == "exchange":
            return exchange_ring(grid, i, j, depth)
        t = grid[i][j]
        key = (tuple(t.shape), t.dtype, t.device, depth)
        ring = self._zero_rings.get(key)
        if ring is None:
            ring = zero_ring(t, depth)
            self._zero_rings[key] = ring
        return ring

    def _pad(self, grid: ShardGrid, i: int, j: int, depth: int = 1,
             one_d: bool = False) -> torch.Tensor:
        """Shard (i, j) padded with its depth-``depth`` halo."""
        if self.halo_mode == "zero":
            return F.pad(grid[i][j], (depth,) * 4)
        if one_d:
            return pad_with_halo_1d(grid, i, depth)
        return pad_with_halo_2d(grid, i, j, depth)

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
                st = model._field_stepper(space, field_flows, ns, shape)
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
        check_ring_depth(depth, (lh, lw), space.dtype, None)
        gshape = (space.dim_x, space.dim_y)
        origins = self._origins(space, lh, lw)
        offsets = model.offsets
        cells = [(i, j) for i in range(lines) for j in range(columns)]
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
                for i, j in cells:
                    rings = {k: self._ring(g, i, j, ns)
                             for k, g in cur.items()}
                    st.halo({k: g[i][j] for k, g in cur.items()}, rings,
                            origins[i][j], gshape,
                            out={a: spare[a][i][j] for a in written})
            else:
                for attr, rate in live.items():
                    g = cur[attr]
                    for i, j in cells:
                        ring = self._ring(g, i, j, ns)
                        if kind == "composed":
                            composed_halo_step(
                                g[i][j], ring, origins[i][j], gshape, rate,
                                ns, offsets, out=spare[attr][i][j])
                        else:
                            pallas_halo_step(
                                g[i][j], ring, origins[i][j], gshape, rate,
                                offsets, nsteps=ns, out=spare[attr][i][j])
            for a in written:
                cur[a], spare[a] = spare[a], cur[a]

        def run(shards: Shards, n: int) -> Shards:
            cur = dict(shards)
            spare = {a: [[torch.empty_like(t) for t in row]
                         for row in cur[a]] for a in written}
            q, r = divmod(n, depth)
            for ns in [depth] * q + ([r] if r else []):
                chunk(cur, spare, ns)
            return cur

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
        cells = [(i, j) for i in range(lines) for j in range(columns)]
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
                grid = []
                for i in range(lines):
                    row = []
                    for j in range(columns):
                        _, mf, cntD = geo[i, j]
                        m = mf[off:PH - off, off:PW - off]
                        cnt = cntD[off:PH - off, off:PW - off]
                        cur = self._pad(c[attr], i, j, d, one_d) * m
                        r_t = rate_of(attr, rate, cur)
                        for s in range(d):
                            hs, ws = cur.shape
                            cur = transport_step(cur, r_t * cur,
                                                 cnt[s:s + hs, s:s + ws],
                                                 m, s, hs, ws)
                        row.append(cur)
                    grid.append(row)
                new[attr] = grid
            return new

        def chunk_general(c: Shards, d: int) -> Shards:
            off = D - d
            new = {k: [[None] * columns for _ in range(lines)] for k in c}
            for i, j in cells:
                mb_full, mf, cntD = geo[i, j]
                m = mf[off:PH - off, off:PW - off]
                mb = mb_full[off:PH - off, off:PW - off]
                cnt = cntD[off:PH - off, off:PW - off]
                row0, col0 = origins[i][j]
                cur = {k: self._pad(g, i, j, d, one_d) * m
                       for k, g in c.items()}
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
        cells = [(i, j) for i in range(lines) for j in range(columns)]
        counts = {(i, j): neighbor_counts((lh, lw), offsets, origins[i][j],
                                          gshape, dtype,
                                          self.mesh.device(i, j))
                  for i, j in cells}

        def step(c: Shards) -> Shards:
            padded = ({k: {(i, j): self._pad(g, i, j, 1, one_d)
                           for i, j in cells} for k, g in c.items()}
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
                shares = [[per[i, j] / counts[i, j] for j in range(columns)]
                          for i in range(lines)]
                new[attr] = [[c[attr][i][j] - per[i, j]
                              + gather_from_padded(
                                  self._pad(shares, i, j, 1, one_d), offsets)
                              for j in range(columns)] for i in range(lines)]
            return new

        def run(shards: Shards, n: int) -> Shards:
            out = shards
            for _ in range(n):
                out = step(out)
            return out

        return run

