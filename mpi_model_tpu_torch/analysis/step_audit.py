"""Step contract audit (layer 2): run every registered step once under a
dispatch recorder and machine-check what it does on the device.

The JAX package traces each step into a jaxpr and reads it. The port has
no trace: its steps are eager torch, and its kernels are reached through
ctypes, which no dispatcher sees. So each contract builds a small
canonical (model, space) pair through the port's public builders
(``Model.make_step``, the executors' runners, ``FlowIRModel.make_step``,
``ir.library.build_model``), runs the step once to warm it (kernels
built, lazy caches filled), then runs it again under a
``TorchDispatchMode`` that records every aten operation with its
outputs' shapes and dtypes. The kernel wrappers' plain versions run
through ``ops.seam``: the operations inside one stand for the kernel.
``device=None`` runs on the card (``resolve_device``: no card raises);
the CPU tests pass ``device="cpu"``.

``step-dtype``
    every output tensor's dtype equals the space dtype (runner contracts
    with integer stat lanes opt out).
``step-sync``
    the host reads of one call stay within the contract's declared
    count (a number a step or a pass, from the line of today's code
    that reads). On the CPU the count is what dispatch shows:
    ``aten._local_scalar_dense`` (``int(t)``, ``bool(t)``, ``.item()``)
    and the operations whose output shape depends on the data
    (``nonzero``, ``masked_select``, ``unique``). On the card
    ``torch.cuda.set_sync_debug_mode("warn")`` also counts what dispatch
    cannot see (``.tolist()``, device-to-host copies, synchronizations).
    Reads inside a kernel's plain version are the kernel's and do not
    count.
``step-consts``
    no tensor of one grid channel's bytes or more is held in the step's
    closure (``fn.__closure__``, through ``functools.partial``, bound
    methods and the objects they hold), unless the contract declares it
    with its reason; all closure tensors total at most
    ``CONST_TOTAL_BUDGET``.
``step-halo``
    the stencil radius times the composed depth fits the halo depth the
    impl declares, and ``k * passes == substeps``.
``step-term-registry``
    every Flow IR ``Term`` subclass has exactly one lowering, registered
    in ``ir.lower``.
``step-fused-flags``
    between the kernel calls of the fused active runner's passes, no
    reduction over a tensor of tile size or larger runs outside a
    kernel: the next pass's flags come out of K6.
``step-batch-sum``
    in the meshed ensemble, each channel's per-scenario totals are one
    f64 sum over the space axes a lane (``totals_view``, then
    ``batched_totals``: the JAX package's ``[B,H,W] -> [B]`` reduction,
    lane by lane in the serial total's order), and nothing else of a
    lane's grid size is reduced.
``step-launches``
    on the card: every kernel route's launches a call
    (``kernel_launches()``'s delta) and its kernels' names (a profiler
    trace) equal the contract's declared ones; the GSPMD routes
    (``AutoShardedExecutor``: per position, whole grid, point) declare
    none. On the CPU every wrapper runs its plain version and counts 0:
    the rule checks nothing there and the report says so.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
import types
import warnings
from pathlib import Path
from typing import Callable, Optional

from .registry import RULES, Finding, Rule, Severity

#: registry scope tag for the step contract rules (never run by the AST
#: engine)
SCOPE_STEP = "step"

#: total bytes of tensors a step's closure may hold at the audit
#: geometry — room for tap tables and index templates, far below a grid
CONST_TOTAL_BUDGET = 1 << 20

#: aten operations whose result is read on the host (a device→host wait)
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                      "_unique", "_unique2", "unique_dim",
                      "unique_consecutive", "argwhere"})

#: aten reductions the fused-flags and batch-sum contracts look for (an
#: operation counts when its output is smaller than its input)
REDUCE_OPS = frozenset({
    "sum", "nansum", "prod", "mean", "amax", "amin", "max", "min", "any",
    "all", "argmax", "argmin", "count_nonzero", "logsumexp", "norm",
    "linalg_vector_norm", "max_pool2d", "max_pool2d_with_indices",
    "avg_pool2d"})

#: every ``__global__`` kernel of ``csrc/`` (the CPU tests hold this to
#: the sources); a traced kernel's name is matched against these
KERNEL_NAMES = (
    "fused_stencil_kernel", "fused_stencil_near_kernel",
    "fused_stencil_bf16_kernel", "fused_stencil_halo_kernel",
    "fused_stencil_halo_near_kernel", "fused_stencil_halo_bf16_kernel",
    "composed_vpu_kernel", "composed_vpu_near_kernel",
    "composed_vpu16_kernel", "composed_vpu_halo_kernel",
    "composed_vpu_halo_near_kernel", "composed_vpu16_halo_kernel",
    "composed_mxu_kernel", "composed_mxu_halo_kernel",
    "composed_mxu16_kernel", "composed_mxu16_halo_kernel",
    "field_kernel", "field_kernel_near", "field_kernel16",
    "pipeline_stencil_kernel", "pipeline_near_kernel",
    "pipeline_bf16_kernel", "fused_compute_kernel", "fused_scatter_kernel")

#: the sync debug mode's warning for one synchronizing operation (its
#: one-off notice that the mode is a prototype does not count)
_SYNC_WARNING = re.compile(r"synchronizing CUDA operation")


def _register(name: str, doc: str, fix_hint: str = "") -> None:
    if name not in RULES:
        RULES[name] = Rule(name, Severity.ERROR, doc,
                           check=lambda ctx: (), scope=SCOPE_STEP,
                           fix_hint=fix_hint)


_register("step-dtype",
          "every step output dtype must equal the space dtype (no silent "
          "f32/f64 leaks past the oracle gates)",
          fix_hint="make the tensor in the operand's dtype (dtype=v.dtype) "
                   "at the leak site, usually a bare literal or a numpy "
                   "constant")
_register("step-sync",
          "a step may read the device on the host no more often than its "
          "contract declares (a read waits for the stream)",
          fix_hint="keep the decision on the device (torch.where, a "
                   "device count), or read once a run; a deliberate read "
                   "is declared on the contract with its source line")
_register("step-consts",
          "no tensor of a grid channel's size held in a step's closure "
          "unless declared; closure tensors total within budget",
          fix_hint="make the tensor per call from the arguments, or "
                   "declare it on the contract with the reason the port "
                   "keeps it")
_register("step-halo",
          "stencil radius must fit the halo depth the impl declares, and "
          "k·passes must equal substeps",
          fix_hint="widen halo_depth in the impl's sharding config or "
                   "shrink the stencil radius")
_register("step-term-registry",
          "every Flow IR term kind has exactly one registered lowering, "
          "and it lives in ir.lower — no impl-private term branches",
          fix_hint="move the term's lowering into ir.lower and register "
                   "it there; delete the impl-local branch")
_register("step-fused-flags",
          "between the fused active runner's kernel calls, no reduction "
          "at tile size or larger runs outside a kernel — activity flags "
          "come out of K6, never a separate per-pass reduction",
          fix_hint="emit the activity flag from the kernel (anyf) rather "
                   "than reducing the field again outside it")
_register("step-batch-sum",
          "the meshed ensemble's per-scenario totals reduce over the "
          "space axes only (one f64 sum a channel and lane, [H,W] -> [], "
          "through totals_view), and nothing else of that size is "
          "reduced",
          fix_hint="reduce each lane with dtype=torch.float64 over its "
                   "space axes only (batch.batched_totals)")
_register("step-launches",
          "on the card, each kernel route launches its declared kernels "
          "the declared number of times a call",
          fix_hint="route the call through the kernel wrapper (a launch "
                   "it counts), or correct the contract if the route "
                   "changed on purpose")


@dataclasses.dataclass
class BuiltStep:
    """What a contract build hands the checker."""

    impl: str
    fn: Callable                 # run as fn(*args)
    args: tuple                  # tensors (or pytrees of them) on the device
    space_dtype: object
    grid_nbytes: int             # one channel's bytes at audit geometry
    offsets: tuple
    halo_depth: int              # ring depth the sharded config declares
    composed_k: Optional[int] = None
    composed_passes: Optional[int] = None
    substeps: int = 1
    #: False for runner-shaped contracts whose outputs carry stat
    #: counters beside the space-dtype values
    dtype_check: bool = True
    #: host reads a ``sync_unit`` the code makes, the units one call runs,
    #: and the line of today's code that reads
    host_reads: int = 0
    sync_unit: str = "step"
    units: int = 1
    reads_at: str = ""
    #: closure walk: False where ``fn`` is an executor entry point whose
    #: caches hold per-shard buffers by design (the route contracts)
    consts_check: bool = True
    #: closure tensors the port keeps by design: a name on the tensor's
    #: path → the reason
    kept: dict = dataclasses.field(default_factory=dict)
    #: the tile's cell count: enforce step-fused-flags between the
    #: call's kernel calls
    fused_flags_tile_elems: Optional[int] = None
    #: meshed-ensemble totals: {"count": channels × lanes,
    #: "min_elems": H × W, "out_numel": 1}
    batch_sum: Optional[dict] = None
    #: the card's launches a call (``kernel_launches()`` keys) and the
    #: kernels its trace must show; None: not a kernel route
    launches: Optional[dict] = None
    kernels: tuple = ()
    #: the TPU kernel this route replaces (a report field)
    route: str = ""


#: contract name → builder(device) (registered below)
CONTRACTS: dict[str, Callable] = {}


def contract(name: str):
    def deco(fn):
        CONTRACTS[name] = fn
        return fn
    return deco


# -- the canonical pairs -------------------------------------------------------

def _space_model(dtype: str, grid: int, device, with_point: bool = True):
    """The JAX package's canonical pair: a ``grid``² space of ones, a 0.1
    Diffusion, and (``with_point``) a 0.05 point source at (3, 3)."""
    from ..core.cellular_space import CellularSpace
    from ..models.model import Model
    from ..ops.flow import Diffusion, Exponencial
    space = CellularSpace.create(grid, grid, 1.0, dtype=dtype,
                                 device=device)
    flows = [Diffusion(0.1)]
    if with_point:
        flows.append(Exponencial((3, 3), 0.05))
    return space, Model(flows, 10.0, 0.2)


def _seeded(shape, dtype, device, seed: int = 2024, blob=None):
    """Seeded values in [0, 1): everywhere, or (``blob`` = (r0, c0, side))
    in one square and zero elsewhere."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    if blob is not None:
        r0, c0, side = blob
        mask = np.zeros(shape, dtype=bool)
        mask[..., r0:r0 + side, c0:c0 + side] = True
        a = np.where(mask, a, 0.0)
    return torch.from_numpy(a).to(dtype=getattr(torch, dtype),
                                  device=device)


def _grid_nbytes(space) -> int:
    v0 = next(iter(space.values.values()))
    return v0.element_size() * v0.numel()


#: the neighbour-count grid the plain transport divides by: cached once a
#: step (the JAX package computes it inside the traced step instead)
_COUNTS = ("the plain transport's neighbour-count divisor, one grid in "
           "the space dtype, made once a step builder and reused by "
           "every call (the JAX package recomputes it inside the traced "
           "step; caching it saves the recomputation each step)")


@contract("dense")
def _build_dense(device) -> BuiltStep:
    space, model = _space_model("float64", 16, device)
    step = model.make_step(space, impl="xla")
    return BuiltStep("dense", step, (space.values,), space.dtype,
                     _grid_nbytes(space), model.offsets, 1,
                     kept={"counts_cache": _COUNTS})


@contract("composed")
def _build_composed(device) -> BuiltStep:
    # composed eligibility: all-Diffusion, a full f32 grid; 64² admits k=4
    space, model = _space_model("float32", 64, device, with_point=False)
    step = model.make_step(space, impl="composed", substeps=4)
    return BuiltStep("composed", step, (space.values,), space.dtype,
                     _grid_nbytes(space), model.offsets,
                     halo_depth=step.composed_k,
                     composed_k=step.composed_k,
                     composed_passes=step.composed_passes, substeps=4,
                     kept={"counts_cache": _COUNTS})


@contract("active")
def _build_active(device) -> BuiltStep:
    space, model = _space_model("float64", 64, device, with_point=False)
    step = model.make_step(space, impl="active")
    return BuiltStep("active", step, (space.values,), space.dtype,
                     _grid_nbytes(space), model.offsets, 1,
                     host_reads=1, sync_unit="pass", units=1,
                     reads_at="mpi_model_tpu_torch/ops/active.py:362",
                     kept={"counts_cache": _COUNTS, "counts": _COUNTS})


@contract("ensemble")
def _build_ensemble(device) -> BuiltStep:
    from ..ensemble.batch import EnsembleSpace, flow_params, \
        make_scenario_step
    space, model = _space_model("float64", 16, device)
    B = 3
    espace = EnsembleSpace.stack([space] * B)
    step = make_scenario_step(model, espace)
    rates, frozens = flow_params([model] * B)
    lanes = step.lanes(rates, frozens)
    return BuiltStep("ensemble", step, (espace.values, lanes), space.dtype,
                     _grid_nbytes(space), model.offsets, 1,
                     kept={"_counts": _COUNTS, "counts": _COUNTS})


@contract("ensemble_mesh")
def _build_ensemble_mesh(device) -> BuiltStep:
    # the meshed ensemble runner (EnsembleExecutor(mesh=).runner_for) on a
    # (2, 2) mesh with every position on the device, then the
    # per-scenario totals as the dispatch takes them: totals_view, each
    # batch row's lanes reduced in f64 over the space axes
    from ..ensemble.batch import EnsembleExecutor, EnsembleSpace, \
        _mesh_totals, flow_params
    from ..ensemble.mesh import make_ensemble_mesh
    space, model = _space_model("float64", 16, device)
    nb, ns = 2, 2
    emesh = make_ensemble_mesh(nb, ns, devices=[device] * (nb * ns))
    B = 2 * nb
    espace = EnsembleSpace.stack([space] * B)
    ex = EnsembleExecutor(mesh=emesh)
    run = ex.runner_for(model, espace)
    rates, frozens = flow_params([model] * B)
    placed = emesh.place_values(espace.values)
    rates_g, frozens_g = emesh.place_lanes(rates), emesh.place_lanes(frozens)

    dev, (H, W) = space.device, space.shape

    def fn(placed, rates_g, frozens_g):
        out, _ = run(placed, rates_g, frozens_g, 1, 0)
        return _mesh_totals(emesh.totals_view(out), dev)

    return BuiltStep(
        "ensemble_mesh", fn, (placed, rates_g, frozens_g), space.dtype,
        _grid_nbytes(space), model.offsets, 1,
        kept={"_counts": _COUNTS, "counts": _COUNTS},
        batch_sum={"count": len(espace.values) * B, "min_elems": H * W,
                   "out_numel": 1})


@contract("active_fused")
def _build_active_fused(device) -> BuiltStep:
    # the stateless fused step: substeps=4 on a 64² f64 grid composes one
    # k=4 pass a call (its one tile admits k up to MAX_FUSED_K)
    space, model = _space_model("float64", 64, device, with_point=False)
    step = model.make_step(space, impl="active_fused", substeps=4)
    return BuiltStep("active_fused", step, (space.values,), space.dtype,
                     _grid_nbytes(space), model.offsets,
                     halo_depth=step.composed_k,
                     composed_k=step.composed_k,
                     composed_passes=step.composed_passes, substeps=4,
                     host_reads=1, sync_unit="pass",
                     units=step.composed_passes,
                     reads_at="mpi_model_tpu_torch/ops/fused_active.py:626",
                     kept={"counts": _COUNTS})


def _fused_runner(device, grid: int, dtype: str, substeps: int,
                  tile=None, blob=None):
    from ..core.cellular_space import CellularSpace
    from ..ops.active import plan_for
    from ..ops.fused_active import build_fused_runner, choose_fused_k
    space, model = _space_model(dtype, grid, device, with_point=False)
    if blob is not None:
        space = CellularSpace(
            {"value": _seeded((grid, grid), dtype, device, blob=blob)},
            grid, grid)
    plan = plan_for(space.shape, tile=tile)
    k = choose_fused_k(substeps, plan)
    run = build_fused_runner(space.shape, model.pallas_rates(),
                             model.offsets, space.dtype, plan=plan, k=k,
                             track_dirty=True)
    return space, model, plan, k, run


@contract("active_fused_runner")
def _build_active_fused_runner(device) -> BuiltStep:
    # the amortized whole-run form (SerialExecutor's path): two k=4
    # passes, so a pass's host read and its flags run between kernels
    space, model, plan, k, run = _fused_runner(device, 64, "float64", 4)
    return BuiltStep(
        "active_fused_runner", run, (space.values, 2 * k), space.dtype,
        _grid_nbytes(space), model.offsets, halo_depth=k, composed_k=k,
        composed_passes=1, substeps=k, dtype_check=False,
        host_reads=1, sync_unit="pass", units=2,
        reads_at="mpi_model_tpu_torch/ops/fused_active.py:547",
        fused_flags_tile_elems=plan.tile[0] * plan.tile[1])


def _ir_contract(model_name: str, impl: str, grid: int = 32):
    """One Flow IR lowering: ``FlowIRModel.make_step`` for a registered
    library model under one eligible impl, at the JAX package's
    geometry (32², f64)."""
    def build(device) -> BuiltStep:
        from ..ir import library
        from ..ir.model import FlowIRModel
        model, space = library.build_model(model_name, grid,
                                           dtype="float64", device=device)
        if impl == "active":
            # a sub-grid tile plan, so the window machinery (not the
            # one-tile dense degeneration) is what runs
            model = FlowIRModel(model.ir_terms, model.time,
                                model.time_step,
                                active_opts={"tile": (grid // 4,
                                                      grid // 4)})
        step = model.make_step(space, impl=impl)
        reads = dict(host_reads=1, sync_unit="step", units=1,
                     reads_at="mpi_model_tpu_torch/ir/lower.py:596"
                     ) if impl == "active" else {}
        return BuiltStep(f"ir_{model_name}_{impl}", step, (space.values,),
                         space.dtype, _grid_nbytes(space), model.offsets,
                         1, kept={"counts_cache": _COUNTS,
                                  "cache": "the lowering's cached 0-d "
                                  "constants and count grids (a tensor "
                                  "made each call would sync the card)"},
                         **reads)
    return build


for _m in ("gray_scott", "sir", "predator_prey"):
    for _i in ("xla", "composed", "active"):
        CONTRACTS[f"ir_{_m}_{_i}"] = _ir_contract(_m, _i)
CONTRACTS["ir_diffusion_xla"] = _ir_contract("diffusion", "xla")


# -- the kernel routes (step-launches on the card) -----------------------------

#: the routes' grid side (every route stays under 2048²)
ROUTE_SIDE = 256
#: their substeps (K1's phase 6j (a) count: one launch a call)
ROUTE_SUBSTEPS = 8


def _route_space(device, channels=("value",), blob=None):
    from ..core.cellular_space import CellularSpace
    n = ROUTE_SIDE
    vals = {c: _seeded((n, n), "float32", device, seed=7 + i, blob=blob)
            for i, c in enumerate(channels)}
    return CellularSpace(vals, n, n)


def _coupled_flows():
    """The CLI's ``--flow=coupled --channels=2`` chain (its K4 unit is
    the one ``chip_smoke.py`` builds beside the sources)."""
    from ..ops.flow import Coupled, Diffusion
    names = ("c0", "c1")
    return ([Diffusion(0.1, attr=nm) for nm in names]
            + [Coupled(flow_rate=0.05, attr="c0", modulator="c1")]), names


def _mesh_2x2(device):
    from ..parallel.mesh import make_mesh_2d
    return make_mesh_2d(2, 2, devices=[device] * 4)


def _sharded_route(name, device, model, space, impl, kernels, launches,
                   route, **ex_kw):
    from ..parallel.executors import ShardMapExecutor
    ex = ShardMapExecutor(_mesh_2x2(device), impl,
                          halo_depth=ROUTE_SUBSTEPS, **ex_kw)

    def fn(space):
        return ex.run_model(model, space, ROUTE_SUBSTEPS)

    return BuiltStep(
        name, fn, (space,), space.dtype, _grid_nbytes(space),
        model.offsets, ROUTE_SUBSTEPS, substeps=ROUTE_SUBSTEPS,
        host_reads=2, sync_unit="call", units=1,
        reads_at="mpi_model_tpu_torch/parallel/executors.py:320",
        consts_check=False, launches=launches, kernels=kernels, route=route)


@contract("k1_dense")
def _build_k1(device) -> BuiltStep:
    from ..models.model import Model
    from ..ops.flow import Diffusion
    space = _route_space(device)
    model = Model([Diffusion(0.1)], 10.0, 0.2)
    step = model.make_step(space, impl="pallas", substeps=ROUTE_SUBSTEPS)
    return BuiltStep(
        "k1_dense", step, (space.values,), space.dtype, _grid_nbytes(space),
        model.offsets, 1, substeps=ROUTE_SUBSTEPS,
        launches={"fused_stencil": 1}, kernels=("fused_stencil_kernel",),
        route="mpi_model_tpu/ops/pallas_stencil.py:526")


@contract("k2_sharded")
def _build_k2(device) -> BuiltStep:
    from ..models.model import Model
    from ..ops.flow import Diffusion
    return _sharded_route(
        "k2_sharded", device, Model([Diffusion(0.1)], 10.0, 0.2),
        _route_space(device), "pallas", ("fused_stencil_halo_kernel",),
        {"fused_stencil_halo": 4},
        "mpi_model_tpu/ops/pallas_stencil.py:757")


def _k3(device, variant: str) -> BuiltStep:
    from ..models.model import Model
    from ..ops.flow import Diffusion
    space = _route_space(device)
    model = Model([Diffusion(0.1)], 10.0, 0.2)
    step = model.make_step(space, impl="composed", substeps=ROUTE_SUBSTEPS,
                           composed_variant=variant)
    return BuiltStep(
        f"k3_{variant}", step, (space.values,), space.dtype,
        _grid_nbytes(space), model.offsets, halo_depth=step.composed_k,
        composed_k=step.composed_k, composed_passes=step.composed_passes,
        substeps=ROUTE_SUBSTEPS, launches={"composed_stencil": 1},
        kernels=(f"composed_{variant}_kernel",),
        route=("mpi_model_tpu/ops/composed_stencil.py:"
               + ("157" if variant == "vpu" else "197")),
        kept={"counts_cache": _COUNTS})


@contract("k3_vpu")
def _build_k3_vpu(device) -> BuiltStep:
    return _k3(device, "vpu")


@contract("k3_mxu")
def _build_k3_mxu(device) -> BuiltStep:
    return _k3(device, "mxu")


@contract("k3_halo")
def _build_k3_halo(device) -> BuiltStep:
    from ..models.model import Model
    from ..ops.flow import Diffusion
    return _sharded_route(
        "k3_halo", device, Model([Diffusion(0.1)], 10.0, 0.2),
        _route_space(device), "composed", ("composed_vpu_halo_kernel",),
        {"composed_stencil_halo": 4},
        "mpi_model_tpu/ops/composed_stencil.py:323",
        composed_variant="vpu")


@contract("k4_coupled")
def _build_k4(device) -> BuiltStep:
    from ..models.model import Model
    flows, names = _coupled_flows()
    space = _route_space(device, names)
    model = Model(flows, 10.0, 0.2)
    step = model.make_step(space, impl="pallas", substeps=ROUTE_SUBSTEPS)
    return BuiltStep(
        "k4_coupled", step, (space.values,), space.dtype,
        _grid_nbytes(space), model.offsets, 1, substeps=ROUTE_SUBSTEPS,
        launches={"field_stencil": 1}, kernels=("field_kernel",),
        route="mpi_model_tpu/ops/pallas_stencil.py:1380")


@contract("k4_halo")
def _build_k4_halo(device) -> BuiltStep:
    from ..models.model import Model
    flows, names = _coupled_flows()
    return _sharded_route(
        "k4_halo", device, Model(flows, 10.0, 0.2),
        _route_space(device, names), "pallas", ("field_kernel",),
        {"field_stencil_halo": 4},
        "mpi_model_tpu/ops/pallas_stencil.py:1396")


@contract("k5_pipeline")
def _build_k5(device) -> BuiltStep:
    from ..ensemble.batch import EnsembleExecutor, EnsembleSpace, \
        _uniform_rates, flow_params
    from ..models.model import Model
    from ..ops.flow import Diffusion
    model = Model([Diffusion(0.1)], 10.0, 0.2)
    B = 4
    espace = EnsembleSpace.stack([_route_space(device) for _ in range(B)])
    espace.values["value"].copy_(_seeded(
        (B, ROUTE_SIDE, ROUTE_SIDE), "float32", device, seed=11))
    rates, frozens = flow_params([model] * B)
    ex = EnsembleExecutor("pipeline", substeps=ROUTE_SUBSTEPS)
    run = ex.runner_for(model, espace,
                        _uniform_rates(model, [model] * B, rates))

    def fn(values):
        return run(values, rates, frozens, 1, 0)[0]

    v0 = espace.values["value"]
    return BuiltStep(
        "k5_pipeline", fn, (espace.values,), v0.dtype,
        v0[0].element_size() * v0[0].numel(), model.offsets, 1,
        substeps=ROUTE_SUBSTEPS, consts_check=False,
        launches={"pipeline_stencil": 1},
        kernels=("pipeline_stencil_kernel",),
        route="mpi_model_tpu/ops/pallas_stencil.py:728")


@contract("k67_active_fused")
def _build_k67(device) -> BuiltStep:
    # the fused runner at 256² with 32² tiles and one seeded blob: the
    # dilated set (9 of 64 tiles) stays under the fallback threshold, so
    # the pass is K6 + K7
    side = ROUTE_SIDE
    space, model, plan, k, run = _fused_runner(
        device, side, "float32", ROUTE_SUBSTEPS, tile=(32, 32),
        blob=(3 * 32 + 4, 4 * 32 + 4, 24))
    return BuiltStep(
        "k67_active_fused", run, (space.values, ROUTE_SUBSTEPS),
        space.dtype, _grid_nbytes(space), model.offsets, halo_depth=k,
        composed_k=k, composed_passes=1, substeps=ROUTE_SUBSTEPS,
        dtype_check=False, host_reads=1, sync_unit="pass",
        units=ROUTE_SUBSTEPS // k,
        reads_at="mpi_model_tpu_torch/ops/fused_active.py:547",
        launches={"fused_compute": 1, "fused_scatter": 1},
        kernels=("fused_compute_kernel", "fused_scatter_kernel"),
        route="mpi_model_tpu/ops/pallas_active.py:293 and :343")


# -- the GSPMD routes (no kernel: 0 launches on the card) ----------------------

def _gspmd_route(name, device, model, space, host_reads=0,
                 sync_unit="step", units=ROUTE_SUBSTEPS, reads_at=""):
    """``AutoShardedExecutor`` on a 2×2 mesh of ``device``, one call of
    ``ROUTE_SUBSTEPS`` steps. The JAX package's GSPMD path runs no Pallas
    kernel (its ``--impl=pallas`` is refused), so every route declares no
    launch and its trace must show no kernel of the port."""
    from ..parallel.executors import AutoShardedExecutor
    ex = AutoShardedExecutor(_mesh_2x2(device))

    def fn(space):
        return ex.run_model(model, space, ROUTE_SUBSTEPS)

    return BuiltStep(
        name, fn, (space,), space.dtype, _grid_nbytes(space),
        model.offsets, 1, host_reads=host_reads, sync_unit=sync_unit,
        units=units, reads_at=reads_at, consts_check=False, launches={},
        kernels=(), route="mpi_model_tpu/parallel/executors.py:82 (no "
        "kernel)")


@contract("gspmd_positions")
def _build_gspmd_positions(device) -> BuiltStep:
    # a pointwise flow: ShardMapExecutor("xla")'s per-shard runner and
    # ring exchange; the two reads are its run's synchronizes around the
    # assembly
    from ..models.model import Model
    from ..ops.flow import Diffusion
    return _gspmd_route(
        "gspmd_positions", device, Model([Diffusion(0.1)], 10.0, 0.2),
        _route_space(device), host_reads=2, sync_unit="call", units=1,
        reads_at="mpi_model_tpu_torch/parallel/executors.py:320")


@contract("gspmd_whole")
def _build_gspmd_whole(device) -> BuiltStep:
    # an undeclared footprint: the global step on the whole grid
    from ..models.model import Model
    from ..ops.flow import Flow

    class Undeclared(Flow):
        attr = "value"
        flow_rate = 0.1

        def outflow(self, values, origin=(0, 0)):
            return values[self.attr] * self.flow_rate

    return _gspmd_route("gspmd_whole", device,
                        Model([Undeclared()], 10.0, 0.2),
                        _route_space(device))


@contract("gspmd_point")
def _build_gspmd_point(device) -> BuiltStep:
    # the reference's frozen source and one dynamic source: the point
    # subsystem on the global view
    from ..core.attribute import Attribute
    from ..core.cell import Cell
    from ..models.model import Model
    from ..ops.flow import Exponencial, PointFlow
    model = Model([Exponencial(Cell(19, 3, Attribute(99, 2.2)), 0.1),
                   PointFlow((100, 150), 0.05)], 10.0, 0.2)
    return _gspmd_route("gspmd_point", device, model, _route_space(device))


# -- the term registry ---------------------------------------------------------

def check_term_registry() -> list[Finding]:
    """Walk every Term subclass the package defines (transitively) and
    assert the ir.lower registry holds exactly one lowering for each,
    defined IN ir.lower. A term kind lowered elsewhere — an impl-private
    branch — is exactly the hand-mirroring the IR exists to end."""
    from ..ir import lower as ir_lower
    from ..ir.terms import Term

    findings: list[Finding] = []

    def subclasses(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from subclasses(sub)

    for kind in subclasses(Term):
        low = ir_lower.LOWERINGS.get(kind)
        inherited = None
        if low is None:
            # a subclass may inherit its base kind's registered lowering
            # (same apply contract); only a kind with NO lowering anywhere
            # in its MRO is unregistered
            for base in kind.__mro__[1:]:
                if base in ir_lower.LOWERINGS:
                    inherited = ir_lower.LOWERINGS[base]
                    break
            if inherited is None:
                findings.append(Finding(
                    "step-term-registry", Severity.ERROR,
                    "step:term-registry", 0,
                    f"term kind {kind.__name__} has no registered "
                    "lowering — register exactly one in ir.lower"))
                continue
        target = low if low is not None else inherited
        mod = getattr(target, "__module__", "")
        if mod != ir_lower.__name__:
            findings.append(Finding(
                "step-term-registry", Severity.ERROR,
                "step:term-registry", 0,
                f"term kind {kind.__name__}'s lowering {target!r} is "
                f"defined in {mod!r}, not ir.lower — impl-private term "
                "lowerings reintroduce the hand-mirroring the IR "
                "replaces"))
    return findings


# -- the recorder --------------------------------------------------------------

@dataclasses.dataclass
class Op:
    """One recorded aten operation."""

    name: str                    # the overload packet, e.g. "sum"
    in_numel: int                # its first tensor argument's elements
    in_device: str               # and that argument's device type
    outs: tuple                  # ((shape, dtype), ...) of its outputs
    in_kernel: bool              # inside a kernel's plain version
    kcalls: int                  # kernel calls made before it


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _recorder_type():
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..models.model import kernel_launches

    class Recorder(TorchDispatchMode):
        """Records every aten operation; observes ``ops.seam`` so that an
        operation inside a kernel's plain version is marked as the
        kernel's. ``kcalls`` counts kernel calls: plain versions entered
        (CPU) plus launches counted by the wrappers (card)."""

        def __init__(self):
            super().__init__()
            self.ops: list[Op] = []
            self.depth = 0
            self.plain_calls = 0
            self.launch0 = sum(kernel_launches().values())

        def kcalls(self) -> int:
            return (self.plain_calls + sum(kernel_launches().values())
                    - self.launch0)

        def enter(self, name):
            if self.depth == 0:
                self.plain_calls += 1
            self.depth += 1

        def exit(self, name):
            self.depth -= 1

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            first = next(_tensors((args, kwargs or {})), None)
            self.ops.append(Op(
                func.overloadpacket.__name__,
                0 if first is None else first.numel(),
                "" if first is None else first.device.type,
                tuple((tuple(t.shape), t.dtype) for t in _tensors(out)),
                self.depth > 0, self.kcalls()))
            return out

    return Recorder


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record(fn, args, device):
    """Run ``fn(*args)`` under the recorder: ``(result, ops, warned,
    kcalls)`` with ``warned`` the card's sync-debug warnings, each as the
    ``file:line`` of the Python call that raised it (none on the CPU), and
    ``kcalls`` the kernel calls the run made."""
    import torch

    from ..ops import seam

    prev = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = _recorder_type()()
        if device.type == "cuda":
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with seam.observing(rec), rec:
                out = fn(*args)
        finally:
            if prev is not None:
                torch.cuda.set_sync_debug_mode(prev)
    warned = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
              if _SYNC_WARNING.search(str(w.message))]
    _sync(device)
    return out, rec.ops, warned, rec.kcalls()


# -- closure walk --------------------------------------------------------------

def closure_tensors(fn, limit: int = 6) -> list[tuple[str, object]]:
    """Every tensor (and numpy array) a callable holds: its closure cells,
    a ``functools.partial``'s function and arguments, a bound method's
    object, and — to ``limit`` levels — the attributes, dict values and
    sequence items of what those hold. ``[(path, tensor)]``, each
    storage once."""
    import numpy as np
    import torch

    found: list[tuple[str, object]] = []
    seen: set = set()
    storages: set = set()

    def visit(obj, path: str, depth: int):
        if isinstance(obj, torch.Tensor):
            if obj.numel() == 0:
                return
            key = (obj.untyped_storage().data_ptr(), obj.device.type)
            if key not in storages:
                storages.add(key)
                found.append((path, obj))
            return
        if isinstance(obj, np.ndarray):
            if id(obj) not in seen:
                seen.add(id(obj))
                found.append((path, obj))
            return
        if depth > limit or id(obj) in seen:
            return
        if isinstance(obj, (str, bytes, int, float, bool, complex,
                            type(None), type, types.ModuleType,
                            torch.device, torch.dtype)):
            return
        seen.add(id(obj))
        if isinstance(obj, functools.partial):
            visit(obj.func, f"{path}.func", depth + 1)
            for i, a in enumerate(obj.args):
                visit(a, f"{path}.args[{i}]", depth + 1)
            for k, a in (obj.keywords or {}).items():
                visit(a, f"{path}.{k}", depth + 1)
            return
        if isinstance(obj, types.MethodType):
            visit(obj.__self__, f"{path}.__self__", depth + 1)
            visit(obj.__func__, path, depth + 1)
            return
        if isinstance(obj, types.FunctionType):
            names = obj.__code__.co_freevars
            for name, cell in zip(names, obj.__closure__ or ()):
                try:
                    val = cell.cell_contents
                except ValueError:  # an empty cell
                    continue
                visit(val, f"{path}.{name}", depth + 1)
            for k, v in vars(obj).items():
                visit(v, f"{path}.{k}", depth + 1)
            return
        if isinstance(obj, dict):
            for k, v in obj.items():
                visit(v, f"{path}[{k!r}]", depth + 1)
            return
        if isinstance(obj, (list, tuple, set, frozenset)):
            for i, v in enumerate(obj):
                visit(v, f"{path}[{i}]", depth + 1)
            return
        attrs = getattr(obj, "__dict__", None)
        if attrs is not None:
            for k, v in attrs.items():
                visit(v, f"{path}.{k}", depth + 1)
        for k in getattr(type(obj), "__slots__", ()):
            if hasattr(obj, k):
                visit(getattr(obj, k), f"{path}.{k}", depth + 1)

    name = getattr(fn, "__name__", type(fn).__name__)
    visit(fn, name, 0)
    return found


def _nbytes(t) -> int:
    size = getattr(t, "nbytes", None)
    return int(size) if size is not None else 0


# -- the audit -----------------------------------------------------------------

def stencil_radius(offsets) -> int:
    """Chebyshev radius of a neighborhood: rings of halo a step needs."""
    return max(max(abs(int(dx)), abs(int(dy))) for dx, dy in offsets)


def _sync_count(ops, device) -> int:
    """Host reads dispatch shows outside kernels, of tensors on the audited
    device (on the card a CPU tensor's read waits for nothing)."""
    return sum(1 for op in ops if op.name in SYNC_OPS and not op.in_kernel
               and op.in_device == device.type)


def _reductions(ops):
    """Reductions outside kernels: ``(op, input elements)``."""
    for op in ops:
        if op.in_kernel or op.name not in REDUCE_OPS:
            continue
        out_numel = sum(math.prod(s) for s, _ in op.outs[:1])
        if out_numel < op.in_numel:
            yield op


def kernel_trace(fn, args, device, retries: int = 3) -> dict:
    """The port's kernels ``fn(*args)`` launched, by name with counts,
    from a ``torch.profiler`` trace. The call sits between two spins of
    the device (~50 ms each) and the trace is held open past its end, with
    ``acc_events`` (the profiler keeps only kernels whose device times
    fall inside its window, and in a long process it has lost the kernels
    of short traces); a trace that shows none of the port's kernels is
    made again, ``retries`` times."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    names: dict = {}
    for _ in range(retries):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            time.sleep(0.05)
            torch.cuda._sleep(100_000_000)
            fn(*args)
            torch.cuda._sleep(100_000_000)
            torch.cuda.synchronize(device)
            time.sleep(0.05)
        names = {}
        for e in prof.events():
            if e.device_type.name != "CUDA":
                continue
            for ident in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", e.name):
                if ident in KERNEL_NAMES:
                    names[ident] = names.get(ident, 0) + 1
        if names:
            break
    return names


def audit_built(built: BuiltStep, device) -> tuple[list[Finding], dict]:
    """Run one contract's step and check it: ``(findings, report)``."""
    import torch

    from ..models.model import kernel_launches

    where = f"step:{built.impl}"
    findings: list[Finding] = []
    report = {"contract": built.impl, "device": str(device)}

    def emit(rule_id: str, msg: str) -> None:
        findings.append(Finding(rule_id, Severity.ERROR, where, 0, msg))

    # warm: kernels built or loaded, lazy caches filled
    built.fn(*built.args)
    _sync(device)
    before = kernel_launches()
    out, ops, warned_at, kcalls = record(built.fn, built.args, device)
    warned = len(warned_at)
    after = kernel_launches()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    report.update(ops=len(ops), launches=launched)

    # dtype stability: every output tensor carries the space dtype
    dtypes = sorted({str(t.dtype).removeprefix("torch.")
                     for t in _tensors(out)})
    report["out_dtypes"] = dtypes
    if built.dtype_check:
        for i, t in enumerate(_tensors(out)):
            if t.dtype != built.space_dtype:
                emit("step-dtype",
                     f"output {i} of the {built.impl} step has dtype "
                     f"{t.dtype}, space dtype is {built.space_dtype} — a "
                     "silent promotion/downcast crossed the step boundary")

    # host reads: what dispatch shows, and on the card the sync debug
    # mode's warnings too
    seen = _sync_count(ops, device)
    reads = max(seen, warned)
    allowed = built.host_reads * built.units
    report.update(host_reads=reads, host_reads_dispatch=seen,
                  host_reads_warned=warned, host_reads_at=warned_at,
                  host_reads_allowed=allowed,
                  sync_unit=built.sync_unit, units=built.units,
                  host_reads_per_unit=reads / max(built.units, 1),
                  reads_at=built.reads_at)
    if reads > allowed:
        emit("step-sync",
             f"the {built.impl} call read the device on the host {reads} "
             f"time(s) (dispatch saw {seen}, the sync debug mode "
             f"{warned}); its contract allows {built.host_reads} a "
             f"{built.sync_unit} × {built.units} = {allowed}"
             + (f" ({built.reads_at})" if built.reads_at else ""))

    # closure tensors: nothing of a grid channel's size unless declared,
    # the total within budget
    if built.consts_check:
        total = 0
        for path, t in closure_tensors(built.fn):
            nb = _nbytes(t)
            total += nb
            parts = set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", path))
            if nb >= built.grid_nbytes and not parts & set(built.kept):
                emit("step-consts",
                     f"a {nb}-byte tensor (>= one {built.grid_nbytes}-byte "
                     f"grid channel) is held in the {built.impl} step's "
                     f"closure at {path} — make it per call or declare it "
                     "on the contract with its reason")
        report["closure_bytes"] = total
        if total > CONST_TOTAL_BUDGET:
            emit("step-consts",
                 f"the {built.impl} step's closure holds {total} bytes of "
                 f"tensors (budget {CONST_TOTAL_BUDGET})")

    # halo contract
    radius = stencil_radius(built.offsets)
    per_exchange = built.composed_k or 1
    need = radius * per_exchange
    if need > built.halo_depth:
        emit("step-halo",
             f"{built.impl} step needs {need} halo ring(s) (offsets radius "
             f"{radius} × {per_exchange} sub-step(s) per exchange) but its "
             f"sharded config declares halo_depth={built.halo_depth} — "
             "shard edges would read stale ghosts")
    if built.composed_k is not None:
        k, passes = built.composed_k, built.composed_passes
        if k * passes != built.substeps:
            emit("step-halo",
                 f"composed k={k} × passes={passes} != substeps="
                 f"{built.substeps} — the composed call no longer equals "
                 "the iterated step count")

    # fused flags: between the first and the last kernel call, no
    # reduction of tile size or larger outside a kernel
    if built.fused_flags_tile_elems is not None:
        thresh = int(built.fused_flags_tile_elems)
        last = kcalls
        between = [op for op in ops if 0 < op.kcalls < last]
        report["ops_between_kernels"] = len(between)
        if last < 2:
            emit("step-fused-flags",
                 f"the {built.impl} call made {last} kernel call(s); the "
                 "contract needs two passes through K6 + K7 to see what "
                 "runs between them")
        for op in _reductions(between):
            if op.in_numel >= thresh:
                emit("step-fused-flags",
                     f"`{op.name}` over {op.in_numel} elements between the "
                     f"{built.impl} runner's kernel calls — activity flags "
                     "must come out of the fused kernel, not a separate "
                     "per-pass reduction")

    # meshed totals: one f64 sum a channel and lane over the space axes,
    # nothing else that large
    if built.batch_sum is not None:
        spec = built.batch_sum
        big = [op for op in _reductions(ops)
               if op.in_numel >= int(spec["min_elems"])]
        report["batch_sums"] = len(big)
        if len(big) != int(spec["count"]):
            emit("step-batch-sum",
                 f"{len(big)} lane-grid-size reduction(s) in the "
                 f"{built.impl} runner, the contract expects exactly "
                 f"{spec['count']} (one [H,W] -> [] f64 total a channel "
                 "and lane, nothing else at that size)")
        for op in big:
            shape, dtype = op.outs[0]
            if dtype != torch.float64 or math.prod(shape) != int(
                    spec["out_numel"]):
                emit("step-batch-sum",
                     f"a lane reduction in the {built.impl} runner gives "
                     f"{dtype} of shape {shape}; the contract wants a "
                     f"float64 total of {spec['out_numel']} element(s) "
                     "(the conservation lanes stay f64, over the space "
                     "axes)")

    # kernel routes: launches and names on the card
    if built.launches is not None:
        report["route"] = built.route
        report["launches_declared"] = built.launches
        if device.type != "cuda":
            report["launch_check"] = ("not checked: on the CPU every "
                                      "wrapper runs its plain version and "
                                      "counts 0")
        else:
            if launched != built.launches:
                emit("step-launches",
                     f"the {built.impl} route launched {launched} in one "
                     f"call; its contract declares {built.launches}")
            names = kernel_trace(built.fn, built.args, device)
            report["kernels"] = names
            report["launch_check"] = "checked"
            missing = [n for n in built.kernels if n not in names]
            extra = sorted(set(names) - set(built.kernels))
            if missing or extra:
                emit("step-launches",
                     f"the {built.impl} route's trace shows kernels "
                     f"{sorted(names)}; its contract declares "
                     f"{list(built.kernels)}"
                     + (f" (missing {missing})" if missing else "")
                     + (f" (unexpected {extra})" if extra else ""))
    return findings, report


def audit_contracts(impls=None, device=None
                    ) -> tuple[list[Finding], list[dict]]:
    """Run the registered contracts (all by default) on ``device``:
    ``(findings, reports)``. ``device=None`` is the card; with no card it
    raises (``resolve_device``), it never falls back to the CPU."""
    from ..core.cellular_space import resolve_device

    dev = resolve_device(device)
    findings: list[Finding] = []
    reports: list[dict] = []
    if impls is None or "term-registry" in impls:
        findings.extend(check_term_registry())
    with warnings.catch_warnings():
        # the composed and active builders warn about degenerate depths on
        # purpose; the audit reads the steps, not the advice
        warnings.simplefilter("ignore", RuntimeWarning)
        for name, build in CONTRACTS.items():
            if impls is not None and name not in impls:
                continue
            try:
                built = build(dev)
                got, rep = audit_built(built, dev)
            # analysis: ignore[broad-except] — a broken contract build or
            # run must surface as a finding for ITS contract; the other
            # contracts run on
            except Exception as e:
                findings.append(Finding(
                    "step-dtype", Severity.ERROR, f"step:{name}", 0,
                    f"contract {name!r} failed to build or run: "
                    f"{type(e).__name__}: {e}"))
                reports.append({"contract": name, "error": repr(e)})
                continue
            findings.extend(got)
            reports.append(rep)
    return findings, reports


def run_step_audit(impls=None, device=None) -> list[Finding]:
    """Audit the registered step contracts (all by default) on ``device``
    (the card unless ``device="cpu"``)."""
    return audit_contracts(impls, device)[0]
