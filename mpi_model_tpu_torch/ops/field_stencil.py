"""K4, the fused multi-channel field step, and K4-halo, its sharded form:
wrappers, checks and plain versions.

Counterpart of ``mpi_model_tpu/ops/pallas_stencil.py``'s field kernel
(``_field_call``, ``PallasFieldStep``, ``pallas_field_halo_step``). One call
runs ``nsteps`` steps of any set of pointwise field flows (``Coupled``, user
flows) over every channel they read or write, in one read and one write of
device memory. The kernel is generated per lowered flow set: the flows are
lowered once by ``ops.field_lower``, ``ops.field_codegen`` turns the program
into a CUDA unit (its outflow function) over the body in
``csrc/field_stencil.cuh`` (CUDA C++ for sm_90a, loaded with ctypes), and
``ops._build.build_unit`` compiles the unit at the stepper's first call on
the card (``_build.build_all(units=...)`` builds several at once), cached
in ``_build/`` by a hash of its text.

- A CPU tensor takes ``field_step_plain``, the plain torch version; nothing
  is generated into a library or built.
- A CUDA tensor launches the kernel or raises; nothing falls back. A failed
  build raises naming the flow set.
- The ghost-depth rule is K1's (``fused_stencil.check_nsteps``): ``nsteps``
  up to 8 for f32 and 16 for bf16 with the JAX package's default blocks.
- Window rows: a block steps a ROWS x 256 window, every written channel's
  column of it in registers, the modulators' windows in shared memory.
  ``window_rows`` picks ROWS per (written channels, nsteps) as measured
  (``k4_variants.py``), at least ``min_rows`` (eight output rows), lowered
  in steps of 8 while the block's shared memory (``smem_bytes``) is over
  the 232,448 bytes a block may use; every program within ``check_program``'s
  limits fits at every depth the ghost-depth rule admits. A unit carries
  an instance for each ROWS its program can ask for (``unit_rows``).
- Only channels some flow writes are outputs; modulator-only channels pass
  through as the same tensor.
- ``pallas_field_halo_step`` (K4-halo, ``PallasFieldStep.halo``) steps one
  shard of every channel, reading each channel's ghost ring (every channel
  needs one: outflows are evaluated on ghost cells); the cells' coordinates
  are global, the shard's origin plus the local index.
- ``compute_dtype=torch.bfloat16`` is the TPU kernel's bf16 interior math,
  at every ``nsteps``: the cells of the TPU tiles that are not near the
  edge (``fused_stencil.bf16_rect``, JAX's tile rule on JAX's blocks) take
  the flows lowered at bf16 (``lower_flows(..., torch.bfloat16)``: JAX's
  promotion rule, every bf16 result rounded) over the channels rounded
  to bf16, and a bf16 transport (``share = of·(1/k)`` or ``of / k``, the
  inflow from 0 in ``offsets`` order, ``(v - of) + inflow``, each rounded);
  every other cell the f32 step, unchanged (the TPU kernel's near tiles
  are plain f32). The kernel runs the bf16 cells on a paired walk, two
  window rows a bf16x2 register (``field_codegen.pair_plan``,
  ``csrc/field_stencil.cuh``), in a launch of its own at its own window
  rows (``window_rows16``); a call is two kernel launches, counted as one.
- Launches are counted, per stepper (``PallasFieldStep.launches``) and
  module-wide (``launches()`` for K4, ``halo_launches()`` for K4-halo), only
  where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from ..core.cell import MOORE_OFFSETS
from ._build import KernelError
from .field_codegen import (TWO_BLOCK_WORDS, FieldUnit, modulators,
                            unit_source)
from .field_lower import (MAX_CHANNELS, FieldProgram, check_program,
                          eval_program, lower_flows)
from .flow import build_outflow
from .fused_stencil import (KERNEL_DTYPES, RING_PIECES, check_nsteps,
                            check_offsets, check_ring, check_ring_depth,
                            kernel_rect, pad_from_ring, padded_region, rb,
                            resolve_block, resolve_compute_dtype,
                            with_bf16_rect)
from .seam import plain_version
from .stencil import neighbor_counts, transport

#: a window's columns (one a thread of a block of 8 warps) and the block's
#: warps (csrc/stencil_common.cuh's kWinW, kThreadsY)
WIN_W = 256
WARPS = 8
#: warp-edge exchange slots (warps -1 .. 8, two edges each)
EDGE_SLOTS = 2 * (WARPS + 2)
#: shared memory one block may use on the H100 (sm_90)
SMEM_LIMIT = 232_448
#: shared memory a block may use for two blocks to fit an SM (228 KB, less
#: 1 KB reserved a block)
TWO_BLOCK_SMEM = 115_712
#: the paired walk's most window rows (the fastest measured, config 4 at
#: bf16 nsteps 16, k4_variants.py)
MAX_ROWS16 = 96
#: the deepest call per storage dtype (the ghost-depth rule's most)
MAX_NSTEPS = {"f32": 8, "bf16": 16}
_ITEMSIZE = {"f32": 4, "bf16": 2}
_launch_count = 0
_halo_launch_count = 0


def launches() -> int:
    """K4 launches made by this module since the last reset."""
    return _launch_count


def halo_launches() -> int:
    """K4-halo launches made by this module since the last reset."""
    return _halo_launch_count


def reset_launches() -> None:
    global _launch_count, _halo_launch_count
    _launch_count = 0
    _halo_launch_count = 0


def dtype_key(dtype) -> str:
    """``"f32"`` or ``"bf16"``: a kernel dtype's name in a unit."""
    return "f32" if dtype == torch.float32 else "bf16"


def stage_bytes(rows: int, itemsize: int) -> int:
    """One channel's staged window: ``rows`` rows of 256 columns and 16
    bytes of alignment slack, in the storage dtype."""
    return rows * (WIN_W + 16 // itemsize) * itemsize


def smem_bytes(n_out: int, n_mod: int, rows: int, itemsize: int) -> int:
    """Shared memory of one block (``csrc/field_stencil.cuh``'s
    ``smem_bytes``): each modulator's staged window, then the larger of the
    written channels' staged windows and what the walk reuses them for
    (the warp-edge exchange, two parities, and each warp's two outer
    columns' shares)."""
    sb = stage_bytes(rows, itemsize)
    walk = (2 * EDGE_SLOTS * n_out * rows + WARPS * 2 * (n_out * rows + 1)) * 4
    return n_mod * sb + max(n_out * sb, walk)


def preferred_rows(n_out: int, nsteps: int) -> int:
    """The window rows measured fastest per written channels and depth
    (``k4_variants.py`` on the H100, PERF.md): a thread holds ``n_out`` x
    ROWS values at two blocks an SM, so more written channels take fewer
    rows, and a shallow call takes fewer rows (its blocks load more than
    they step)."""
    if n_out == 1:
        return 32 if nsteps <= 2 else 48 if nsteps <= 8 else 64
    if n_out == 2:
        return 32 if nsteps <= 2 else 48
    if n_out == 3:
        return 32
    return 24


def min_rows(nsteps: int) -> int:
    """The fewest window rows of a call: eight output rows, a multiple of
    8 (the window is staged eight rows at a time)."""
    return 8 * ((2 * nsteps + 15) // 8)


def window_rows(n_out: int, n_mod: int, nsteps: int,
                itemsize: int) -> Optional[int]:
    """The window rows of a call: the preferred rows (at least
    ``min_rows``), lowered by 8 while the block is over ``SMEM_LIMIT``;
    None if even ``min_rows`` is (no program within the limits is)."""
    rows = max(preferred_rows(n_out, nsteps), min_rows(nsteps))
    while rows >= min_rows(nsteps):
        if smem_bytes(n_out, n_mod, rows, itemsize) <= SMEM_LIMIT:
            return rows
        rows -= 8
    return None


def smem_bytes16(n_out: int, n_mod: int, rows: int, itemsize: int) -> int:
    """Shared memory of one block of the paired walk (``csrc/
    field_stencil.cuh``'s ``smem_bytes16``): the staged windows, or the
    walk's pair words if more (the exchange, two parities, and each warp's
    two outer columns)."""
    sb = stage_bytes(rows, itemsize)
    words = n_out * rows // 2
    walk = (2 * EDGE_SLOTS * words + WARPS * 2 * (words + 1)) * 4
    return n_mod * sb + max(n_out * sb, walk)


def window_rows16(n_out: int, n_mod: int, nsteps: int,
                  itemsize: int) -> Optional[int]:
    """The paired walk's window rows (the bf16 interior math's second
    launch): 32 at one or two steps, else the most rows, a multiple of 8
    up to ``MAX_ROWS16``, at which two blocks fit an SM in registers
    (``n_out`` x rows / 2 words a thread, at most ``TWO_BLOCK_WORDS``: the
    threshold the unit's launch bounds take too) and in shared memory; at
    least ``min_rows``, lowered while over ``SMEM_LIMIT``; None if even
    ``min_rows`` is (no program within the limits is). Only config 4 was
    measured (``k4_variants.py``): 32 at nsteps 1, 48 at f32 storage nsteps
    8 (two blocks' staged f32 windows), 96 at bf16 storage nsteps 16. The
    rule looks at no program's size: larger programs may spill at these
    rows (PERF.md)."""
    lo = min_rows(nsteps)
    if nsteps <= 2:
        rows = max(32, lo)
    else:
        rows = max(lo, min(MAX_ROWS16, 8 * (2 * TWO_BLOCK_WORDS // n_out
                                            // 8)))
        while rows > lo and smem_bytes16(n_out, n_mod, rows,
                                          itemsize) > TWO_BLOCK_SMEM:
            rows -= 8
    while rows >= lo:
        if smem_bytes16(n_out, n_mod, rows, itemsize) <= SMEM_LIMIT:
            return rows
        rows -= 8
    return None


def unit_rows(n_out: int, n_mod: int) -> dict[str, tuple[int, ...]]:
    """Every window height a program of ``n_out`` written channels and
    ``n_mod`` modulators can ask for, per storage dtype: its unit's
    instances."""
    out = {}
    for key, deepest in MAX_NSTEPS.items():
        rows = {window_rows(n_out, n_mod, n, _ITEMSIZE[key])
                for n in range(1, deepest + 1)}
        out[key] = tuple(sorted(r for r in rows if r is not None))
    return out


def unit_rows16(n_out: int, n_mod: int) -> dict[str, tuple[int, ...]]:
    """``unit_rows`` for the paired walk (``window_rows16``)."""
    out = {}
    for key, deepest in MAX_NSTEPS.items():
        rows = {window_rows16(n_out, n_mod, n, _ITEMSIZE[key])
                for n in range(1, deepest + 1)}
        out[key] = tuple(sorted(r for r in rows if r is not None))
    return out


def check_pointwise(flows) -> None:
    for f in flows:
        if getattr(f, "footprint", "unknown") != "pointwise":
            raise ValueError(
                f"PallasFieldStep requires pointwise flows; "
                f"{type(f).__name__} declares "
                f"footprint={getattr(f, 'footprint', 'unknown')!r}")


class FieldPlanError(ValueError):
    """A static reason K4 cannot take a call: a flow that cannot be
    lowered, a program past the kernel's limits, too many steps for the
    ghost depth, or a block past the shared memory. Raised while planning,
    before anything is built or launched."""


@dataclasses.dataclass(frozen=True)
class FieldPlan:
    """Everything K4 decides before a call: the lowered program, the
    call's window rows, the generated unit and the flow set's label (a
    failed build names it)."""

    program: FieldProgram
    rows: int
    unit: FieldUnit
    label: str
    #: the program of the bf16 interior math, None for f32 compute
    program16: Optional[FieldProgram] = None
    #: the paired walk's window rows (``window_rows16``), None for f32
    #: compute
    rows16: Optional[int] = None


def plan_field(flows, names: Sequence[str], shape: tuple[int, int], dtype,
               nsteps: int, block: Optional[tuple[int, int]] = None,
               offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
               compute_dtype=None) -> FieldPlan:
    """Everything K4 decides before a call, from static facts only: the
    lowered program (and, for ``compute_dtype=torch.bfloat16``, the bf16
    one), the window rows and the unit's text (nothing is built). Raises
    ``FieldPlanError`` when the flows cannot be lowered, exceed the
    program limits, need more steps than the ghost depth or more shared
    memory than a block has."""
    offsets = check_offsets(offsets)
    prog16 = None
    try:
        check_pointwise(flows)
        prog = lower_flows(flows, names)
        check_program(prog)
        if resolve_compute_dtype(compute_dtype) is not None:
            prog16 = lower_flows(flows, names, torch.bfloat16)
        check_nsteps(int(nsteps), resolve_block(tuple(shape), dtype, block),
                     dtype)
    except ValueError as e:
        raise FieldPlanError(str(e)) from e
    n_out, n_mod = len(prog.outputs), len(modulators(prog))
    itemsize = _ITEMSIZE[dtype_key(dtype)]
    rows = window_rows(n_out, n_mod, int(nsteps), itemsize)
    if rows is None:
        raise FieldPlanError(
            f"the field kernel's block needs "
            f"{smem_bytes(n_out, n_mod, min_rows(int(nsteps)), itemsize)} "
            f"bytes of shared memory even at {min_rows(int(nsteps))} window "
            f"rows ({n_out} written channels, {n_mod} modulators, "
            f"nsteps={nsteps}), over the {SMEM_LIMIT} bytes a block may "
            "use; use fewer substeps or impl='xla'")
    # the paired walk's block needs no more shared memory than the f32
    # walk's at the same rows, so it fits wherever ``rows`` did
    rows16 = (window_rows16(n_out, n_mod, int(nsteps), itemsize)
              if prog16 is not None else None)
    label = (", ".join(prog.labels) + " over offsets "
             + " ".join(f"({dx},{dy})" for dx, dy in offsets))
    return FieldPlan(prog, rows, unit_source(
        prog, offsets, unit_rows(n_out, n_mod), prog16,
        unit_rows16(n_out, n_mod)), label, prog16, rows16)


def interior_steps_bf16(chans: Mapping[str, torch.Tensor],
                        prog16: FieldProgram,
                        offsets: Sequence[tuple[int, int]], nsteps: int,
                        origin: tuple[int, int]) -> dict[str, torch.Tensor]:
    """``nsteps`` steps of the bf16 interior math over the whole ``[h, w]``
    array at global ``origin``, zeros beyond it: ``chans`` holds the
    program's channels as bf16 values in f32; per step the outflows of
    ``prog16`` (``eval_program``), then per written channel ``share =
    rb(of·(1/k))`` (``rb(of / k)`` where k is not a power of two), the
    inflow ``rb(... rb(0 + share[c + d0]) ...)`` in ``offsets`` order and
    ``rb(rb(v - of) + inflow)``. Exact on the cells whose n-cone lies on
    the grid off its outer ring (every count full); returns the written
    channels (``prog16.outputs``), stepped."""
    h, w = next(iter(chans.values())).shape
    dev = next(iter(chans.values())).device
    rows = int(origin[0]) + torch.arange(h, device=dev)[:, None].expand(h, w)
    cols = int(origin[1]) + torch.arange(w, device=dev)[None, :].expand(h, w)
    k = len(offsets)
    cur = dict(chans)
    for _ in range(int(nsteps)):
        of = eval_program(prog16, cur, rows, cols)
        new = {}
        for a, o in of.items():
            share = rb(o * (1.0 / k)) if k & (k - 1) == 0 else rb(o / float(k))
            p = torch.nn.functional.pad(share, (1, 1, 1, 1))
            inflow = torch.zeros_like(share)
            for dx, dy in offsets:
                inflow = rb(inflow + p[1 + dx:1 + dx + h, 1 + dy:1 + dy + w])
            new[a] = rb(rb(cur[a] - o) + inflow)
        cur.update(new)
    return {a: cur[a] for a in prog16.outputs}


def field_step_plain(values: Mapping[str, torch.Tensor], flows,
                     offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                     nsteps: int = 1, origin: tuple[int, int] = (0, 0),
                     global_shape: Optional[tuple[int, int]] = None,
                     compute_dtype=None,
                     block: Optional[tuple[int, int]] = None
                     ) -> dict[str, torch.Tensor]:
    """The plain torch version of K4: every floating channel cast to f32
    once, ``nsteps`` steps of ``build_outflow`` + ``transport`` (the plain
    model step), each written channel cast back once. bf16 is thus rounded
    once per call, as the kernel (and the TPU kernel) does; modulator-only
    channels come back as the same tensors.

    ``compute_dtype=torch.bfloat16``: the cells of ``bf16_rect`` (JAX's
    interior tiles of ``block``, or of the block JAX picks) take
    ``interior_steps_bf16`` over the channels rounded to bf16; every other
    cell the f32 steps above."""
    offsets = check_offsets(offsets)
    first = next(iter(values.values()))
    shape = tuple(first.shape[-2:])
    if resolve_compute_dtype(compute_dtype) is not None:
        prog16 = lower_flows(flows, tuple(values), torch.bfloat16)
        return with_bf16_rect(
            field_step_plain(values, flows, offsets, nsteps, origin,
                             global_shape),
            lambda: interior_steps_bf16(
                {n: rb(values[n].to(torch.float32)) for n in prog16.channels},
                prog16, offsets, nsteps, origin),
            shape, values[prog16.outputs[0]].dtype, block, nsteps, origin,
            global_shape)
    cur = {k: (t.to(torch.float32) if t.is_floating_point() else t)
           for k, t in values.items()}
    counts = neighbor_counts(shape, offsets, origin, global_shape,
                             torch.float32, first.device)
    written: set = set()
    for _ in range(int(nsteps)):
        of = build_outflow(flows, cur, origin)
        cur = {**cur, **{a: transport(cur[a], o, counts, offsets)
                         for a, o in of.items()}}
        written |= set(of)
    return {**values, **{a: cur[a].to(values[a].dtype) for a in written}}


def field_halo_step_plain(values: Mapping[str, torch.Tensor],
                          rings: Mapping[str, Mapping[str, torch.Tensor]],
                          origin: tuple[int, int],
                          global_shape: tuple[int, int], flows,
                          offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                          nsteps: int = 1, compute_dtype=None,
                          block: Optional[tuple[int, int]] = None
                          ) -> dict[str, torch.Tensor]:
    """The plain torch version of K4-halo: every channel's padded shard from
    its ring, floating channels cast to f32 once, masked to the grid;
    ``nsteps`` steps of ``build_outflow`` (at the padded shard's global
    origin, outflows zero off the grid) + ``transport`` (counts from global
    coordinates, off-grid cells re-zeroed); the shard cropped out and each
    written channel cast back once. Modulator-only channels come back as the
    same tensors. Shards stepped so and put together equal
    ``field_step_plain`` on the whole grid bit for bit.

    ``compute_dtype=torch.bfloat16``: as ``field_step_plain``, with the
    shard's TPU tiles (``block``, or the block JAX picks for the shard) at
    its global origin."""
    offsets = check_offsets(offsets)
    first = next(iter(values.values()))
    h, w = first.shape
    d = int(next(iter(rings.values()))["n"].shape[0])
    org, mask, counts = padded_region(first, rings[next(iter(values))],
                                      origin, global_shape, offsets)
    if resolve_compute_dtype(compute_dtype) is not None:
        prog16 = lower_flows(flows, tuple(values), torch.bfloat16)
        return with_bf16_rect(
            field_halo_step_plain(values, rings, origin, global_shape, flows,
                                  offsets, nsteps),
            lambda: interior_steps_bf16(
                {n: rb(torch.where(mask, pad_from_ring(
                    values[n], rings[n]).to(torch.float32), 0.0))
                 for n in prog16.channels}, prog16, offsets, nsteps, org),
            (h, w), values[prog16.outputs[0]].dtype, block, nsteps, origin,
            global_shape, at=d)
    cur = {}
    for k, t in values.items():
        p = pad_from_ring(t, rings[k])
        if p.is_floating_point():
            p = p.to(torch.float32)
        cur[k] = torch.where(mask, p, torch.zeros((), dtype=p.dtype))
    written: set = set()
    for _ in range(int(nsteps)):
        of = {a: torch.where(mask, o, 0.0)
              for a, o in build_outflow(flows, cur, org).items()}
        cur = {**cur, **{a: torch.where(mask, transport(cur[a], o, counts,
                                                        offsets), 0.0)
                         for a, o in of.items()}}
        written |= set(of)
    return {**values, **{a: cur[a][d:d + h, d:d + w].to(values[a].dtype)
                         for a in written}}


class _FieldCall(ctypes.Structure):
    """``FieldCall`` of ``csrc/field_stencil.cuh``, field for field."""

    _fields_ = [
        ("inp", ctypes.c_void_p * MAX_CHANNELS),
        ("ring", (ctypes.c_void_p * 8) * MAX_CHANNELS),
        ("out", ctypes.c_void_p * MAX_CHANNELS),
        ("h", ctypes.c_int), ("w", ctypes.c_int), ("d", ctypes.c_int),
        ("R0", ctypes.c_int), ("C0", ctypes.c_int),
        ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("nsteps", ctypes.c_int), ("rows", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("br0", ctypes.c_int), ("br1", ctypes.c_int),
        ("bc0", ctypes.c_int), ("bc1", ctypes.c_int),
        ("rows16", ctypes.c_int),
    ]


def kernel_channels(prog: FieldProgram) -> tuple[str, ...]:
    """The channels in the order the kernel loads them: the written ones
    (``outputs``), then the modulators."""
    return prog.outputs + modulators(prog)


def pack_call(plan: FieldPlan, nsteps: int, chans: Sequence[torch.Tensor],
              outs: Sequence[torch.Tensor],
              rings: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
              origin: tuple[int, int] = (0, 0),
              global_shape: Optional[tuple[int, int]] = None,
              depth: int = 0,
              rect: tuple[int, int, int, int] = (0, 0, 0, 0)) -> _FieldCall:
    """The launch argument: ``chans`` in ``kernel_channels`` order (K4-halo:
    their ``rings`` too, ``depth`` deep, the shard at ``origin`` of
    ``global_shape``), ``outs`` in ``outputs`` order. ``vec`` says whether
    every loaded channel's rows are 16-byte aligned (cp.async windows).
    ``rect``: the global rows and columns of the cells the bf16 interior
    math takes, and ``rows16`` the paired walk's window rows (read by a
    bf16-compute launch only)."""
    a = _FieldCall()
    h, w = (int(x) for x in chans[0].shape)
    a.h, a.w = h, w
    a.H, a.W = (h, w) if global_shape is None else (int(global_shape[0]),
                                                     int(global_shape[1]))
    a.R0, a.C0 = int(origin[0]), int(origin[1])
    a.d, a.nsteps, a.rows = int(depth), int(nsteps), plan.rows
    a.vec = int(all(t.data_ptr() % 16 == 0 for t in chans)
                and (w * chans[0].element_size()) % 16 == 0)
    for c, t in enumerate(chans):
        a.inp[c] = t.data_ptr()
        for i, p in enumerate(RING_PIECES if rings is not None else ()):
            a.ring[c][i] = rings[c][p].data_ptr()
    for o, t in enumerate(outs):
        a.out[o] = t.data_ptr()
    a.br0, a.br1, a.bc0, a.bc1 = (int(x) for x in rect)
    a.rows16 = plan.rows16 or 0
    return a


#: the loaded library of each unit, by its text
_unit_libs: dict[str, ctypes.CDLL] = {}


def unit_library(plan: FieldPlan) -> ctypes.CDLL:
    """The plan's unit, built (or taken from the cache) and loaded; raises
    naming the flow set if nvcc fails, and checks the launch argument's
    layout and each instance's shared memory against this module's."""
    lib = _unit_libs.get(plan.unit.text)
    if lib is not None:
        return lib
    from . import _build

    lib = _build.load_unit(_build.build_unit(plan.unit.text, plan.label))
    for key in ("f32", "bf16"):
        for entry in ("mm_field", "mm_field_cbf16")[
                :2 if plan.program16 is not None else 1]:
            getattr(lib, f"{entry}_{key}").argtypes = [ctypes.c_void_p,
                                                       ctypes.c_void_p]
            getattr(lib, f"{entry}_{key}").restype = ctypes.c_int
    lib.mm_field_call_size.restype = ctypes.c_int
    lib.mm_field_error_string.argtypes = [ctypes.c_int]
    lib.mm_field_error_string.restype = ctypes.c_char_p
    if lib.mm_field_call_size() != ctypes.sizeof(_FieldCall):
        raise KernelError(
            f"the field kernel's FieldCall is {lib.mm_field_call_size()} "
            f"bytes, the wrapper's {ctypes.sizeof(_FieldCall)}")
    prog = plan.program
    n_out, n_mod = len(prog.outputs), len(modulators(prog))
    for key in ("f32", "bf16"):
        checks = [("", rows, smem_bytes) for rows in plan.unit.rows_of(key)]
        checks += [("16", rows, smem_bytes16)
                   for rows in plan.unit.rows16_of(key)]
        for which, rows, reckon in checks:
            fn = getattr(lib, f"mm_field_smem{which}_{key}")
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
            got = fn(rows)
            want = reckon(n_out, n_mod, rows, _ITEMSIZE[key])
            if got != want:
                raise KernelError(
                    f"the field kernel's {key} instance{which} of {rows} "
                    f"rows takes {got} bytes of shared memory, the wrapper "
                    f"reckons {want}")
    _unit_libs[plan.unit.text] = lib
    return lib


def _launch(plan: FieldPlan, call: _FieldCall, dtype, device,
            stepper: Optional["PallasFieldStep"] = None,
            halo: bool = False) -> None:
    """Launch K4 (or K4-halo) on the current stream; raises on any launch
    error. Counts the launch, module-wide and on ``stepper``, once the
    kernel is queued. An empty grid has nothing to compute: no launch,
    nothing counted."""
    global _launch_count, _halo_launch_count
    if call.h == 0 or call.w == 0:
        return
    lib = unit_library(plan)
    entry = "mm_field_cbf16" if plan.program16 is not None else "mm_field"
    fn = getattr(lib, f"{entry}_{dtype_key(dtype)}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(call), stream)
    if err != 0:
        raise KernelError(
            f"field_stencil {'halo ' if halo else ''}kernel launch failed "
            f"for {plan.label}: {lib.mm_field_error_string(err).decode()} "
            f"(cudaError {err})")
    if halo:
        _halo_launch_count += 1
    else:
        _launch_count += 1
    if stepper is not None:
        stepper.launches += 1


def pallas_field_step(
    values: Mapping[str, torch.Tensor],
    flows,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    block: Optional[tuple[int, int]] = None,
    nsteps: int = 1,
    compute_dtype=None,
    out: Optional[Mapping[str, torch.Tensor]] = None,
) -> dict[str, torch.Tensor]:
    """``nsteps`` fused steps of the pointwise ``flows`` over the channels
    of ``values`` in one device-memory round trip; returns the updated dict
    (modulator-only channels unchanged). ``out`` (CUDA only) maps written
    channels to preallocated tensors that receive the result; none may
    alias a channel the kernel reads."""
    return PallasFieldStep(tuple(next(iter(values.values())).shape), flows,
                           offsets=offsets, block=block, nsteps=nsteps,
                           compute_dtype=compute_dtype)(values, out=out)


def pallas_field_halo_step(
    values: Mapping[str, torch.Tensor],
    rings: Mapping[str, Mapping[str, torch.Tensor]],
    origin: tuple[int, int],
    global_shape: tuple[int, int],
    flows,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    block: Optional[tuple[int, int]] = None,
    nsteps: int = 1,
    compute_dtype=None,
    out: Optional[Mapping[str, torch.Tensor]] = None,
) -> dict[str, torch.Tensor]:
    """K4-halo: ``nsteps`` fused steps of the pointwise ``flows`` on one
    shard of every channel of a sharded grid. ``rings`` maps EVERY channel
    name to its ghost ring (``parallel.halo.exchange_ring``'s dict);
    ``origin`` is the shard's global (row, col) offset and ``global_shape``
    the whole grid's dims. Flow channels are updated; modulator-only
    channels pass through unchanged. Semantics: ``nsteps`` applications of
    the summed-outflow model step on the global grid, computed
    shard-locally."""
    return PallasFieldStep(tuple(next(iter(values.values())).shape), flows,
                           offsets=offsets, block=block, nsteps=nsteps,
                           compute_dtype=compute_dtype).halo(
        values, rings, origin, global_shape, out=out)


class PallasFieldStep:
    """Reusable fused stepper for any set of pointwise field flows over a
    multi-channel grid (``Coupled``, user flows): the general form of
    ``PallasDiffusionStep``. Called with the full values dict; returns the
    updated dict. ``names`` (the space's channels) plans the call at
    construction, so that a flow that cannot be lowered raises there;
    otherwise each new set of channel names is planned at its first call.
    The plan's unit is built at the first call on the card.
    ``launches`` counts the kernel launches this stepper made."""

    def __init__(self, shape: tuple[int, int], flows, dtype=torch.float32,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                 block: Optional[tuple[int, int]] = None,
                 nsteps: int = 1, compute_dtype=None,
                 names: Optional[Sequence[str]] = None):
        check_pointwise(flows)  # JAX's error, before any planning
        resolve_compute_dtype(compute_dtype)
        if int(nsteps) < 1:
            raise ValueError(f"nsteps must be >= 1, got {nsteps}")
        self.shape = tuple(shape)
        self.flows = tuple(flows)
        self.dtype = dtype
        self.offsets = check_offsets(offsets)
        self.block = block
        self.nsteps = int(nsteps)
        self.compute_dtype = compute_dtype
        self.launches = 0
        self._plans: dict = {}
        #: the plan made at construction (``names``)
        self.planned: Optional[FieldPlan] = None
        if names is not None:
            self.planned = self.plan(tuple(names), dtype)

    @property
    def program(self) -> Optional[FieldProgram]:
        """The program planned at construction."""
        return self.planned.program if self.planned is not None else None

    @property
    def rows(self) -> Optional[int]:
        """The window rows planned at construction."""
        return self.planned.rows if self.planned is not None else None

    def plan(self, names: tuple, dtype) -> FieldPlan:
        """The plan for these channels."""
        key = (names, dtype)
        if key not in self._plans:
            self._plans[key] = plan_field(self.flows, names, self.shape,
                                          dtype, self.nsteps, self.block,
                                          self.offsets, self.compute_dtype)
        return self._plans[key]

    def _checked(self, values: Mapping[str, torch.Tensor]):
        """The call's plan from its channels: (plan, dtype, the loaded
        channels' tensors in kernel order, their device). Raises on
        channels the flows need but the values lack, on flow channels not
        of one kernel dtype, and on loaded channels of another dtype or
        shape."""
        names = tuple(values)
        missing = sorted({f.attr for f in self.flows} - set(names))
        if missing:
            raise ValueError(f"flows write channels {missing} that the "
                             f"values do not carry (have {names})")
        flow_dtypes = {values[f.attr].dtype for f in self.flows}
        if len(flow_dtypes) != 1 or not flow_dtypes <= set(KERNEL_DTYPES):
            raise TypeError(
                f"the field kernel takes float32 or bfloat16 flow channels "
                f"of one dtype, got {sorted(map(str, flow_dtypes))}; "
                "float64 stays on the plain path (impl='xla')")
        dtype = next(iter(flow_dtypes))
        plan = self.plan(names, dtype)
        order = kernel_channels(plan.program)
        chans = [values[n] for n in order]
        for n, t in zip(order, chans):
            if t.dtype != dtype or tuple(t.shape) != self.shape:
                raise ValueError(
                    f"channel {n!r} is {t.dtype} {tuple(t.shape)}; the field "
                    f"kernel needs every channel it reads as {dtype} "
                    f"{self.shape}")
        return plan, dtype, chans, chans[0].device

    def _outputs(self, prog, values, dtype, dev, out, reads) -> dict:
        """The written channels' output tensors: ``out``'s where given
        (checked), else new ones; none may alias a tensor the call reads."""
        outs = {}
        in_ptrs = {t.data_ptr() for t in reads}
        for n in prog.outputs:
            t = (out or {}).get(n)
            if t is None:
                t = torch.empty_like(values[n])
            elif (t.shape != values[n].shape or t.dtype != dtype
                  or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"out[{n!r}] must be a contiguous tensor of "
                                 "the channel's shape, dtype and device")
            elif t.data_ptr() in in_ptrs:
                raise ValueError(f"the kernel is out of place: out[{n!r}] "
                                 "must not alias a channel it reads")
            outs[n] = t
        return outs

    @staticmethod
    def _copy_out(res: dict, out) -> dict:
        for n, t in (out or {}).items():
            t.copy_(res[n])
            res[n] = t
        return res

    def __call__(self, values: Mapping[str, torch.Tensor],
                 out: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> dict[str, torch.Tensor]:
        plan, dtype, chans, dev = self._checked(values)
        if dev.type == "cpu":
            return self._copy_out(plain_version(
                "K4", field_step_plain, values, self.flows, self.offsets,
                self.nsteps, compute_dtype=self.compute_dtype,
                block=self.block), out)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if any(t.device != dev or not t.is_contiguous() for t in chans):
            raise ValueError("every channel must be a contiguous tensor on "
                             "one device")
        outs = self._outputs(plan.program, values, dtype, dev, out, chans)
        call = pack_call(plan, self.nsteps, chans,
                         [outs[n] for n in plan.program.outputs],
                         rect=kernel_rect(self.shape, dtype, self.block,
                                          self.nsteps, self.compute_dtype)
                         or (0, 0, 0, 0))
        _launch(plan, call, dtype, dev, self)
        return {**values, **outs}

    def halo(self, values: Mapping[str, torch.Tensor],
             rings: Mapping[str, Mapping[str, torch.Tensor]],
             origin: tuple[int, int], global_shape: tuple[int, int],
             out: Optional[Mapping[str, torch.Tensor]] = None
             ) -> dict[str, torch.Tensor]:
        """K4-halo: this stepper's ``nsteps`` steps on one shard of every
        channel (``values``, each ``self.shape``), with every channel's
        ghost ring in ``rings``, at global ``origin`` in a grid of
        ``global_shape`` (see ``pallas_field_halo_step``). The JAX
        package's checks: a ring for every channel, ring depth within the
        slab capacity, ``nsteps <= d``."""
        missing = sorted(n for n in values if n not in rings)
        if missing:
            raise ValueError(
                f"pallas_field_halo_step needs a ghost ring for EVERY channel "
                f"(outflows are evaluated on ghost cells); missing {missing}")
        plan, dtype, chans, dev = self._checked(values)
        depths = {n: check_ring(values[n], rings[n], f"rings[{n!r}]")
                  for n in values}
        d = depths[next(iter(values))]
        if set(depths.values()) != {d}:
            raise ValueError(f"every channel's ring must have one depth; got "
                             f"{depths}")
        check_ring_depth(d, self.shape, dtype, self.block)
        if self.nsteps > d:
            raise ValueError(
                f"nsteps={self.nsteps} needs a ghost ring at least that "
                f"deep; got depth {d} (exchange_ring(..., "
                f"depth={self.nsteps}))")
        if dev.type == "cpu":
            return self._copy_out(plain_version(
                "K4-halo", field_halo_step_plain, values, rings, origin,
                global_shape, self.flows, self.offsets, self.nsteps,
                self.compute_dtype, self.block), out)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        order = kernel_channels(plan.program)
        reads = list(chans) + [rings[n][p] for n in order
                               for p in RING_PIECES]
        if any(t.device != dev or not t.is_contiguous() for t in reads):
            raise ValueError("every channel and ring piece must be a "
                             "contiguous tensor on one device")
        h, w = self.shape
        R0, C0 = int(origin[0]), int(origin[1])
        H, W = int(global_shape[0]), int(global_shape[1])
        if R0 < 0 or C0 < 0 or R0 + h > H or C0 + w > W:
            raise ValueError(f"a {h}x{w} shard at {(R0, C0)} does not lie "
                             f"inside the {H}x{W} grid")
        outs = self._outputs(plan.program, values, dtype, dev, out, reads)
        call = pack_call(plan, self.nsteps, chans,
                         [outs[n] for n in plan.program.outputs],
                         [rings[n] for n in order], (R0, C0), (H, W), d,
                         kernel_rect(self.shape, dtype, self.block,
                                     self.nsteps, self.compute_dtype,
                                     (R0, C0), (H, W)) or (0, 0, 0, 0))
        _launch(plan, call, dtype, dev, self, halo=True)
        return {**values, **outs}
