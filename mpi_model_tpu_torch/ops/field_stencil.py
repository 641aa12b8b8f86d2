"""K4, the fused multi-channel field step, and K4-halo, its sharded form:
wrappers, checks and plain versions.

Counterpart of ``mpi_model_tpu/ops/pallas_stencil.py``'s field kernel
(``_field_call``, ``PallasFieldStep``, ``pallas_field_halo_step``). The
kernel is ``csrc/field_stencil.cu`` (CUDA C++ for sm_90a, loaded with
ctypes): one call runs ``nsteps`` steps of any set of pointwise field flows
(``Coupled``, user flows) over every channel they read or write, in one
read and one write of device memory. The flows reach it as programs in
register form, lowered once by ``ops.field_lower``.

- A CPU tensor takes ``field_step_plain``, the plain torch version.
- A CUDA tensor launches the kernel or raises; nothing falls back.
- The ghost-depth rule is K1's (``fused_stencil.check_nsteps``): ``nsteps``
  up to 8 for f32 and 16 for bf16 with the JAX package's default blocks.
- Shared memory: a block holds a (TILE_H + 2n) × (128 + 2n) f32 window per
  loaded channel, per written channel's outflow and per intermediate slot
  of the register-form program (at least one: it doubles as the share
  buffer). The wrapper picks TILE_H from 32, 16, 8 so that this fits the
  232,448 bytes a block may use (``pick_tile_h``), and raises, naming the
  budget, when none does. ``Model.make_step(impl="auto")`` treats that as a
  static reason to take the plain path.
- Only channels some flow writes are outputs; modulator-only channels pass
  through as the same tensor.
- ``pallas_field_halo_step`` (K4-halo, ``PallasFieldStep.halo``) steps one
  shard of every channel, reading each channel's ghost ring (every channel
  needs one: outflows are evaluated on ghost cells); the cells' coordinates
  are global, the shard's origin plus the local index.
- Launches are counted, per stepper (``PallasFieldStep.launches``) and
  module-wide (``launches()`` for K4, ``halo_launches()`` for K4-halo), only
  where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence

import torch

from ..core.cell import MOORE_OFFSETS
from .field_lower import (MAX_CHANNELS, MAX_CODE, FieldProgram,
                          check_program, lower_flows)
from .flow import build_outflow
from .fused_stencil import (KERNEL_DTYPES, RING_PIECES, check_nsteps,
                            check_offsets, check_ring, check_ring_depth,
                            pad_from_ring, padded_region, resolve_block)
from .stencil import neighbor_counts, transport

TILE_W = 128
TILE_HEIGHTS = (32, 16, 8)
#: shared memory one block may use on the H100 (sm_90)
SMEM_LIMIT = 232_448
MAX_OFFSETS = 8
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


def smem_bytes(n_chan: int, n_out: int, n_slots: int, nsteps: int,
               tile_h: int) -> int:
    """Shared memory of one block: ``n_chan`` value windows, ``n_out``
    outflow windows and ``max(n_slots, 1)`` slot windows (the first is
    also the share buffer), f32."""
    return ((n_chan + n_out + max(n_slots, 1)) * (tile_h + 2 * nsteps)
            * (TILE_W + 2 * nsteps) * 4)


def pick_tile_h(n_chan: int, n_out: int, n_slots: int,
                nsteps: int) -> Optional[int]:
    """The tallest tile whose block fits ``SMEM_LIMIT``; None if none."""
    for th in TILE_HEIGHTS:
        if smem_bytes(n_chan, n_out, n_slots, nsteps, th) <= SMEM_LIMIT:
            return th
    return None


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


def plan_field(flows, names: Sequence[str], shape: tuple[int, int], dtype,
               nsteps: int, block: Optional[tuple[int, int]] = None
               ) -> tuple[FieldProgram, int]:
    """Everything K4 decides before a call, from static facts only: the
    lowered program and the tile height. Raises
    ``FieldPlanError`` when the flows cannot be lowered, exceed the program
    limits, need more steps than the ghost depth or more shared memory
    than a block has."""
    try:
        check_pointwise(flows)
        prog = lower_flows(flows, names)
        check_program(prog)
        check_nsteps(int(nsteps), resolve_block(tuple(shape), dtype, block),
                     dtype)
    except ValueError as e:
        raise FieldPlanError(str(e)) from e
    sizes = (len(prog.channels), len(prog.outputs), prog.n_slots,
             int(nsteps))
    th = pick_tile_h(*sizes)
    if th is None:
        raise FieldPlanError(
            f"the field kernel's block needs {smem_bytes(*sizes, 8)} bytes "
            f"of shared memory even at tile height 8 ({sizes[0]} loaded and "
            f"{sizes[1]} written channels, {prog.n_slots} slots, "
            f"nsteps={nsteps}), over the {SMEM_LIMIT} bytes a block may "
            "use; use fewer substeps or impl='xla'")
    return prog, th


def field_step_plain(values: Mapping[str, torch.Tensor], flows,
                     offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                     nsteps: int = 1, origin: tuple[int, int] = (0, 0),
                     global_shape: Optional[tuple[int, int]] = None
                     ) -> dict[str, torch.Tensor]:
    """The plain torch version of K4: every floating channel cast to f32
    once, ``nsteps`` steps of ``build_outflow`` + ``transport`` (the plain
    model step), each written channel cast back once. bf16 is thus rounded
    once per call, as the kernel (and the TPU kernel) does; modulator-only
    channels come back as the same tensors."""
    offsets = check_offsets(offsets)
    first = next(iter(values.values()))
    shape = tuple(first.shape[-2:])
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
                          nsteps: int = 1) -> dict[str, torch.Tensor]:
    """The plain torch version of K4-halo: every channel's padded shard from
    its ring, floating channels cast to f32 once, masked to the grid;
    ``nsteps`` steps of ``build_outflow`` (at the padded shard's global
    origin, outflows zero off the grid) + ``transport`` (counts from global
    coordinates, off-grid cells re-zeroed); the shard cropped out and each
    written channel cast back once. Modulator-only channels come back as the
    same tensors. Shards stepped so and put together equal
    ``field_step_plain`` on the whole grid bit for bit."""
    offsets = check_offsets(offsets)
    first = next(iter(values.values()))
    h, w = first.shape
    d = int(next(iter(rings.values()))["n"].shape[0])
    org, mask, counts = padded_region(first, rings[next(iter(values))],
                                      origin, global_shape, offsets)
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


class _FieldArgs(ctypes.Structure):
    """``FieldArgs`` of ``csrc/field_stencil.cu``, field for field."""

    _fields_ = [
        ("inp", ctypes.c_void_p * MAX_CHANNELS),
        ("out", ctypes.c_void_p * MAX_CHANNELS),
        ("out_chan", ctypes.c_int * MAX_CHANNELS),
        ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("nsteps", ctypes.c_int), ("tile_h", ctypes.c_int),
        ("n_chan", ctypes.c_int), ("n_out", ctypes.c_int),
        ("n_slots", ctypes.c_int), ("n_off", ctypes.c_int),
        ("n_code", ctypes.c_int), ("pad_", ctypes.c_int),
        ("off_dx", ctypes.c_int * MAX_OFFSETS),
        ("off_dy", ctypes.c_int * MAX_OFFSETS),
        ("op", ctypes.c_int * MAX_CODE),
        ("dst", ctypes.c_int * MAX_CODE),
        ("first", ctypes.c_int * MAX_CODE),
        ("a_kind", ctypes.c_int * MAX_CODE),
        ("a_arg", ctypes.c_int * MAX_CODE),
        ("b_kind", ctypes.c_int * MAX_CODE),
        ("b_arg", ctypes.c_int * MAX_CODE),
        ("a_imm", ctypes.c_float * MAX_CODE),
        ("b_imm", ctypes.c_float * MAX_CODE),
    ]


class _FieldHalo(ctypes.Structure):
    """``FieldHalo`` of ``csrc/field_stencil.cu``, field for field."""

    _fields_ = [
        ("ring", (ctypes.c_void_p * 8) * MAX_CHANNELS),
        ("d", ctypes.c_int), ("R0", ctypes.c_int), ("C0", ctypes.c_int),
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("pad_", ctypes.c_int),
    ]


def pack_program(prog: FieldProgram, offsets: tuple, nsteps: int,
                 tile_h: int, shape: tuple[int, int]) -> _FieldArgs:
    """The launch argument for ``prog``, without its pointers (the
    constants rounded to f32 here, as the kernel computes)."""
    a = _FieldArgs()
    a.H, a.W = int(shape[0]), int(shape[1])
    a.nsteps, a.tile_h = int(nsteps), int(tile_h)
    a.n_chan, a.n_out = len(prog.channels), len(prog.outputs)
    a.n_slots, a.n_off = prog.n_slots, len(offsets)
    a.n_code = len(prog.code)
    for o, name in enumerate(prog.outputs):
        a.out_chan[o] = prog.channels.index(name)
    for d, (dx, dy) in enumerate(offsets):
        a.off_dx[d], a.off_dy[d] = dx, dy
    for pc, (op, dst, first, (ak, aa, ai), (bk, ba, bi)) in enumerate(
            prog.code):
        a.op[pc], a.dst[pc], a.first[pc] = op, dst, first
        a.a_kind[pc], a.a_arg[pc], a.a_imm[pc] = ak, aa, ai
        a.b_kind[pc], a.b_arg[pc], a.b_imm[pc] = bk, ba, bi
    return a


def _kernel_lib():
    from ._build import load

    lib = load("field_stencil")
    if not getattr(lib, "_mm_typed", False):
        for fn in (lib.mm_field_stencil_f32, lib.mm_field_stencil_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.mm_field_halo_f32, lib.mm_field_halo_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mm_field_args_size.restype = ctypes.c_int
        lib.mm_field_halo_size.restype = ctypes.c_int
        lib.mm_field_error_string.argtypes = [ctypes.c_int]
        lib.mm_field_error_string.restype = ctypes.c_char_p
        if lib.mm_field_args_size() != ctypes.sizeof(_FieldArgs):
            raise RuntimeError(
                f"field_stencil's FieldArgs is {lib.mm_field_args_size()} "
                f"bytes, the wrapper's {ctypes.sizeof(_FieldArgs)}")
        if lib.mm_field_halo_size() != ctypes.sizeof(_FieldHalo):
            raise RuntimeError(
                f"field_stencil's FieldHalo is {lib.mm_field_halo_size()} "
                f"bytes, the wrapper's {ctypes.sizeof(_FieldHalo)}")
        lib._mm_typed = True
    return lib


def _launch(args: _FieldArgs, dtype, device,
            stepper: Optional["PallasFieldStep"] = None,
            halo: Optional[_FieldHalo] = None) -> None:
    """Launch K4 (or K4-halo, given ``halo``) on the current stream; raises
    on any launch error. Counts the launch, module-wide and on ``stepper``,
    once the kernel is queued. An empty grid has nothing to compute: no
    launch, nothing counted."""
    global _launch_count, _halo_launch_count
    if args.H == 0 or args.W == 0:
        return
    lib = _kernel_lib()
    f32 = dtype == torch.float32
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if halo is None:
            fn = lib.mm_field_stencil_f32 if f32 else lib.mm_field_stencil_bf16
            err = fn(ctypes.addressof(args), stream)
        else:
            fn = lib.mm_field_halo_f32 if f32 else lib.mm_field_halo_bf16
            err = fn(ctypes.addressof(args), ctypes.addressof(halo), stream)
    if err != 0:
        raise RuntimeError(
            f"field_stencil {'halo ' if halo is not None else ''}kernel "
            f"launch failed: {lib.mm_field_error_string(err).decode()} "
            f"(cudaError {err})")
    if halo is None:
        _launch_count += 1
    else:
        _halo_launch_count += 1
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
    ``launches`` counts the kernel launches this stepper made."""

    def __init__(self, shape: tuple[int, int], flows, dtype=torch.float32,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                 block: Optional[tuple[int, int]] = None,
                 nsteps: int = 1, compute_dtype=None,
                 names: Optional[Sequence[str]] = None):
        check_pointwise(flows)  # JAX's error, before any planning
        if compute_dtype not in (None, torch.float32, "float32"):
            raise NotImplementedError(
                "compute_dtype other than float32 (bf16 interior math) is "
                "not ported yet; see ROADMAP.md")
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
        #: the program and tile height planned at construction (``names``)
        self.program: Optional[FieldProgram] = None
        self.tile_h: Optional[int] = None
        if names is not None:
            self.program, self.tile_h = self.plan(tuple(names), dtype)

    def plan(self, names: tuple, dtype) -> tuple[FieldProgram, int]:
        """The lowered program and tile height for these channels."""
        key = (names, dtype)
        if key not in self._plans:
            self._plans[key] = plan_field(self.flows, names, self.shape,
                                          dtype, self.nsteps, self.block)
        return self._plans[key]

    def _checked(self, values: Mapping[str, torch.Tensor]):
        """The call's plan from its channels: (program, tile height, dtype,
        the loaded channels' tensors, their device). Raises on channels the
        flows need but the values lack, on flow channels not of one kernel
        dtype, and on loaded channels of another dtype or shape."""
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
        prog, tile_h = self.plan(names, dtype)
        chans = [values[n] for n in prog.channels]
        for n, t in zip(prog.channels, chans):
            if t.dtype != dtype or tuple(t.shape) != self.shape:
                raise ValueError(
                    f"channel {n!r} is {t.dtype} {tuple(t.shape)}; the field "
                    f"kernel needs every channel it reads as {dtype} "
                    f"{self.shape}")
        return prog, tile_h, dtype, chans, chans[0].device

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
        prog, tile_h, dtype, chans, dev = self._checked(values)
        if dev.type == "cpu":
            return self._copy_out(field_step_plain(
                values, self.flows, self.offsets, self.nsteps), out)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if any(t.device != dev or not t.is_contiguous() for t in chans):
            raise ValueError("every channel must be a contiguous tensor on "
                             "one device")
        outs = self._outputs(prog, values, dtype, dev, out, chans)
        args = pack_program(prog, self.offsets, self.nsteps, tile_h,
                            self.shape)
        for c, t in enumerate(chans):
            args.inp[c] = t.data_ptr()
        for o, n in enumerate(prog.outputs):
            args.out[o] = outs[n].data_ptr()
        _launch(args, dtype, dev, self)
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
        prog, tile_h, dtype, chans, dev = self._checked(values)
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
            return self._copy_out(field_halo_step_plain(
                values, rings, origin, global_shape, self.flows,
                self.offsets, self.nsteps), out)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        reads = list(chans) + [rings[n][p] for n in prog.channels
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
        outs = self._outputs(prog, values, dtype, dev, out, reads)
        args = pack_program(prog, self.offsets, self.nsteps, tile_h,
                            self.shape)
        for c, t in enumerate(chans):
            args.inp[c] = t.data_ptr()
        for o, n in enumerate(prog.outputs):
            args.out[o] = outs[n].data_ptr()
        hx = _FieldHalo()
        for c, n in enumerate(prog.channels):
            for i, p in enumerate(RING_PIECES):
                hx.ring[c][i] = rings[n][p].data_ptr()
        hx.d, hx.R0, hx.C0, hx.H, hx.W = d, R0, C0, H, W
        _launch(args, dtype, dev, self, halo=hx)
        return {**values, **outs}
