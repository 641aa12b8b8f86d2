"""K4, the fused multi-channel field step: wrapper, checks and plain version.

Counterpart of ``mpi_model_tpu/ops/pallas_stencil.py``'s field kernel
(``_field_call`` in dense mode, ``PallasFieldStep``). The kernel is
``csrc/field_stencil.cu`` (CUDA C++ for sm_90a, loaded with ctypes): one
call runs ``nsteps`` steps of any set of pointwise field flows (``Coupled``,
user flows) over every channel they read or write, in one read and one
write of device memory. The flows reach it as programs in register form,
lowered once by ``ops.field_lower``.

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
- Launches are counted, per stepper (``PallasFieldStep.launches``) and
  module-wide (``launches()``), only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence

import torch

from ..core.cell import MOORE_OFFSETS
from .field_lower import (MAX_CHANNELS, MAX_CODE, FieldProgram,
                          check_program, lower_flows)
from .flow import build_outflow
from .fused_stencil import (KERNEL_DTYPES, check_nsteps, check_offsets,
                            resolve_block)
from .stencil import neighbor_counts, transport

TILE_W = 128
TILE_HEIGHTS = (32, 16, 8)
#: shared memory one block may use on the H100 (sm_90)
SMEM_LIMIT = 232_448
MAX_OFFSETS = 8
_launch_count = 0


def launches() -> int:
    """Kernel launches made by this module since the last reset."""
    return _launch_count


def reset_launches() -> None:
    global _launch_count
    _launch_count = 0


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
        lib.mm_field_args_size.restype = ctypes.c_int
        lib.mm_field_error_string.argtypes = [ctypes.c_int]
        lib.mm_field_error_string.restype = ctypes.c_char_p
        if lib.mm_field_args_size() != ctypes.sizeof(_FieldArgs):
            raise RuntimeError(
                f"field_stencil's FieldArgs is {lib.mm_field_args_size()} "
                f"bytes, the wrapper's {ctypes.sizeof(_FieldArgs)}")
        lib._mm_typed = True
    return lib


def _launch(args: _FieldArgs, dtype, device,
            stepper: Optional["PallasFieldStep"] = None) -> None:
    """Launch K4 on the current stream; raises on any launch error. Counts
    the launch, module-wide and on ``stepper``, once the kernel is queued.
    An empty grid has nothing to compute: no launch, nothing counted."""
    global _launch_count
    if args.H == 0 or args.W == 0:
        return
    lib = _kernel_lib()
    fn = (lib.mm_field_stencil_f32 if dtype == torch.float32
          else lib.mm_field_stencil_bf16)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(
            f"field_stencil kernel launch failed: "
            f"{lib.mm_field_error_string(err).decode()} (cudaError {err})")
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

    def __call__(self, values: Mapping[str, torch.Tensor],
                 out: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> dict[str, torch.Tensor]:
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
        dev = chans[0].device
        if dev.type == "cpu":
            res = field_step_plain(values, self.flows, self.offsets,
                                   self.nsteps)
            if out:
                for n, t in out.items():
                    t.copy_(res[n])
                    res[n] = t
            return res
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if any(t.device != dev or not t.is_contiguous() for t in chans):
            raise ValueError("every channel must be a contiguous tensor on "
                             "one device")
        outs = {}
        in_ptrs = {t.data_ptr() for t in chans}
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
        args = pack_program(prog, self.offsets, self.nsteps, tile_h,
                            self.shape)
        for c, t in enumerate(chans):
            args.inp[c] = t.data_ptr()
        for o, n in enumerate(prog.outputs):
            args.out[o] = outs[n].data_ptr()
        _launch(args, dtype, dev, self)
        return {**values, **outs}
