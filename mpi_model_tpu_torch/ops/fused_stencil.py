"""K1, the fused dense stencil: wrapper, checks and plain version.

Counterpart of ``mpi_model_tpu/ops/pallas_stencil.py`` in dense mode. The
kernel is ``csrc/fused_stencil.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); it replaces the TPU kernel ``pallas_stencil.py::_stencil_call``
(dense mode), runs ``nsteps`` uniform-rate transport steps per call in one
read and one write of device memory, and is bound by bytes for small
``nsteps`` (see the source's header for what its design does about that).

- A CPU tensor takes ``dense_step_plain``, the plain torch version.
- A CUDA tensor launches the kernel or raises; nothing falls back.
- Block and ``nsteps`` checks are the JAX package's, so both packages
  accept and refuse the same calls, although the CUDA kernel has no (8, 128)
  tiling of its own: ``nsteps <= min(sublane, bh, 128, bw)`` with sublane 8
  for f32 and 16 for bf16.
- Launches are counted, per stepper (``PallasDiffusionStep.launches``) and
  module-wide (``launches()``), only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core.cell import MOORE_OFFSETS

LANE = 128  # the JAX kernel's lane tile; kept for the same block checks

#: storage dtypes the kernel takes (it computes in f32)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_launch_count = 0


def launches() -> int:
    """Kernel launches made by this module since the last reset."""
    return _launch_count


def reset_launches() -> None:
    global _launch_count
    _launch_count = 0


def _sublane(dtype) -> int:
    return 16 if dtype == torch.bfloat16 else 8


def _pick_block(dim: int, preferred: int, align: int) -> int:
    """Largest divisor of `dim` <= preferred, a multiple of `align` when
    possible (the JAX package's block choice)."""
    best = None
    for b in range(min(dim, preferred), 0, -1):
        if dim % b == 0:
            if b % align == 0:
                return b
            if best is None:
                best = b
    return best or dim


def _validate_block(h: int, w: int,
                    block: tuple[int, int]) -> tuple[int, int]:
    """Clamp an oversized block to the grid, then require exact tiling."""
    bh = min(int(block[0]), h)
    bw = min(int(block[1]), w)
    if bh <= 0 or bw <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if h % bh or w % bw:
        raise ValueError(
            f"block {(bh, bw)} does not tile grid {(h, w)} exactly; pick "
            f"divisors of the grid dims (or pass block=None to auto-pick)")
    return bh, bw


def check_offsets(offsets: Sequence[tuple[int, int]]) -> tuple:
    """Validate a radius-1 neighborhood: unique (dx, dy) in {-1,0,1}^2,
    excluding (0,0)."""
    off = tuple((int(dx), int(dy)) for dx, dy in offsets)
    if not off:
        raise ValueError("offsets must be non-empty")
    if len(set(off)) != len(off):
        raise ValueError(f"duplicate offsets: {off}")
    for dx, dy in off:
        if (dx, dy) == (0, 0) or abs(dx) > 1 or abs(dy) > 1:
            raise ValueError(
                f"pallas stencil supports radius-1 neighborhoods only; "
                f"got offset {(dx, dy)}")
    return off


def resolve_block(shape: tuple[int, int], dtype,
                  block: Optional[tuple[int, int]] = None) -> tuple[int, int]:
    """The block the JAX package would use: validated, or auto-picked."""
    h, w = shape
    if block is None:
        return (_pick_block(h, 512, _sublane(dtype)), _pick_block(w, 512, LANE))
    return _validate_block(h, w, block)


def ghost_depth(shape: tuple[int, int], dtype,
                block: Optional[tuple[int, int]] = None) -> int:
    """Largest ``nsteps`` one call admits for this grid, dtype and block."""
    bh, bw = resolve_block(shape, dtype, block)
    return min(min(_sublane(dtype), bh), min(LANE, bw))


def check_nsteps(nsteps: int, block: tuple[int, int], dtype) -> None:
    bh, bw = block
    hr, hc = min(_sublane(dtype), bh), min(LANE, bw)
    if nsteps > min(hr, hc):
        raise ValueError(
            f"nsteps={nsteps} exceeds the window's ghost depth "
            f"min(hr={hr}, hc={hc}) for block {(bh, bw)} and dtype "
            f"{str(dtype).removeprefix('torch.')}; use nsteps <= "
            f"{min(hr, hc)} or a larger block")


def dense_step_plain(values: torch.Tensor, rate: float,
                     offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                     nsteps: int = 1) -> torch.Tensor:
    """The plain torch version of K1: cast to f32 once, run ``nsteps``
    exact steps (``share = rate*v/cnt``, ``v*(1-rate) + Σ_d share[c+d]`` in
    offset order, counts clamped to >= 1), cast back once. bf16 is thus
    rounded once per call, as the kernel (and the TPU kernel) does. Leading
    batch dimensions (``[..., H, W]``) step every grid independently."""
    h, w = values.shape[-2:]
    v = values.to(torch.float32)
    cnt = None
    rows = torch.arange(h, device=values.device)[:, None]
    cols = torch.arange(w, device=values.device)[None, :]
    for dx, dy in offsets:
        ok = ((rows + dx >= 0) & (rows + dx < h)
              & (cols + dy >= 0) & (cols + dy < w)).to(torch.float32)
        cnt = ok if cnt is None else cnt + ok
    cnt = torch.clamp(cnt, min=1.0)
    padded = torch.zeros(values.shape[:-2] + (h + 2, w + 2),
                         dtype=torch.float32, device=values.device)
    for _ in range(nsteps):
        padded[..., 1:-1, 1:-1] = (rate * v) / cnt
        g = None
        for dx, dy in offsets:
            t = padded[..., 1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
            g = t if g is None else g + t
        v = v * (1.0 - rate) + g
    return v.to(values.dtype)


def _offset_mask(offsets: tuple) -> int:
    m = 0
    for dx, dy in offsets:
        m |= 1 << ((dx + 1) * 3 + (dy + 1))
    return m


def _offset_codes(offsets: tuple) -> int:
    """The offsets in their order, 4 bits each (bit index (dx+1)*3 +
    (dy+1)): the kernels sum a cell's shares in this order."""
    codes = 0
    for i, (dx, dy) in enumerate(offsets):
        codes |= ((dx + 1) * 3 + (dy + 1)) << (4 * i)
    return codes


def _kernel_lib():
    from ._build import load

    lib = load("fused_stencil")
    if not getattr(lib, "_mm_typed", False):
        for fn in (lib.mm_fused_stencil_f32, lib.mm_fused_stencil_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_float,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib._mm_typed = True
    return lib


def _launch(values: torch.Tensor, out: torch.Tensor, rate: float,
            offsets: tuple, nsteps: int,
            stepper: Optional["PallasDiffusionStep"] = None) -> None:
    """Launch K1 on the current stream; raises on any launch error. Counts
    the launch, module-wide and on ``stepper``, once the kernel is queued.
    An empty grid has nothing to compute: no launch, nothing counted."""
    global _launch_count
    if values.numel() == 0:
        return
    lib = _kernel_lib()
    fn = (lib.mm_fused_stencil_f32 if values.dtype == torch.float32
          else lib.mm_fused_stencil_bf16)
    h, w = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), out.data_ptr(), h, w, float(rate),
                 float(1.0 - rate), int(nsteps), _offset_mask(offsets),
                 len(offsets), _offset_codes(offsets), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_stencil kernel launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")
    _launch_count += 1
    if stepper is not None:
        stepper.launches += 1


def pallas_dense_step(
    values: torch.Tensor,
    rate: float,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    block: Optional[tuple[int, int]] = None,
    nsteps: int = 1,
    compute_dtype=None,
    out: Optional[torch.Tensor] = None,
    pipeline: Optional[bool] = None,
) -> torch.Tensor:
    """``nsteps`` fused dense flow steps in one device-memory round trip:
    every cell sheds ``rate * value`` split equally among its in-bounds
    neighbors, ``nsteps`` times. The name is the JAX package's, so a parity
    test can be one parametrization across both packages.

    ``pipeline=True`` takes the pipelined-window kernel K5
    (``ops.pipeline_stencil``, the ensemble engine's), with the JAX
    package's checks: a grid (and any explicit block) that cuts into
    16-row/128-column strips, ``nsteps <= 8``; it also takes a
    ``[B, H, W]`` batch.

    ``out`` (CUDA only) is a preallocated tensor of the input's shape and
    dtype that receives the result; it must not alias ``values``."""
    if pipeline:
        from .pipeline_stencil import pipeline_dense_step

        _check_compute_dtype(compute_dtype)
        return pipeline_dense_step(values, rate, offsets, block, nsteps, out)
    return _dense_step(values, rate, offsets, block, nsteps, compute_dtype,
                       out)


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            "compute_dtype other than float32 (bf16 interior math) is not "
            "ported yet; see ROADMAP.md")


def _dense_step(values, rate, offsets, block, nsteps, compute_dtype, out,
                stepper: Optional["PallasDiffusionStep"] = None):
    offsets = check_offsets(offsets)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    _check_compute_dtype(compute_dtype)
    if values.dim() != 2:
        raise ValueError(f"values must be [H, W], got shape "
                         f"{tuple(values.shape)}")
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the fused stencil takes float32 or bfloat16 grids, got "
            f"{values.dtype}; float64 stays on the plain path "
            "(impl='xla')")
    h, w = values.shape
    blk = resolve_block((h, w), values.dtype, block)
    check_nsteps(int(nsteps), blk, values.dtype)
    if values.device.type == "cpu":
        res = dense_step_plain(values, rate, offsets, int(nsteps))
        if out is not None:
            out.copy_(res)
            return out
        return res
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if out is None:
        out = torch.empty_like(values)
    elif (out.shape != values.shape or out.dtype != values.dtype
          or out.device != values.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor of the input's "
                         "shape, dtype and device")
    elif out.data_ptr() == values.data_ptr():
        raise ValueError("the kernel is out of place: out must not alias "
                         "values")
    _launch(values, out, rate, offsets, int(nsteps), stepper)
    return out


class PallasDiffusionStep:
    """Reusable stepper bound to one grid geometry and rate; each call
    performs ``nsteps`` fused flow steps. ``launches`` counts the kernel
    launches this stepper made."""

    def __init__(self, shape: tuple[int, int], rate: float,
                 dtype=torch.float32,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                 block: Optional[tuple[int, int]] = None,
                 nsteps: int = 1, compute_dtype=None):
        self.shape = tuple(shape)
        self.rate = float(rate)
        self.dtype = dtype
        self.offsets = check_offsets(offsets)
        self.block = block
        self.nsteps = int(nsteps)
        self.compute_dtype = compute_dtype
        self.launches = 0

    def __call__(self, values: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _dense_step(values, self.rate, self.offsets, self.block,
                           self.nsteps, self.compute_dtype, out, self)
