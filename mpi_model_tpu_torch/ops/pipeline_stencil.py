"""K5, the pipelined-window dense stencil: wrapper, checks and plain version.

Counterpart of ``mpi_model_tpu/ops/pallas_stencil.py:560-750``
(``_pipeline_blocks``, ``_pipeline_call``, ``_pallas_pipeline_step``). The
kernel is ``csrc/pipeline_stencil.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); it replaces the TPU kernel ``_pipeline_call``, which the JAX
package reaches only through ``pallas_dense_step(pipeline=True)`` from the
ensemble engine (``EnsembleExecutor(impl="pipeline")``).

- It takes ``[H, W]`` or ``[B, H, W]`` (f32 or bf16) and advances every
  lane ``nsteps <= 8`` steps in one launch, choosing per TPU tile of
  ``(BR, BC)`` cells between the exact masked path (tiles near the grid's
  edge) and the closed form (the others). The grid must cut into 16-row /
  128-column strips (``_pipeline_blocks``), as on the TPU.
- A CPU tensor takes ``pipeline_step_plain``; a CUDA tensor launches the
  kernel or raises. Nothing falls back.
- ``launches()`` counts kernel launches, one per call whatever ``B`` is.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.cell import MOORE_OFFSETS
from .fused_stencil import KERNEL_DTYPES, _offset_codes, _offset_mask, \
    _validate_block, check_offsets, dense_step_plain

#: row/col strip granularities of the pipelined window (the TPU's 16-row
#: bf16 sublane tile and 128-lane tile); the CUDA tile divides both
_STRIP_R = 16
_STRIP_C = 128
#: most fused steps one call admits (the TPU kernel's 8-deep strips)
MAX_STEPS = 8
_launch_count = 0


def launches() -> int:
    """Kernel launches made by this module since the last reset."""
    return _launch_count


def reset_launches() -> None:
    global _launch_count
    _launch_count = 0


def _pipeline_blocks(h: int, w: int) -> Optional[tuple[int, int]]:
    """(BR, BC) for the pipelined kernel, or None when the grid can't host
    it: BR | h with BR % 16 == 0 (BR <= 512), BC | w with BC % 128 == 0
    (BC <= 2048). The JAX package's choice, so both pick the same tiles."""
    def pick(dim, pref, align):
        for b in range(min(dim, pref), align - 1, -1):
            if dim % b == 0 and b % align == 0:
                return b
        return None

    br = pick(h, 512, _STRIP_R)
    bc = pick(w, 2048, _STRIP_C)
    if br is None or bc is None:
        return None
    return br, bc


def pipeline_block(shape: tuple[int, int], nsteps: int,
                   block: Optional[tuple[int, int]] = None
                   ) -> tuple[int, int]:
    """The TPU tile a call uses, with the JAX package's checks and text: an
    explicit block is honoured when it cuts into strips, else the grid's
    ``_pipeline_blocks``; ``nsteps <= 8``."""
    h, w = shape
    if block is not None:
        bh, bw = _validate_block(h, w, block)
        pipe_block = ((bh, bw)
                      if bh % _STRIP_R == 0 and bw % _STRIP_C == 0 else None)
    else:
        pipe_block = _pipeline_blocks(h, w)
    if pipe_block is None or nsteps > MAX_STEPS:
        raise ValueError(
            f"pipeline=True needs a grid (and any explicit block) "
            f"divisible into 16-row/128-col strips and nsteps <= 8; "
            f"got {(h, w)} block={block} nsteps={nsteps}")
    return pipe_block


def _constants(rate: float, offsets: tuple) -> tuple[bool, float, float]:
    """(is_moore, a, b) of the closed form ``v*a + Σ*b``, formed in f64 as
    the TPU kernel's Python floats are; the kernel and the plain version
    round each to f32 once."""
    k = float(len(offsets))
    moore = set(offsets) == set(MOORE_OFFSETS)
    a = 1.0 - rate - rate / k if moore else 1.0 - rate
    return moore, a, rate / k


def interior_mask(shape: tuple[int, int], block: tuple[int, int],
                  nsteps: int, device=None) -> torch.Tensor:
    """``[H, W]`` bool: True on cells of TPU tiles that take the closed form
    (no edge within ``nsteps`` of the tile's window)."""
    (h, w), (br, bc) = shape, block
    r0 = torch.arange(h, device=device) // br * br
    c0 = torch.arange(w, device=device) // bc * bc
    row_ok = (r0 > nsteps) & (r0 + br < h - nsteps)
    col_ok = (c0 > nsteps) & (c0 + bc < w - nsteps)
    return row_ok[:, None] & col_ok[None, :]


def _closed_steps(v: torch.Tensor, rate: float, offsets: tuple,
                  nsteps: int) -> torch.Tensor:
    """``nsteps`` closed-form steps over the whole f32 grid (zeros outside),
    in the TPU kernel's order. Right only on interior tiles."""
    moore, a, b = _constants(rate, offsets)
    h, w = v.shape[-2:]
    cur = v
    for _ in range(nsteps):
        p = F.pad(cur, (1, 1, 1, 1))
        if moore:
            band = p[..., 0:h, :] + p[..., 1:h + 1, :] + p[..., 2:h + 2, :]
            g = band[..., 0:w] + band[..., 1:w + 1] + band[..., 2:w + 2]
        else:
            g = None
            for dx, dy in offsets:
                t = p[..., 1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
                g = t if g is None else g + t
        cur = cur * a + g * b
    return cur


def pipeline_step_plain(values: torch.Tensor, rate: float,
                        offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                        nsteps: int = 1,
                        block: Optional[tuple[int, int]] = None
                        ) -> torch.Tensor:
    """The plain torch version of K5 on ``[H, W]`` or ``[B, H, W]``: cast to
    f32 once; run ``nsteps`` steps of both forms over the whole grid, the
    exact masked path (``dense_step_plain``) and the closed form; keep the
    closed form on interior TPU tiles and the exact path elsewhere; cast
    back once.

    Why the whole-grid closed form is the tile's: after ``n`` steps a cell
    depends only on the cells within ``n`` of it (its dependency cone). An
    interior tile's cone, its cells and everything within ``n`` of them,
    lies inside the grid and off its outer ring (the near test), so the
    tile's own window holds the whole cone, the zeros outside the grid never
    enter it, and the whole-grid iteration does, cell for cell, the
    arithmetic the tile does on its window. (Off the ring every cell has its
    full neighbourhood, which is why the closed form is the exact step
    there.) The two forms round differently, so which one a cell takes is
    decided by its TPU tile, as the kernel decides it."""
    offsets = check_offsets(offsets)
    h, w = values.shape[-2:]
    blk = pipeline_block((h, w), int(nsteps), block)
    v = values.to(torch.float32)
    out = dense_step_plain(v, rate, offsets, int(nsteps))
    inside = interior_mask((h, w), blk, int(nsteps), values.device)
    if bool(inside.any()):
        out = torch.where(inside, _closed_steps(v, rate, offsets,
                                                int(nsteps)), out)
    return out.to(values.dtype)


def _kernel_lib():
    from ._build import load

    lib = load("pipeline_stencil")
    if not getattr(lib, "_mm_typed", False):
        for fn in (lib.mm_pipeline_stencil_f32, lib.mm_pipeline_stencil_bf16):
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 6 + [ctypes.c_float] * 4
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib._mm_typed = True
    return lib


def _launch(values: torch.Tensor, out: torch.Tensor, rate: float,
            offsets: tuple, nsteps: int, block: tuple[int, int]) -> None:
    """Launch K5 on the current stream over every lane; raises on any launch
    error; counts the launch once the kernel is queued. An empty batch has
    nothing to compute: no launch, nothing counted."""
    global _launch_count
    if values.numel() == 0:
        return
    lib = _kernel_lib()
    fn = (lib.mm_pipeline_stencil_f32 if values.dtype == torch.float32
          else lib.mm_pipeline_stencil_bf16)
    h, w = values.shape[-2:]
    b = values.numel() // (h * w)
    br, bc = block
    moore, a, cb = _constants(rate, offsets)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), out.data_ptr(), b, h, w, br, bc,
                 32 if br % 32 == 0 else 16, float(rate), float(1.0 - rate),
                 float(a), float(cb), int(nsteps), _offset_mask(offsets),
                 len(offsets), _offset_codes(offsets), int(moore), stream)
    if err != 0:
        raise RuntimeError(
            f"pipeline_stencil kernel launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")
    _launch_count += 1


def pipeline_dense_step(values: torch.Tensor, rate: float,
                        offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                        block: Optional[tuple[int, int]] = None,
                        nsteps: int = 1,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nsteps`` fused steps of every lane of ``values`` (``[H, W]`` or
    ``[B, H, W]``) in one call: the semantics of ``pallas_dense_step``, the
    TPU tiles of ``pipeline_block``. ``out`` (CUDA only) is a preallocated
    tensor of the input's shape and dtype that receives the result; it must
    not alias ``values`` (the kernel is out of place)."""
    offsets = check_offsets(offsets)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    if values.dim() not in (2, 3):
        raise ValueError(f"values must be [H, W] or [B, H, W], got shape "
                         f"{tuple(values.shape)}")
    h, w = values.shape[-2:]
    blk = pipeline_block((h, w), int(nsteps), block)
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the pipelined stencil takes float32 or bfloat16 grids, got "
            f"{values.dtype}; float64 stays on the plain path (impl='xla')")
    if values.device.type == "cpu":
        res = pipeline_step_plain(values, rate, offsets, int(nsteps), blk)
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
    _launch(values, out, rate, offsets, int(nsteps), blk)
    return out
