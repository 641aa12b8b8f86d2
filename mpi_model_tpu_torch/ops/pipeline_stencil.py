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
- The kernel steps windows of ``window_rows`` x 256 cells, each writing at
  most ``(rows - 2n) x (256 - 2n)`` outputs of one TPU tile
  (``launch_windows`` lists them, with the form each takes).
- ``compute_dtype=torch.bfloat16``: the closed-form tiles compute in bf16
  (``fused_stencil.closed_steps_bf16``), at every ``nsteps``; the near
  tiles keep the plain f32 exact path, as the TPU kernel's do. Where
  ``_pipeline_blocks`` leaves no closed tile (8 × 4096²) the knob changes
  nothing. Moore in its row-major order (``two_launches``) is then two
  kernels on the caller's stream, each writing only its own cells: the near
  launch over the windows of the near TPU tiles (``near_launch_windows``)
  and the paired launch over each lane's rectangle of closed tiles
  (``fused_stencil.bf16_rect``, tiled from its origin at ``paired_rows``:
  ``paired_tiles``); a lane with no closed tile makes the near launch alone.
  ``plan_of`` is the geometry these mirrors give a call, ``kernel_plan``
  the source's own.
- A CPU tensor takes ``pipeline_step_plain``; a CUDA tensor launches the
  kernel or raises. Nothing falls back.
- ``launches()`` counts calls that launched, one per call whatever ``B`` is
  (the two kernels of a bf16-interior call count once).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core.cell import MOORE_OFFSETS
from ._build import KernelError
from .seam import plain_version
from .fused_stencil import KERNEL_DTYPES, _offset_codes, _offset_mask, \
    _validate_block, bf16_rect, check_offsets, closed_constants, \
    closed_steps_bf16, closed_steps_plain, exact_dense_step_plain, \
    paired_rows, rb, region_tiles, resolve_compute_dtype, round_bf16

#: row/col strip granularities of the pipelined window (the TPU's 16-row
#: bf16 sublane tile and 128-lane tile); the CUDA tile divides both
_STRIP_R = 16
_STRIP_C = 128
#: most fused steps one call admits (the TPU kernel's 8-deep strips)
MAX_STEPS = 8
#: columns of the kernel's window (8 warps, one column a thread)
WINDOW_COLS = 256
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


def window_rows(offsets: Sequence[tuple[int, int]], nsteps: int) -> int:
    """The kernel's window rows for a call (``csrc/pipeline_stencil.cu``
    ``rows_for``): 64 for Moore in its row-major order above 2 steps, else
    48."""
    return 64 if tuple(offsets) == MOORE_OFFSETS and nsteps > 2 else 48


def launch_windows(shape: tuple[int, int], block: tuple[int, int],
                   nsteps: int, offsets: Sequence[tuple[int, int]]
                   = MOORE_OFFSETS) -> list[tuple]:
    """The windows one lane of a launch steps, in the kernel's order:
    ``(r0, r1, c0, c1, near, inner)``, the output rows ``[r0, r1)`` and
    columns ``[c0, c1)`` the window writes, whether its TPU tile takes the
    exact path (``near``), and whether every output lies more than
    ``nsteps`` from the global edge (``inner``: the exact path's full
    count). The windows restart at each TPU tile, so a window's outputs lie
    in one TPU tile."""
    (h, w), (br, bc), n = shape, block, int(nsteps)
    oh = window_rows(offsets, n) - 2 * n
    ow = WINDOW_COLS - 2 * n
    out = []
    for g_r0 in range(0, h, br):
        for q_r in range(-(-br // oh)):
            r0 = g_r0 + q_r * oh
            r1 = min(r0 + oh, g_r0 + br)
            for g_c0 in range(0, w, bc):
                near = (g_r0 <= n or g_r0 + br >= h - n or g_c0 <= n
                        or g_c0 + bc >= w - n)
                for q_c in range(-(-bc // ow)):
                    c0 = g_c0 + q_c * ow
                    c1 = min(c0 + ow, g_c0 + bc)
                    inner = (r0 >= n + 1 and r1 <= h - 1 - n
                             and c0 >= n + 1 and c1 <= w - 1 - n)
                    out.append((r0, r1, c0, c1, near, inner))
    return out


def two_launches(offsets: Sequence[tuple[int, int]], compute_dtype) -> bool:
    """Whether a call is the bf16 interior math's two launches: bf16
    compute with Moore in its row-major order (``MOORE_OFFSETS``); other
    calls are one launch of the kernel with both branches."""
    return (resolve_compute_dtype(compute_dtype) is not None
            and tuple(offsets) == MOORE_OFFSETS)


def near_tiles(shape: tuple[int, int], block: tuple[int, int],
               nsteps: int) -> list[tuple[int, int]]:
    """The near launch's TPU tiles of one lane, ``(row, column)`` of each
    tile's first cell, in the kernel's order (``NearTiles``): the tiles off
    ``bf16_rect`` as four bands (top, bottom, left, right), each row by
    row; with no closed tile, every tile."""
    (h, w), (br, bc) = shape, block
    r0, r1, c0, c1 = bf16_rect(shape, block, nsteps)
    if r0 >= r1:
        r0 = r1 = 0
    bands = ([(0, h, 0, w)] if r0 == r1 else
             [(0, r0, 0, w), (r1, h, 0, w), (r0, r1, 0, c0),
              (r0, r1, c1, w)])
    return [(a, b) for ra, rb_, ca, cb in bands
            for a in range(ra, rb_, br) for b in range(ca, cb, bc)]


def near_launch_windows(shape: tuple[int, int], block: tuple[int, int],
                        nsteps: int) -> list[tuple]:
    """The near launch's windows of one lane in block order: the windows
    ``launch_windows`` lists for each near TPU tile (``near_tiles``), tile
    by tile."""
    br, bc = block
    by_tile: dict[tuple[int, int], list] = {}
    for w in launch_windows(shape, block, nsteps):
        if w[4]:
            by_tile.setdefault((w[0] // br * br, w[2] // bc * bc), []).append(
                w)
    return [w for t in near_tiles(shape, block, nsteps) for w in by_tile[t]]


def paired_tiles(shape: tuple[int, int], block: tuple[int, int],
                 nsteps: int) -> list[tuple]:
    """The paired launch's tiles of one lane in block order: the rectangle
    of closed tiles (``bf16_rect``) tiled from its origin at
    ``paired_rows`` (K1's ``region_tiles``), each ``(r0, r1, c0, c1)``."""
    rect = bf16_rect(shape, block, nsteps)
    return region_tiles(rect, paired_rows(nsteps, MOORE_OFFSETS), nsteps)


def plan_of(shape: tuple[int, int], block: tuple[int, int], nsteps: int,
            offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
            compute_dtype=None) -> tuple:
    """The geometry of a call on one lane as these mirrors give it, in
    ``kernel_plan``'s layout: (two launches, the near or only launch's
    rows and blocks, the paired launch's rows and tiles, the rectangle's
    rows and columns, the near TPU tiles)."""
    n = int(nsteps)
    if not two_launches(offsets, compute_dtype):
        return (0, window_rows(offsets, n),
                len(launch_windows(shape, block, n, offsets)),
                0, 0, 0, 0, 0, 0, 0)
    tiles = paired_tiles(shape, block, n)
    rect = bf16_rect(shape, block, n) if tiles else (0, 0, 0, 0)
    return (1, window_rows(MOORE_OFFSETS, n),
            len(near_launch_windows(shape, block, n)),
            paired_rows(n, MOORE_OFFSETS), len(tiles), *rect,
            len(near_tiles(shape, block, n)))


def kernel_plan(shape: tuple[int, int], block: tuple[int, int], nsteps: int,
                offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                compute_dtype=None) -> tuple:
    """The geometry the CUDA source gives a call (``mm_pipeline_plan``, in
    ``plan_of``'s layout). It launches nothing but needs the built library
    (the card): tests and ``chip_smoke.py`` hold ``plan_of`` to it."""
    offsets = check_offsets(offsets)
    lib = _kernel_lib()
    fn = lib.mm_pipeline_plan
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 10)()
    moore, _, _ = closed_constants(0.1, offsets)
    err = fn(
        shape[0], shape[1], block[0], block[1], int(nsteps),
        _offset_mask(offsets), len(offsets), _offset_codes(offsets),
        int(moore), int(resolve_compute_dtype(compute_dtype) is not None),
        out)
    if err != 0:
        raise ValueError(f"mm_pipeline_plan refused {shape} block {block} "
                         f"nsteps={nsteps}: "
                         f"{lib.mm_cuda_error_string(err).decode()}")
    return tuple(out)


def pipeline_step_plain(values: torch.Tensor, rate: float,
                        offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                        nsteps: int = 1,
                        block: Optional[tuple[int, int]] = None,
                        compute_dtype=None) -> torch.Tensor:
    """The plain torch version of K5 on ``[H, W]`` or ``[B, H, W]``: cast to
    f32 once; run ``nsteps`` steps of both forms over the whole grid, the
    exact masked path (``exact_dense_step_plain``) and the closed form
    (``closed_steps_plain``); keep the closed form on interior TPU tiles
    and the exact path elsewhere; cast back once.

    Why the whole-grid closed form is the tile's: after ``n`` steps a cell
    depends only on the cells within ``n`` of it (its dependency cone). An
    interior tile's cone, its cells and everything within ``n`` of them,
    lies inside the grid and off its outer ring (the near test), so the
    tile's own window holds the whole cone, the zeros outside the grid never
    enter it, and the whole-grid iteration does, cell for cell, the
    arithmetic the tile does on its window. (Off the ring every cell has its
    full neighbourhood, which is why the closed form is the exact step
    there.) The two forms round differently, so which one a cell takes is
    decided by its TPU tile, as the kernel decides it.

    ``compute_dtype=torch.bfloat16``: the closed tiles take
    ``closed_steps_bf16`` over the grid rounded to bf16; the near tiles
    are unchanged (plain f32)."""
    offsets = check_offsets(offsets)
    h, w = values.shape[-2:]
    blk = pipeline_block((h, w), int(nsteps), block)
    bf16 = resolve_compute_dtype(compute_dtype) is not None
    v = values.to(torch.float32)
    out = exact_dense_step_plain(v, rate, offsets, int(nsteps))
    inside = interior_mask((h, w), blk, int(nsteps), values.device)
    if bool(inside.any()):
        closed = (closed_steps_bf16(rb(v), rate, offsets, int(nsteps)) if bf16
                  else closed_steps_plain(v, rate, offsets, int(nsteps)))
        out = torch.where(inside, closed, out)
    return out.to(values.dtype)


def _kernel_lib():
    from ._build import load

    lib = load("pipeline_stencil")
    if not getattr(lib, "_mm_typed", False):
        for fn in (lib.mm_pipeline_stencil_f32, lib.mm_pipeline_stencil_bf16):
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                           + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mm_pipeline_rows.argtypes = [ctypes.c_int] * 3
        lib.mm_pipeline_rows.restype = ctypes.c_int
        lib.mm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib._mm_typed = True
    return lib


def _launch(values: torch.Tensor, out: torch.Tensor, rate: float,
            offsets: tuple, nsteps: int, block: tuple[int, int],
            bf16: bool = False) -> None:
    """Launch K5 on the current stream over every lane (a bf16-interior
    Moore call: its two kernels, ``two_launches``); raises on any launch
    error; counts the call once its kernels are queued. An empty batch has
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
    moore, a, cb = closed_constants(rate, offsets)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), out.data_ptr(), b, h, w, br, bc,
                 float(rate), float(1.0 - rate),
                 float(a), float(cb), int(nsteps), _offset_mask(offsets),
                 len(offsets), _offset_codes(offsets), int(moore), int(bf16),
                 round_bf16(a), round_bf16(cb), stream)
    if err != 0:
        raise KernelError(
            f"pipeline_stencil kernel launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")
    _launch_count += 1


def pipeline_dense_step(values: torch.Tensor, rate: float,
                        offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                        block: Optional[tuple[int, int]] = None,
                        nsteps: int = 1,
                        out: Optional[torch.Tensor] = None,
                        compute_dtype=None) -> torch.Tensor:
    """``nsteps`` fused steps of every lane of ``values`` (``[H, W]`` or
    ``[B, H, W]``) in one call: the semantics of ``pallas_dense_step``, the
    TPU tiles of ``pipeline_block``, bf16 closed tiles under
    ``compute_dtype=torch.bfloat16``. ``out`` (CUDA only) is a preallocated
    tensor of the input's shape and dtype that receives the result; it must
    not alias ``values`` (the kernel is out of place)."""
    offsets = check_offsets(offsets)
    bf16 = resolve_compute_dtype(compute_dtype) is not None
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
        res = plain_version("K5", pipeline_step_plain, values, rate,
                            offsets, int(nsteps), blk, compute_dtype)
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
    _launch(values, out, rate, offsets, int(nsteps), blk, bf16)
    return out
