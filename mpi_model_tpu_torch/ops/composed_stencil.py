"""K3, the composed k-step dense filter, and K3-halo, its sharded form: tap
tables, checks, wrappers and plain versions (counterpart of
``mpi_model_tpu/ops/composed_stencil.py``).

For uniform-rate ``Diffusion`` the flow step on interior cells is a linear
operator ``S = (1 - rate) δ + (rate / k') N`` (``k' = |offsets|``, ``N`` the
neighbor sum), so k steps compose into ONE pass of the ``(2k+1)²`` tap table
of ``S^k`` on cells at distance > k from the global edge (k steps reach k
cells out, and each of those must have all its neighbors on the grid for
the one-step operator to be ``S`` there). Cells nearer the edge keep the
exact iterated path (K1's), where the per-cell divisor makes the operator
vary in space.

- ``composed_taps``: the f64 table, composed with numpy, cached by
  fingerprint and read-only; bitwise the JAX package's.
- ``composed_dense_step``: a CPU tensor takes ``composed_dense_step_plain``;
  a CUDA tensor launches ``csrc/composed_stencil.cu`` or raises. The table
  is cast to f32 and handed to the kernel at launch.
- ``variant`` accepts ``"auto"``, ``"vpu"`` and ``"mxu"`` with the JAX
  package's checks (``mxu`` needs a 128-aligned block width) and names the
  variant asked for; one CUDA-core tap loop computes every variant here
  (the tensor-core ``mxu`` form is ROADMAP work).
- ``composed_halo_step`` (K3-halo) is the same pass on one shard of a
  sharded grid, reading its depth->=k ghost ring; the interior/edge-band
  choice is made per cell from its global row and column, so shards put
  together take the whole-grid run's path for every cell.
- Launches are counted per stepper (``ComposedDiffusionStep.launches``) and
  module-wide (``launches()`` for K3, ``halo_launches()`` for K3-halo), only
  where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.cell import MOORE_OFFSETS
from .fused_stencil import (
    KERNEL_DTYPES,
    LANE,
    _offset_codes,
    _offset_mask,
    _pick_block,
    _sublane,
    _validate_block,
    check_nsteps,
    check_offsets,
    check_out,
    check_ring,
    check_ring_depth,
    exact_dense_step_plain,
    exact_steps_plain,
    halo_args,
    pad_from_ring,
    padded_region,
    resolve_block,
)

#: tap count from which ``variant="auto"`` names the MXU form (the JAX
#: package's break-even rule, kept so both packages resolve alike)
MXU_MIN_TAPS = 9

_launch_count = 0
_halo_launch_count = 0


def launches() -> int:
    """K3 launches made by this module since the last reset."""
    return _launch_count


def halo_launches() -> int:
    """K3-halo launches made by this module since the last reset."""
    return _halo_launch_count


def reset_launches() -> None:
    global _launch_count, _halo_launch_count
    _launch_count = 0
    _halo_launch_count = 0


# -- tap-table composition (cached by fingerprint) ---------------------------

_TAPS_CACHE: dict[tuple, np.ndarray] = {}
#: f32 device copies of the tables, by (fingerprint, device)
_DEVICE_TAPS: dict[tuple, torch.Tensor] = {}


def taps_fingerprint(rate: float, offsets: Sequence[tuple[int, int]],
                     k: int) -> tuple:
    """Hashable identity of a composed tap table (the cache key)."""
    return (float(rate), tuple((int(dx), int(dy)) for dx, dy in offsets),
            int(k))


def _conv2_full(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full 2-D convolution in f64."""
    ha, wa = a.shape
    hb, wb = b.shape
    out = np.zeros((ha + hb - 1, wa + wb - 1), np.float64)
    for p in range(ha):
        for q in range(wa):
            if a[p, q] != 0.0:
                out[p:p + hb, q:q + wb] += a[p, q] * b
    return out


def composed_taps(rate: float, offsets: Sequence[tuple[int, int]],
                  k: int) -> np.ndarray:
    """The ``(2k+1, 2k+1)`` f64 tap table of ``S^k``: the k-fold
    self-convolution of the one-step table (correlation with A then B is
    correlation with ``A * B``). Returns a cached read-only array."""
    offsets = check_offsets(offsets)
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    key = taps_fingerprint(rate, offsets, k)
    cached = _TAPS_CACHE.get(key)
    if cached is not None:
        return cached
    w1 = np.zeros((3, 3), np.float64)
    w1[1, 1] = 1.0 - float(rate)
    for dx, dy in offsets:
        w1[1 + dx, 1 + dy] += float(rate) / len(offsets)
    wk = w1
    for _ in range(k - 1):
        wk = _conv2_full(w1, wk)
    wk.setflags(write=False)
    _TAPS_CACHE[key] = wk
    return wk


def device_taps(rate: float, offsets, k: int, dtype,
                device) -> torch.Tensor:
    """``composed_taps`` cast to ``dtype`` on ``device``, cached."""
    key = (taps_fingerprint(rate, offsets, k), str(dtype), str(device))
    t = _DEVICE_TAPS.get(key)
    if t is None:
        t = torch.from_numpy(np.array(composed_taps(rate, offsets, k))).to(
            device=device, dtype=dtype).contiguous()
        _DEVICE_TAPS[key] = t
    return t


# -- variant and k selection -------------------------------------------------

def _resolve_variant(variant: str, k: int, bw: int) -> str:
    if variant not in ("auto", "vpu", "mxu"):
        raise ValueError(f"unknown composed variant {variant!r}")
    if variant == "auto":
        return ("mxu" if (2 * k + 1) >= MXU_MIN_TAPS and bw % LANE == 0
                else "vpu")
    return variant


def _check_mxu_width(variant: str, bw: int) -> None:
    if variant == "mxu" and bw % LANE != 0:
        raise ValueError(
            f"the MXU composed variant contracts per {LANE}-lane "
            f"output block; block width {bw} is not a multiple "
            f"of {LANE} (use variant='vpu' or a {LANE}-aligned "
            "block)")


def max_k(shape: tuple[int, int], dtype,
          block: Optional[tuple[int, int]] = None) -> int:
    """Deepest composable k for this geometry: the window's ghost depth
    ``min(hr, hc)`` (8 f32 / 16 bf16 at default blocks)."""
    h, w = shape
    sub = _sublane(dtype)
    if block is None:
        block = (_pick_block(h, 512, sub), _pick_block(w, 512, LANE))
    else:
        block = _validate_block(h, w, block)
    return min(sub, block[0], LANE, block[1])


def choose_k(substeps: int, shape: tuple[int, int], dtype,
             block: Optional[tuple[int, int]] = None) -> int:
    """Largest divisor of ``substeps`` the window geometry can compose."""
    substeps = int(substeps)
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    cap = max_k(shape, dtype, block)
    for k in range(min(substeps, cap), 0, -1):
        if substeps % k == 0:
            return k
    return 1


# -- the plain version -------------------------------------------------------

def composed_dense_step_plain(values: torch.Tensor, rate: float, k: int,
                              offsets: Sequence[tuple[int, int]]
                              = MOORE_OFFSETS) -> torch.Tensor:
    """The plain torch version of K3, in f32: cells within k of the global
    edge (distance <= k) take ``exact_dense_step_plain(..., k)`` (K1's
    iterated exact path); every other cell gets the ``(2k+1)²`` tap
    correlation with the f32 table, accumulated from zero in row-major tap
    order. Cast back to the storage dtype once."""
    offsets = check_offsets(offsets)
    k = int(k)
    h, w = values.shape
    v = values.to(torch.float32)
    out = exact_dense_step_plain(v, rate, offsets, k)
    m = k + 1  # the first row/column the composed operator is exact on
    ih, iw = h - 2 * m, w - 2 * m
    if ih > 0 and iw > 0:
        taps = device_taps(rate, offsets, k, torch.float32, values.device)
        n = 2 * k + 1
        acc = torch.zeros((ih, iw), dtype=torch.float32,
                          device=values.device)
        for dr in range(n):
            for dc in range(n):
                acc = acc + taps[dr, dc] * v[1 + dr:1 + dr + ih,
                                             1 + dc:1 + dc + iw]
        out[m:h - m, m:w - m] = acc
    return out.to(values.dtype)


def composed_halo_step_plain(values: torch.Tensor,
                             ring: Mapping[str, torch.Tensor],
                             origin: tuple[int, int],
                             global_shape: tuple[int, int], rate: float,
                             k: int,
                             offsets: Sequence[tuple[int, int]]
                             = MOORE_OFFSETS) -> torch.Tensor:
    """The plain torch version of K3-halo, in f32: the padded shard from the
    ring, masked to the grid; cells within k of the GLOBAL edge take
    ``halo_step_plain``'s iterated steps, every other cell the tap
    correlation accumulated from zero in row-major tap order, as
    ``composed_dense_step_plain`` does. Cast back once. Shards stepped so
    and put together equal ``composed_dense_step_plain`` bit for bit."""
    offsets = check_offsets(offsets)
    k = int(k)
    h, w = values.shape
    d = int(ring["n"].shape[0])
    org, mask, cnt = padded_region(values, ring, origin, global_shape,
                                   offsets)
    v = torch.where(mask, pad_from_ring(values, ring).to(torch.float32), 0.0)
    out = exact_steps_plain(v, cnt, rate, offsets, k, mask)[d:d + h,
                                                            d:d + w]
    taps = device_taps(rate, offsets, k, torch.float32, values.device)
    n = 2 * k + 1
    acc = torch.zeros((h, w), dtype=torch.float32, device=values.device)
    for dr in range(n):
        for dc in range(n):
            acc = acc + taps[dr, dc] * v[d - k + dr:d - k + dr + h,
                                         d - k + dc:d - k + dc + w]
    m = k + 1  # the first global row/column the composed operator holds on
    gh, gw = global_shape
    rows = org[0] + d + torch.arange(h, device=values.device)[:, None]
    cols = org[1] + d + torch.arange(w, device=values.device)[None, :]
    inner = (rows >= m) & (rows < gh - m) & (cols >= m) & (cols < gw - m)
    return torch.where(inner, acc, out).to(values.dtype)


# -- the kernel --------------------------------------------------------------

def _kernel_lib():
    from ._build import load

    lib = load("composed_stencil")
    if not getattr(lib, "_mm_typed", False):
        for fn in (lib.mm_composed_f32, lib.mm_composed_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.mm_composed_halo_f32, lib.mm_composed_halo_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_float, ctypes.c_float, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.mm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib._mm_typed = True
    return lib


def _launch(values: torch.Tensor, out: torch.Tensor, rate: float,
            offsets: tuple, k: int,
            stepper: Optional["ComposedDiffusionStep"] = None) -> None:
    """Launch K3 on the current stream; raises on any launch error. Counts
    the launch, module-wide and on ``stepper``, once the kernel is queued."""
    global _launch_count
    if values.numel() == 0:
        return
    lib = _kernel_lib()
    fn = (lib.mm_composed_f32 if values.dtype == torch.float32
          else lib.mm_composed_bf16)
    taps = device_taps(rate, offsets, k, torch.float32, values.device)
    h, w = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), out.data_ptr(), taps.data_ptr(), h, w,
                 float(rate), float(1.0 - rate), int(k),
                 _offset_mask(offsets), len(offsets), _offset_codes(offsets),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"composed_stencil kernel launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")
    _launch_count += 1
    if stepper is not None:
        stepper.launches += 1


def composed_dense_step(
    values: torch.Tensor,
    rate: float,
    k: int,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    block: Optional[tuple[int, int]] = None,
    variant: str = "auto",
    compute_dtype=None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``k`` uniform-rate flow steps as ONE composed-filter pass: the
    semantics of ``pallas_dense_step(values, rate, nsteps=k)``, interior
    cells by the tap table (algebraically equal, ~k ulp apart), the edge
    band by the exact iterated path. ``out`` (CUDA only) receives the
    result and must not alias ``values``."""
    return _composed_step(values, rate, k, offsets, block, variant,
                          compute_dtype, out)


def _composed_step(values, rate, k, offsets, block, variant, compute_dtype,
                   out, stepper: Optional["ComposedDiffusionStep"] = None):
    offsets = check_offsets(offsets)
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            "compute_dtype other than float32 (bf16 interior math) is not "
            "ported yet; see ROADMAP.md")
    if values.dim() != 2:
        raise ValueError(f"values must be [H, W], got shape "
                         f"{tuple(values.shape)}")
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the composed filter takes float32 or bfloat16 grids, got "
            f"{values.dtype}; float64 stays on the plain path "
            "(impl='xla')")
    h, w = values.shape
    blk = resolve_block((h, w), values.dtype, block)
    _check_mxu_width(_resolve_variant(variant, k, blk[1]), blk[1])
    check_nsteps(k, blk, values.dtype)
    if values.device.type == "cpu":
        res = composed_dense_step_plain(values, rate, k, offsets)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    out = check_out(values, out)
    _launch(values, out, float(rate), offsets, k, stepper)
    return out


def composed_halo_step(
    values: torch.Tensor,
    ring: Mapping[str, torch.Tensor],
    origin: tuple[int, int],
    global_shape: tuple[int, int],
    rate: float,
    k: int,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    block: Optional[tuple[int, int]] = None,
    variant: str = "auto",
    compute_dtype=None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3-halo: ``k`` flow steps as one composed pass on one shard, reading
    its depth->=k ghost ring (``parallel.halo.exchange_ring``'s dict);
    semantics ``pallas_halo_step(..., nsteps=k)``, cells within k of the
    global edge by the exact iterated path. The JAX package's checks: ring
    depth within the slab capacity, ``k <= d``, the variant's. A CPU shard
    takes ``composed_halo_step_plain``; a CUDA shard launches the kernel or
    raises."""
    global _halo_launch_count
    offsets = check_offsets(offsets)
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            "compute_dtype other than float32 (bf16 interior math) is not "
            "ported yet; see ROADMAP.md")
    if values.dim() != 2:
        raise ValueError(f"values must be [h, w], got shape "
                         f"{tuple(values.shape)}")
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the composed filter takes float32 or bfloat16 grids, got "
            f"{values.dtype}; float64 stays on the plain path "
            "(impl='xla')")
    d = check_ring(values, ring)
    blk = check_ring_depth(d, tuple(values.shape), values.dtype, block)
    if k > d:
        raise ValueError(
            f"k={k} needs a ghost ring at least that deep; got depth {d} "
            f"(exchange_ring(..., depth={k}))")
    _check_mxu_width(_resolve_variant(variant, k, blk[1]), blk[1])
    if values.device.type == "cpu":
        res = composed_halo_step_plain(values, ring, origin, global_shape,
                                       rate, k, offsets)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    out = check_out(values, out, tuple(ring.values()))
    if values.numel() == 0:
        return out
    lib = _kernel_lib()
    fn = (lib.mm_composed_halo_f32 if values.dtype == torch.float32
          else lib.mm_composed_halo_bf16)
    args = halo_args(values, ring, origin, global_shape)
    taps = device_taps(rate, offsets, k, torch.float32, values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(ctypes.addressof(args), out.data_ptr(), taps.data_ptr(),
                 float(rate), float(1.0 - rate), k, _offset_mask(offsets),
                 len(offsets), _offset_codes(offsets), stream)
    if err != 0:
        raise RuntimeError(
            f"composed_stencil halo kernel launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")
    _halo_launch_count += 1
    return out


class ComposedDiffusionStep:
    """Reusable composed stepper bound to one geometry and rate: each call
    advances ``k`` flow steps in one pass. ``launches`` counts its K3
    launches; ``variant`` is the variant asked for (checked as the JAX
    package checks it; one CUDA-core tap loop computes every variant)."""

    def __init__(self, shape: tuple[int, int], rate: float, k: int,
                 dtype=torch.float32,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                 block: Optional[tuple[int, int]] = None,
                 variant: str = "auto", compute_dtype=None):
        self.shape = tuple(shape)
        self.rate = float(rate)
        self.k = int(k)
        self.offsets = check_offsets(offsets)
        self.block = block
        self.compute_dtype = compute_dtype
        self.launches = 0
        if self.k > max_k(self.shape, dtype, block):
            raise ValueError(
                f"k={self.k} exceeds the window ghost depth "
                f"{max_k(self.shape, dtype, block)} for shape "
                f"{self.shape} dtype "
                f"{str(dtype).removeprefix('torch.')} block {block}")
        bw = resolve_block(self.shape, dtype, block)[1]
        _check_mxu_width(_resolve_variant(variant, self.k, bw), bw)
        self.variant = variant

    def __call__(self, values: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _composed_step(values, self.rate, self.k, self.offsets,
                              self.block, self.variant, self.compute_dtype,
                              out, self)


def interior_flops(shape: tuple[int, int], k: int) -> float:
    """Flops of one call's tap pass: 2 per tap per interior cell (distance
    > k from every edge)."""
    h, w = shape
    cells = max(h - 2 * k - 2, 0) * max(w - 2 * k - 2, 0)
    return 2.0 * (2 * k + 1) ** 2 * cells

