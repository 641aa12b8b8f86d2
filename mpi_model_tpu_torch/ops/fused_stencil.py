"""K1, the fused dense stencil, and K2, its halo mode: wrappers, checks and
plain versions.

Counterpart of ``mpi_model_tpu/ops/pallas_stencil.py``'s stencil kernel.
The kernels are ``csrc/fused_stencil.cu`` (CUDA C++ for sm_90a, loaded with
ctypes); they replace the TPU kernel ``pallas_stencil.py::_stencil_call``,
run ``nsteps`` uniform-rate transport steps per call in one read and one
write of device memory, and are bound by bytes for small ``nsteps`` (see the
source's header for what the design does about that).

- ``pallas_dense_step`` (K1) steps a whole grid; ``pallas_halo_step`` (K2)
  steps one shard of a sharded grid, reading its exchanged ghost ring
  (``parallel.halo.exchange_ring``'s dict) where the dense kernel reads a
  zero border, with neighbour counts and grid tests in global coordinates.

- After ``n`` fused steps each cell takes one of two forms, chosen from
  its global coordinates (``closed_mask``): more than ``n`` from the grid's
  edge the closed form (``closed_steps_plain``, the TPU kernel's interior
  fast path), elsewhere the exact masked path (``exact_dense_step_plain``).
- ``compute_dtype=torch.bfloat16`` (or ``"bfloat16"``) is the TPU kernel's
  bf16 interior math: at ``nsteps > 1`` the cells of the TPU tiles that
  are not near the edge (``bf16_rect``: JAX's tile rule on JAX's blocks)
  take the closed form in bf16, every operation rounded to bf16 and the
  constants rounded to bf16 from f64 (``closed_steps_bf16``); every other
  cell takes the f32 forms above over the grid rounded to bf16 once. At
  ``nsteps == 1`` the knob changes nothing, as in the TPU kernel. On the
  card such a call is two kernel launches, counted as one: the f32 walk
  over the bands around the rectangle, and the paired bf16 walk over the
  rectangle at its own window rows (``bf16_regions``, ``paired_rows``).
- A CPU tensor takes ``dense_step_plain``, the plain torch version.
- A CUDA tensor launches the kernel or raises; nothing falls back.
- Block and ``nsteps`` checks are the JAX package's, so both packages
  accept and refuse the same calls, although the CUDA kernel has no (8, 128)
  tiling of its own: ``nsteps <= min(sublane, bh, 128, bw)`` with sublane 8
  for f32 and 16 for bf16.
- Launches are counted, per stepper (``PallasDiffusionStep.launches``) and
  module-wide (``launches()`` for K1, ``halo_launches()`` for K2), only
  where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.cell import MOORE_OFFSETS
from ._build import KernelError

LANE = 128  # the JAX kernel's lane tile; kept for the same block checks

#: storage dtypes the kernel takes (it computes in f32, or in bf16 on the
#: interior tiles under ``compute_dtype=torch.bfloat16``)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: the ring pieces in the order the kernels' HaloArgs holds them
RING_PIECES = ("n", "s", "w", "e", "nw", "ne", "sw", "se")
_launch_count = 0
_halo_launch_count = 0


def launches() -> int:
    """K1 launches made by this module since the last reset."""
    return _launch_count


def halo_launches() -> int:
    """K2 launches made by this module since the last reset."""
    return _halo_launch_count


def reset_launches() -> None:
    global _launch_count, _halo_launch_count
    _launch_count = 0
    _halo_launch_count = 0


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


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """The interior math a ``compute_dtype`` asks for: None for f32 (None,
    ``torch.float32``, ``"float32"``), ``torch.bfloat16`` for bf16
    (``torch.bfloat16``, ``"bfloat16"``). Anything else raises
    ``ValueError``."""
    if compute_dtype is None:
        return None
    name = str(compute_dtype).removeprefix("torch.")
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                     f"{compute_dtype!r}")


def round_bf16(x: float) -> float:
    """``x`` rounded to the nearest bf16 value (ties to even), straight from
    its f64 value: what a weakly typed Python float becomes in a bf16
    operation of the TPU kernel. The result is exactly an f32 value."""
    x = float(x)
    if x == 0.0 or math.isinf(x) or math.isnan(x) or abs(x) < 2.0 ** -126:
        return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))
    m, e = math.frexp(x)  # x = m 2^e, 0.5 <= |m| < 1: 8 bits of m kept
    return math.ldexp(round(m * 256.0), e - 8)


def rb(t: torch.Tensor) -> torch.Tensor:
    """An f32 tensor rounded to bf16 values, kept in f32: one bf16
    operation's result (f32 carries more than 2·8 + 2 bits, so an f32
    operation on bf16 values rounded once to bf16 is the bf16 operation)."""
    return t.to(torch.bfloat16).to(torch.float32)


def bf16_rect(shape: tuple[int, int], block: tuple[int, int], nsteps: int,
              origin: tuple[int, int] = (0, 0),
              global_shape: Optional[tuple[int, int]] = None
              ) -> tuple[int, int, int, int]:
    """``(r0, r1, c0, c1)``: the local rows ``[r0, r1)`` and columns
    ``[c0, c1)`` of the ``[h, w]`` array at global ``origin`` that lie in
    TPU tiles the bf16 interior math takes: JAX's tiles of ``block`` over
    the array (a shard's tiles at its global origin), a tile being near
    when ``g_r0 <= n``, ``g_r0 + bh >= H - n``, ``g_c0 <= n`` or
    ``g_c0 + bw >= W - n`` (``pallas_stencil.py:391-392``). The tiles
    that are not near form one rectangle; an empty one has r0 == r1 or
    c0 == c1."""
    (h, w), (bh, bw), n = shape, block, int(nsteps)
    gh, gw = global_shape if global_shape is not None else (h, w)

    def span(extent, b, o, g):
        ok = [t for t in range(extent // b)
              if o + t * b > n and o + t * b + b < g - n]
        return (ok[0] * b, (ok[-1] + 1) * b) if ok else (0, 0)

    r0, r1 = span(h, bh, int(origin[0]), gh)
    c0, c1 = span(w, bw, int(origin[1]), gw)
    return (r0, r1, c0, c1) if r0 < r1 and c0 < c1 else (0, 0, 0, 0)


def with_bf16_rect(out, interior, shape: tuple[int, int], dtype, block,
                   nsteps: int, origin: tuple[int, int] = (0, 0),
                   global_shape: Optional[tuple[int, int]] = None,
                   at: int = 0):
    """A plain version's bf16 interior math: ``out`` (the near tiles' f32
    result, a tensor or a mapping of tensors) with the cells of
    ``bf16_rect`` (JAX's tiles of ``block``, or of the block JAX picks for
    ``dtype``, at the array's global ``origin``) overwritten in place by
    ``interior()``'s, whose cell (r, c) sits at (r + at, c + at). Calls
    ``interior`` only when the rectangle holds a cell. Returns ``out``."""
    r0, r1, c0, c1 = bf16_rect(shape, resolve_block(shape, dtype, block),
                               nsteps, origin, global_shape)
    if r0 < r1:
        inner = interior()
        pairs = (inner.items() if isinstance(inner, Mapping)
                 else [(None, inner)])
        for key, t in pairs:
            dst = out if key is None else out[key]
            dst[r0:r1, c0:c1] = t[at + r0:at + r1, at + c0:at + c1].to(
                dst.dtype)
    return out


def closed_steps_bf16(v: torch.Tensor, rate: float, offsets: tuple,
                      nsteps: int) -> torch.Tensor:
    """``closed_steps_plain`` in bf16, as the TPU kernel runs its interior
    tiles under ``compute_dtype=bfloat16``: ``v`` holds bf16 values (in
    f32), every operation is rounded to bf16 (``rb``) in the same order,
    and the constants are rounded to bf16 from f64 (``round_bf16``, JAX's
    weak typing). Other neighbourhoods sum from 0, as the f32 form does.
    Returns bf16 values in f32."""
    moore, a, b = closed_constants(rate, offsets)
    a, b = round_bf16(a), round_bf16(b)
    h, w = v.shape[-2:]
    cur = v
    for _ in range(nsteps):
        p = F.pad(cur, (1, 1, 1, 1))
        if moore:
            band = rb(rb(p[..., 0:h, :] + p[..., 1:h + 1, :])
                      + p[..., 2:h + 2, :])
            g = rb(rb(band[..., 0:w] + band[..., 1:w + 1])
                   + band[..., 2:w + 2])
        else:
            g = torch.zeros_like(cur)
            for dx, dy in offsets:
                g = rb(g + p[..., 1 + dx:1 + dx + h, 1 + dy:1 + dy + w])
        cur = rb(rb(cur * a) + rb(g * b))
    return cur


def exact_steps_plain(v: torch.Tensor, cnt: torch.Tensor, rate: float,
                      offsets: Sequence[tuple[int, int]], nsteps: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nsteps`` exact steps on the f32 ``[..., h, w]`` region ``v`` with
    zeros beyond it: ``share = rate*v/cnt``, ``v*(1-rate) + Σ_d share[c+d]``
    in offset order; cells where ``mask`` is False are re-zeroed each step.
    After n steps the cells at least n from the region's edge are exact."""
    h, w = v.shape[-2:]
    padded = torch.zeros(v.shape[:-2] + (h + 2, w + 2),
                         dtype=torch.float32, device=v.device)
    for _ in range(nsteps):
        padded[..., 1:-1, 1:-1] = (rate * v) / cnt
        g = None
        for dx, dy in offsets:
            t = padded[..., 1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
            g = t if g is None else g + t
        v = v * (1.0 - rate) + g
        if mask is not None:
            v = torch.where(mask, v, 0.0)
    return v


def closed_constants(rate: float, offsets: tuple) -> tuple[bool, float,
                                                             float]:
    """(is_moore, a, b) of the closed form ``v*a + Σ*b``, formed in f64 as
    the TPU kernel's Python floats are; the kernels and the plain versions
    round each to f32 once. Moore (the eight offsets, in any order) sums
    the 3×3 box, centre included: ``a = 1 - r - r/8``; other neighbourhoods
    sum the neighbours: ``a = 1 - r``; ``b = r/k`` for both."""
    k = float(len(offsets))
    moore = set(offsets) == set(MOORE_OFFSETS)
    a = 1.0 - rate - rate / k if moore else 1.0 - rate
    return moore, a, rate / k


def closed_steps_plain(v: torch.Tensor, rate: float, offsets: tuple,
                       nsteps: int) -> torch.Tensor:
    """``nsteps`` closed-form steps over the whole f32 ``[..., h, w]`` region
    ``v`` (zeros outside), in the TPU kernel's order: Moore ``band = (v[r-1]
    + v[r]) + v[r+1]`` per column, ``nine = (band[c-1] + band[c]) +
    band[c+1]``; other neighbourhoods the neighbours summed in ``offsets``
    order; then ``v*a + Σ*b``. Exact only where every cell of a cell's
    n-cone has its full neighbourhood (``closed_mask``)."""
    moore, a, b = closed_constants(rate, offsets)
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


def closed_mask(shape: tuple[int, int], nsteps: int,
                origin: tuple[int, int] = (0, 0),
                global_shape: Optional[tuple[int, int]] = None,
                device=None) -> torch.Tensor:
    """``[h, w]`` bool: True on the cells of the ``[h, w]`` region at global
    ``origin`` that K1/K2 compute in closed form after ``nsteps`` fused
    steps: those whose distance ``min(R, H-1-R, C, W-1-C)`` to the global
    grid's edge exceeds ``nsteps``. Every cell of such a cell's n-cone lies
    off the grid's outer ring, so every count it meets is full and the
    closed form is the exact step there."""
    h, w = shape
    gh, gw = global_shape if global_shape is not None else (h, w)
    rows = int(origin[0]) + torch.arange(h, device=device)[:, None]
    cols = int(origin[1]) + torch.arange(w, device=device)[None, :]
    rd = torch.minimum(rows, gh - 1 - rows)
    cd = torch.minimum(cols, gw - 1 - cols)
    return torch.minimum(rd, cd) > int(nsteps)


def exact_dense_step_plain(values: torch.Tensor, rate: float,
                           offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                           nsteps: int = 1) -> torch.Tensor:
    """K1's exact path alone, on every cell: cast to f32 once, run
    ``nsteps`` exact steps (``share = rate*v/cnt``, ``v*(1-rate) + Σ_d
    share[c+d]`` in offset order, counts clamped to >= 1), cast back once.
    The plain versions of K3 and K5 take it for their edge cells. Leading
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
    return exact_steps_plain(v, cnt, rate, offsets, nsteps).to(values.dtype)


def dense_step_plain(values: torch.Tensor, rate: float,
                     offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                     nsteps: int = 1, compute_dtype=None,
                     block: Optional[tuple[int, int]] = None
                     ) -> torch.Tensor:
    """The plain torch version of K1: cast to f32 once; cells whose
    distance to the grid's edge exceeds ``nsteps`` (``closed_mask``) take
    ``closed_steps_plain``, every other cell the exact path
    (``exact_dense_step_plain``); cast back once. bf16 is thus rounded once
    per call, as the kernel (and the TPU kernel) does. Leading batch
    dimensions (``[..., H, W]``) step every grid independently.

    The choice is per cell, from global coordinates, so a sharded run
    (``halo_step_plain``) takes the same form for every cell wherever its
    seams fall. The JAX kernel chooses per TPU tile and, at nsteps=1,
    applies the closed form everywhere with a divisor correction on ring
    tiles; the two round differently near the ring (ROADMAP.md).

    ``compute_dtype=torch.bfloat16`` at ``nsteps > 1``: the cells of
    ``bf16_rect`` (JAX's interior tiles of ``block``, or of the block JAX
    picks) take ``closed_steps_bf16``; every other cell the f32 forms above
    over the grid rounded to bf16 once (the TPU kernel's near tiles read
    the window cast to bf16, ``pallas_stencil.py:441``)."""
    offsets = tuple(offsets)
    nsteps = int(nsteps)
    if resolve_compute_dtype(compute_dtype) is not None and nsteps > 1:
        v = rb(values.to(torch.float32))
        out = with_bf16_rect(
            dense_step_plain(v, rate, offsets, nsteps),
            lambda: closed_steps_bf16(v, rate, offsets, nsteps),
            tuple(v.shape), values.dtype, block, nsteps)
        return out.to(values.dtype)
    v = values.to(torch.float32)
    out = exact_dense_step_plain(v, rate, offsets, nsteps)
    inside = closed_mask(tuple(v.shape[-2:]), nsteps, device=v.device)
    if bool(inside.any()):
        out = torch.where(inside, closed_steps_plain(v, rate, offsets,
                                                     nsteps), out)
    return out.to(values.dtype)


# -- halo mode: one shard and its ghost ring ---------------------------------

def ring_depth(ring: Mapping[str, torch.Tensor]) -> int:
    return int(ring["n"].shape[0])


def check_ring(values: torch.Tensor, ring: Mapping[str, torch.Tensor],
               name: str = "ring") -> int:
    """Check that ``ring`` is a depth-d ghost ring of the ``[h, w]`` shard
    ``values`` (``exchange_ring``'s layout: n/s ``[d, w]``, w/e ``[h, d]``,
    corners ``[d, d]``, in the shard's dtype, on its device); returns d."""
    missing = [p for p in RING_PIECES if p not in ring]
    if missing:
        raise ValueError(f"{name} lacks the pieces {missing}")
    h, w = values.shape
    d = ring_depth(ring)
    want = {"n": (d, w), "s": (d, w), "w": (h, d), "e": (h, d),
            "nw": (d, d), "ne": (d, d), "sw": (d, d), "se": (d, d)}
    for p, shape in want.items():
        t = ring[p]
        if (tuple(t.shape) != shape or t.dtype != values.dtype
                or t.device != values.device):
            raise ValueError(
                f"{name}[{p!r}] is {t.dtype} {tuple(t.shape)} on {t.device}; "
                f"a depth-{d} ring of a {tuple(values.shape)} "
                f"{values.dtype} shard on {values.device} needs {shape}")
    return d


def check_ring_depth(d: int, shape: tuple[int, int], dtype,
                     block: Optional[tuple[int, int]]) -> tuple[int, int]:
    """The JAX package's slab-capacity rule: the ring is at most
    ``min(hr, hc)`` deep for the shard's block. Returns the block."""
    blk = resolve_block(shape, dtype, block)
    hr, hc = min(_sublane(dtype), blk[0]), min(LANE, blk[1])
    if d > min(hr, hc):
        raise ValueError(
            f"ring depth {d} exceeds the slab capacity min(hr={hr}, "
            f"hc={hc}) for block {tuple(blk)}")
    return blk


def pad_from_ring(values: torch.Tensor,
                  ring: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The ``[h + 2d, w + 2d]`` padded shard: the shard with its ring."""
    top = torch.cat([ring["nw"], ring["n"], ring["ne"]], dim=1)
    mid = torch.cat([ring["w"], values, ring["e"]], dim=1)
    bot = torch.cat([ring["sw"], ring["s"], ring["se"]], dim=1)
    return torch.cat([top, mid, bot], dim=0)


def padded_region(values: torch.Tensor, ring: Mapping[str, torch.Tensor],
                  origin: tuple[int, int], global_shape: tuple[int, int],
                  offsets: Sequence[tuple[int, int]]):
    """The padded shard's geometry in global coordinates: its origin
    ``(R0 - d, C0 - d)``, the on-grid mask (bool) and the in-bounds
    neighbour counts clamped to >= 1 (f32)."""
    from .stencil import neighbor_counts

    d = ring_depth(ring)
    h, w = values.shape
    org = (int(origin[0]) - d, int(origin[1]) - d)
    shape = (h + 2 * d, w + 2 * d)
    gh, gw = global_shape
    rows = org[0] + torch.arange(shape[0], device=values.device)[:, None]
    cols = org[1] + torch.arange(shape[1], device=values.device)[None, :]
    mask = (rows >= 0) & (rows < gh) & (cols >= 0) & (cols < gw)
    cnt = torch.clamp(neighbor_counts(shape, offsets, org, global_shape,
                                      torch.float32, values.device), min=1.0)
    return org, mask, cnt


def halo_step_plain(values: torch.Tensor, ring: Mapping[str, torch.Tensor],
                    origin: tuple[int, int], global_shape: tuple[int, int],
                    rate: float,
                    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                    nsteps: int = 1, compute_dtype=None,
                    block: Optional[tuple[int, int]] = None
                    ) -> torch.Tensor:
    """The plain torch version of K2: the padded shard assembled from the
    ring, cast to f32 and masked to the grid; both forms over it, the exact
    steps with counts from global coordinates (off-grid cells re-zeroed
    each step) and the closed form; the shard cropped out, each cell
    taking the form ``closed_mask`` gives it at the shard's global origin;
    cast back once. Shards stepped so and put together equal
    ``dense_step_plain`` on the whole grid bit for bit.

    ``compute_dtype=torch.bfloat16`` at ``nsteps > 1``: as
    ``dense_step_plain``, with the shard's TPU tiles (``block``, or the
    block JAX picks for the shard) at its global origin."""
    offsets = tuple(offsets)
    d = ring_depth(ring)
    h, w = values.shape
    if resolve_compute_dtype(compute_dtype) is not None and nsteps > 1:
        vr = rb(values.to(torch.float32))
        ringr = {p: rb(t.to(torch.float32)) for p, t in ring.items()}
        def closed():
            _, mask, _ = padded_region(vr, ringr, origin, global_shape,
                                       offsets)
            v = torch.where(mask, pad_from_ring(vr, ringr), 0.0)
            return closed_steps_bf16(v, rate, offsets, nsteps)

        out = with_bf16_rect(
            halo_step_plain(vr, ringr, origin, global_shape, rate, offsets,
                            nsteps),
            closed, (h, w), values.dtype, block, nsteps, origin,
            global_shape, at=d)
        return out.to(values.dtype)
    _, mask, cnt = padded_region(values, ring, origin, global_shape, offsets)
    v = torch.where(mask, pad_from_ring(values, ring).to(torch.float32), 0.0)
    out = exact_steps_plain(v, cnt, rate, offsets, nsteps, mask)
    out = out[d:d + h, d:d + w]
    inside = closed_mask((h, w), nsteps, origin, global_shape, values.device)
    if bool(inside.any()):
        closed = closed_steps_plain(v, rate, offsets, nsteps)
        out = torch.where(inside, closed[d:d + h, d:d + w], out)
    return out.to(values.dtype)


class _HaloArgs(ctypes.Structure):
    """``mm::HaloArgs`` of ``csrc/stencil_common.cuh``, field for field."""

    _fields_ = [("shard", ctypes.c_void_p), ("ring", ctypes.c_void_p * 8),
                ("h", ctypes.c_int), ("w", ctypes.c_int), ("d", ctypes.c_int),
                ("R0", ctypes.c_int), ("C0", ctypes.c_int),
                ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("pad_", ctypes.c_int)]


def halo_args(values: torch.Tensor, ring: Mapping[str, torch.Tensor],
              origin: tuple[int, int],
              global_shape: tuple[int, int]) -> _HaloArgs:
    """The launch argument for one shard: its pointer, its ring's (every
    piece contiguous), its extent, the ring depth, its global origin and
    the global grid. Raises when the shard does not lie inside the grid."""
    h, w = values.shape
    R0, C0 = int(origin[0]), int(origin[1])
    H, W = int(global_shape[0]), int(global_shape[1])
    if R0 < 0 or C0 < 0 or R0 + h > H or C0 + w > W:
        raise ValueError(f"a {h}x{w} shard at {(R0, C0)} does not lie inside "
                         f"the {H}x{W} grid")
    if not values.is_contiguous() or not all(
            ring[p].is_contiguous() for p in RING_PIECES):
        raise ValueError("the shard and every ring piece must be contiguous")
    a = _HaloArgs()
    a.shard = values.data_ptr()
    for i, p in enumerate(RING_PIECES):
        a.ring[i] = ring[p].data_ptr()
    a.h, a.w, a.d = h, w, ring_depth(ring)
    a.R0, a.C0, a.H, a.W = R0, C0, H, W
    return a


def check_out(values: torch.Tensor, out: Optional[torch.Tensor],
              reads=()) -> torch.Tensor:
    """``out``, or a new tensor like ``values``: contiguous, of the input's
    shape, dtype and device, aliasing neither ``values`` nor ``reads``."""
    if out is None:
        return torch.empty_like(values)
    if (out.shape != values.shape or out.dtype != values.dtype
            or out.device != values.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor of the input's "
                         "shape, dtype and device")
    if out.data_ptr() in {t.data_ptr() for t in (values, *reads)}:
        raise ValueError("the kernel is out of place: out must not alias "
                         "values")
    return out


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


def _step_args(rate: float, offsets: tuple, nsteps: int,
               rect: Optional[tuple] = None) -> tuple:
    """The kernels' step arguments: the exact path's rate and ``1 - rate``,
    the closed form's ``a`` and ``b`` (``closed_constants``), ``nsteps``,
    the neighbourhood's bitmask, size and ordered codes, and whether it is
    Moore (each float rounded to f32 once by ctypes); then the bf16
    interior math: whether it is on, the global rows and columns of its
    cells (``rect``, ``[r0, r1) x [c0, c1)``), ``a`` and ``b`` rounded to
    bf16 (``round_bf16``) and the paired launch's window rows
    (``paired_rows``)."""
    moore, a, b = closed_constants(rate, offsets)
    bf = rect is not None
    r0, r1, c0, c1 = rect if bf else (0, 0, 0, 0)
    return (float(rate), float(1.0 - rate), float(a), float(b), int(nsteps),
            _offset_mask(offsets), len(offsets), _offset_codes(offsets),
            int(moore), int(bf), r0, r1, c0, c1, round_bf16(a),
            round_bf16(b), paired_rows(nsteps, offsets) if bf else 0)


# -- the bf16 interior math's two launches ------------------------------------
#
# A call with ``compute_dtype=bfloat16`` at ``nsteps > 1`` is two kernel
# launches, counted as one: the near launch tiles the four bands of the
# array around the rectangle (``bf16_regions``) with the f32 walk's windows
# (``window_rows``), the paired launch tiles the rectangle with its own
# (``paired_rows``); each from its region's origin, each writing only its
# region's cells (``region_tiles``). The CUDA source computes the same split
# and tilings (``csrc/stencil_common.cuh``: ``split_of``, ``bands_of``,
# ``region_tiling``; K3 vpu's two launches share them); a region with no cell
# is not launched. These mirrors
# serve the tests and the bounds; ``kernel_plan`` reads the source's own
# geometry, and the card tests and ``chip_smoke.py`` hold them to it.

#: the paired walk's window rows the kernel is built for (Moore, row pairs)
PAIRED_ROWS = (64, 96)
#: the window's columns (a column a thread, 8 warps a block)
WINDOW_COLS = 256


def window_rows(nsteps: int, offsets: Sequence[tuple[int, int]]) -> int:
    """The f32 walk's window rows (``csrc/fused_stencil.cu::rows_for``):
    48 for Moore up to 2 steps and for other neighbourhoods, else 64."""
    moore = closed_constants(0.0, tuple(offsets))[0]
    return 64 if moore and int(nsteps) > 2 else 48


def paired_rows(nsteps: int, offsets: Sequence[tuple[int, int]]) -> int:
    """The paired launch's window rows, one of ``PAIRED_ROWS`` for Moore,
    chosen by measurement on the H100 (``k1_variants.py``, ``PERF.md``):
    the walk holds the window's pairs and its bands, rows words a thread,
    two blocks an SM up to 96 rows (80 and 128 measured slower); 64 rows
    at 2 steps, 96 above. 48 for other neighbourhoods (their bf16 walk is
    the f32 walk with every operation rounded, at its rows)."""
    if not closed_constants(0.0, tuple(offsets))[0]:
        return 48
    return 64 if int(nsteps) <= 2 else 96


def bf16_regions(shape: tuple[int, int], rect: tuple
                 ) -> tuple[tuple, list[tuple]]:
    """The split of a ``[h, w]`` array by the bf16 rectangle ``rect``
    (local rows ``[r0, r1)``, columns ``[c0, c1)``, as ``bf16_rect``
    gives it): the paired launch's region and the near launch's four bands
    (top, bottom, left, right), each ``(r0, r1, c0, c1)``. An empty
    rectangle leaves the whole array to the top band."""
    h, w = shape
    r0, r1, c0, c1 = (min(max(int(x), 0), e)
                      for x, e in zip(rect, (h, h, w, w)))
    if r0 >= r1 or c0 >= c1:
        r0, r1, c0, c1 = h, h, 0, 0
    return ((r0, r1, c0, c1),
            [(0, r0, 0, w), (r1, h, 0, w), (r0, r1, 0, c0), (r0, r1, c1, w)])


def region_tiles(region: tuple, rows: int, nsteps: int,
                 rh: Optional[int] = None) -> list[tuple]:
    """The tiles of one region's launch, in block order: ``(rows - 2 rh) x
    (256 - 2n)`` output cells each (``rh``, the window's rows above a tile:
    ``n`` for K1/K2, the instance's OFF for K3 vpu), from the region's
    origin, each clipped to the region: ``(r0, r1, c0, c1)`` of the cells
    it writes; each tile reads the window ``rh`` rows and ``n`` columns
    around it. The source's ``mm::region_tiling`` is the same tiling (held
    to it on the card through ``kernel_plan``)."""
    r0, r1, c0, c1 = region
    n = int(nsteps)
    th = int(rows) - 2 * (n if rh is None else int(rh))
    tw = WINDOW_COLS - 2 * n
    if r0 >= r1 or c0 >= c1:
        return []
    return [(r, min(r + th, r1), c, min(c + tw, c1))
            for r in range(r0, r1, th) for c in range(c0, c1, tw)]


def kernel_plan(shape: tuple[int, int], rect: tuple, nsteps: int,
                offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                origin: tuple[int, int] = (0, 0),
                global_shape: Optional[tuple[int, int]] = None
                ) -> tuple[int, list[tuple]]:
    """The two launches' geometry as the CUDA source computes it for a
    bf16-interior call on a ``shape`` array at ``origin`` of
    ``global_shape`` (``rect``: global, as ``kernel_rect`` gives it): the
    near launch's rows, and for the paired region and the four bands
    ``(r0, r1, c0, c1, tiles)``. It launches nothing but needs the built
    library (the card): tests and ``chip_smoke.py`` hold ``window_rows``,
    ``bf16_regions`` and ``region_tiles`` to it."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 26)()
    h, w = shape
    H, W = global_shape or shape
    err = lib.mm_fused_bf16_plan(h, w, origin[0], origin[1], H, W,
                                 *_step_args(0.1, tuple(offsets), nsteps,
                                             rect), out)
    if err != 0:
        raise ValueError(f"mm_fused_bf16_plan refused {shape} at {origin}, "
                         f"nsteps={nsteps}: "
                         f"{lib.mm_cuda_error_string(err).decode()}")
    return out[0], [tuple(out[1 + 5 * k:6 + 5 * k]) for k in range(5)]


def kernel_rect(shape: tuple[int, int], dtype, block, nsteps: int,
                compute_dtype, origin: tuple[int, int] = (0, 0),
                global_shape: Optional[tuple[int, int]] = None
                ) -> Optional[tuple]:
    """The bf16 cells of a call of K1/K2, K3 or K4 in global coordinates
    (``bf16_rect`` moved to the array's origin), or None when the call
    computes in f32. A kernel takes the bf16 form even when the rectangle
    is empty: every other cell then takes the near tiles' form."""
    if resolve_compute_dtype(compute_dtype) is None:
        return None
    r0, r1, c0, c1 = bf16_rect(shape, resolve_block(shape, dtype, block),
                               nsteps, origin, global_shape)
    o_r, o_c = int(origin[0]), int(origin[1])
    return (o_r + r0, o_r + r1, o_c + c0, o_c + c1)


def _kernel_lib():
    from ._build import load

    lib = load("fused_stencil")
    if not getattr(lib, "_mm_typed", False):
        step_args = ([ctypes.c_float] * 4 + [ctypes.c_int] * 10
                     + [ctypes.c_float] * 2 + [ctypes.c_int])
        for fn in (lib.mm_fused_stencil_f32, lib.mm_fused_stencil_bf16):
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int] + step_args + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for fn in (lib.mm_fused_stencil_halo_f32,
                   lib.mm_fused_stencil_halo_bf16):
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + step_args
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mm_fused_bf16_plan.argtypes = ([ctypes.c_int] * 6 + step_args
                                           + [ctypes.POINTER(ctypes.c_int)])
        lib.mm_fused_bf16_plan.restype = ctypes.c_int
        lib.mm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib.mm_halo_args_size.restype = ctypes.c_int
        if lib.mm_halo_args_size() != ctypes.sizeof(_HaloArgs):
            raise KernelError(
                f"fused_stencil's HaloArgs is {lib.mm_halo_args_size()} "
                f"bytes, the wrapper's {ctypes.sizeof(_HaloArgs)}")
        lib._mm_typed = True
    return lib


def _what(kname: str, values: torch.Tensor, offsets: tuple, nsteps: int,
          rect: Optional[tuple]) -> str:
    """A call of K1 or K2 in words, for its launch error: the kernel, the
    storage dtype, the steps and the window rows of each launch (with the
    bf16 interior math: the near launch's f32 walk and the paired launch's
    layout)."""
    dt = str(values.dtype).removeprefix("torch.")
    rows = window_rows(nsteps, offsets)
    if rect is None:
        return f"{kname} fused_stencil ({dt}, nsteps={nsteps}, {rows} rows)"
    rows16 = paired_rows(nsteps, offsets)
    layout = ("row pairs" if closed_constants(0.0, offsets)[0]
              else "the rounded f32 walk")
    return (f"{kname} fused_stencil bf16 interior ({dt}, nsteps={nsteps}: "
            f"near launch {rows} rows, paired launch {layout}, "
            f"{rows16} rows)")


def _launch(values: torch.Tensor, out: torch.Tensor, rate: float,
            offsets: tuple, nsteps: int,
            stepper: Optional["PallasDiffusionStep"] = None,
            rect: Optional[tuple] = None) -> None:
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
        err = fn(values.data_ptr(), out.data_ptr(), h, w,
                 *_step_args(rate, offsets, nsteps, rect), stream)
    if err != 0:
        raise KernelError(
            f"{_what('K1', values, offsets, nsteps, rect)} launch failed: "
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

        return pipeline_dense_step(values, rate, offsets, block, nsteps, out,
                                   compute_dtype)
    return _dense_step(values, rate, offsets, block, nsteps, compute_dtype,
                       out)


def _dense_step(values, rate, offsets, block, nsteps, compute_dtype, out,
                stepper: Optional["PallasDiffusionStep"] = None):
    offsets = check_offsets(offsets)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    resolve_compute_dtype(compute_dtype)
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
        res = dense_step_plain(values, rate, offsets, int(nsteps),
                               compute_dtype, blk)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    out = check_out(values, out)
    # K1/K2 ignore the knob at one step, as the TPU kernel does
    _launch(values, out, rate, offsets, int(nsteps), stepper,
            kernel_rect((h, w), values.dtype, blk, nsteps, compute_dtype)
            if nsteps > 1 else None)
    return out


def _launch_halo(values: torch.Tensor, ring, origin, global_shape,
                 out: torch.Tensor, rate: float, offsets: tuple,
                 nsteps: int, rect: Optional[tuple] = None) -> None:
    """Launch K2 on the current stream of the shard's device; raises on any
    launch error. Counts the launch once the kernel is queued."""
    global _halo_launch_count
    if values.numel() == 0:
        return
    lib = _kernel_lib()
    fn = (lib.mm_fused_stencil_halo_f32 if values.dtype == torch.float32
          else lib.mm_fused_stencil_halo_bf16)
    args = halo_args(values, ring, origin, global_shape)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(ctypes.addressof(args), out.data_ptr(),
                 *_step_args(rate, offsets, nsteps, rect), stream)
    if err != 0:
        raise KernelError(
            f"{_what('K2', values, offsets, nsteps, rect)} launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")
    _halo_launch_count += 1


def pallas_halo_step(
    values: torch.Tensor,
    ring: Mapping[str, torch.Tensor],
    origin: tuple[int, int],
    global_shape: tuple[int, int],
    rate: float,
    offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
    block: Optional[tuple[int, int]] = None,
    nsteps: int = 1,
    compute_dtype=None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2: ``nsteps`` fused flow steps on one ``[h, w]`` shard of a sharded
    grid, reading its depth-d ghost ring (``parallel.halo.exchange_ring``'s
    dict: ``n``/``s`` ``[d, w]``, ``w``/``e`` ``[h, d]``, four ``[d, d]``
    corners; zeros at true grid edges) where the dense kernel reads a zero
    border. ``origin`` is the shard's global (row, col) offset and
    ``global_shape`` the whole grid's dims. Semantics: ``pallas_dense_step``
    on the global grid, computed shard-locally. The JAX package's checks:
    the ring at most ``min(hr, hc)`` deep for the shard's block, and
    ``nsteps <= d``. A CPU shard takes ``halo_step_plain``; a CUDA shard
    launches the kernel or raises. ``out`` (CUDA only) receives the result
    and must alias neither the shard nor its ring."""
    offsets = check_offsets(offsets)
    nsteps = int(nsteps)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    resolve_compute_dtype(compute_dtype)
    if values.dim() != 2:
        raise ValueError(f"values must be [h, w], got shape "
                         f"{tuple(values.shape)}")
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the fused stencil takes float32 or bfloat16 grids, got "
            f"{values.dtype}; float64 stays on the plain path "
            "(impl='xla')")
    d = check_ring(values, ring)
    blk = check_ring_depth(d, tuple(values.shape), values.dtype, block)
    if nsteps > d:
        raise ValueError(
            f"nsteps={nsteps} needs a ghost ring at least that deep; got "
            f"depth {d} (exchange_ring(..., depth={nsteps}))")
    if values.device.type == "cpu":
        res = halo_step_plain(values, ring, origin, global_shape, rate,
                              offsets, nsteps, compute_dtype, blk)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    out = check_out(values, out, tuple(ring.values()))
    _launch_halo(values, ring, origin, global_shape, out, rate, offsets,
                 nsteps, kernel_rect(tuple(values.shape), values.dtype, blk,
                                     nsteps, compute_dtype, origin,
                                     global_shape) if nsteps > 1 else None)
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
