"""K3, the composed k-step dense filter, and K3-halo, its sharded form: tap
tables, coefficients, checks, wrappers and plain versions (counterpart of
``mpi_model_tpu/ops/composed_stencil.py``).

For uniform-rate ``Diffusion`` the flow step on interior cells is a linear
operator ``S = (1 - rate) δ + (rate / k') N`` (``k' = |offsets|``, ``N`` the
neighbor sum), so k steps compose into ONE pass of ``S^k`` on cells at
distance > k from the global edge (k steps reach k cells out, and each of
those must have all its neighbors on the grid for the one-step operator to
be ``S`` there). Cells nearer the edge keep the exact iterated path (K1's),
where the per-cell divisor makes the operator vary in space.

``variant`` is resolved with the JAX package's rule (``"auto"``: ``"mxu"``
from ``MXU_MIN_TAPS`` taps on a 128-aligned block width, else ``"vpu"``;
``"mxu"`` needs that width) and picks the interior form, each the JAX
hook's arithmetic:

- ``"vpu"``: the binomial expansion ``S^k = Σ_j coef_j B^j``, ``B`` the 3×3
  box (Moore, ``S = α δ + β B``) or the neighbor sum, ``coef_j = C(k,j)
  α^(k-j) β^j`` formed in f64 and rounded to f32 once (``vpu_coefs``);
  ``acc = coef_0·v``, then ``cur = B(cur)``, ``acc = acc + coef_j·cur``.
  The kernel runs K1's register column walk and equals the plain version
  bit for bit.
- ``"mxu"``: the ``(2k+1)²`` tap correlation with the f64 table rounded to
  f32 (``composed_taps``); the plain version accumulates it from zero in
  row-major tap order, the kernel runs it as banded tap matrices on tensor
  cores (``mxu_fragments``; 3×TF32 for f32, two bf16 tap terms for bf16),
  within ``1e-6·k·max|v|`` (f32) and one bf16 ulp of its plain version.

- ``compute_dtype=torch.bfloat16`` is the JAX hooks' bf16 interior math:
  the cells of the TPU tiles that are not near the edge
  (``fused_stencil.bf16_rect``, JAX's tile rule on JAX's blocks) take the
  form in bf16 (vpu: every operation rounded to bf16, the coefficients
  rounded to bf16 from f64, ``vpu_coefs_bf16``; mxu: the window and the
  taps rounded to bf16, their products summed in f32), every other cell
  the f32 forms over the grid rounded to bf16 once.
- With ``compute_dtype=torch.bfloat16`` a vpu call on the card is two
  launches, counted as one: the near launch over the four bands around the
  bf16 rectangle (``fused_stencil.bf16_regions``) at the f32 walk's window
  (``window_rows``), and the paired launch over the rectangle at its own
  (``paired_rows``), each tiled from its region's origin
  (``fused_stencil.region_tiles``); ``kernel_plan`` reads the source's own
  geometry.
- ``composed_dense_step``: a CPU tensor takes ``composed_dense_step_plain``
  with the resolved form; a CUDA tensor launches that form's kernel
  (``csrc/composed_stencil.cu``) or raises.
- ``composed_halo_step`` (K3-halo) is the same pass on one shard of a
  sharded grid, reading its depth->=k ghost ring; the interior/edge-band
  choice is made per cell from its global row and column, so shards put
  together take the whole-grid run's path for every cell, and both forms'
  mosaics equal the whole grid bit for bit.
- Launches are counted per stepper (``ComposedDiffusionStep.launches``) and
  module-wide, per form (``launches(form)`` for K3, ``halo_launches(form)``
  for K3-halo; no form: both), only where a kernel is launched.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.cell import MOORE_OFFSETS
from ._build import KernelError
from .seam import plain_version
from .fused_stencil import (
    KERNEL_DTYPES,
    LANE,
    _offset_codes,
    _offset_mask,
    _pick_block,
    _sublane,
    _validate_block,
    bf16_regions,
    check_nsteps,
    check_offsets,
    check_out,
    check_ring,
    check_ring_depth,
    exact_dense_step_plain,
    exact_steps_plain,
    halo_args,
    kernel_rect,
    pad_from_ring,
    padded_region,
    rb,
    region_tiles,
    resolve_block,
    resolve_compute_dtype,
    round_bf16,
    with_bf16_rect,
)

#: tap count from which ``variant="auto"`` names the MXU form (the JAX
#: package's break-even rule, kept so both packages resolve alike)
MXU_MIN_TAPS = 9
FORMS = ("vpu", "mxu")

#: the mxu kernel's layout per storage dtype (``Mxu<T>``, ``MX_N`` and the
#: block tile in ``csrc/composed_stencil.cu``, checked against the library
#: before its first launch): A-block width KB (the MMA depth: m16n8k8 TF32,
#: m16n8k16 bf16), the largest k, the least band offset REL_MIN, and the
#: block tile's rows and columns; the warp tile is MXU_WARP_COLS wide
MXU_LAYOUT = {torch.float32: (8, 8, 0, 64, 128),
              torch.bfloat16: (16, 16, -8, 128, 128)}
#: the bf16 pass of the bf16 interior math, per storage dtype (``Mx16<T>``,
#: the same fields): m16n8k16 on the f32-compute form's block tile, so both
#: passes, and a shard's tiles, start where the whole grid's do
MXU_LAYOUT_BF16 = {torch.float32: (16, 16, -8, 64, 128),
                   torch.bfloat16: (16, 16, -8, 128, 128)}
MXU_WARP_COLS = 32

_launch_count = {f: 0 for f in FORMS}
_halo_launch_count = {f: 0 for f in FORMS}


def launches(form: Optional[str] = None) -> int:
    """K3 launches made by this module since the last reset (of ``form``,
    or of both)."""
    return (sum(_launch_count.values()) if form is None
            else _launch_count[form])


def halo_launches(form: Optional[str] = None) -> int:
    """K3-halo launches made by this module since the last reset (of
    ``form``, or of both)."""
    return (sum(_halo_launch_count.values()) if form is None
            else _halo_launch_count[form])


def reset_launches() -> None:
    for f in FORMS:
        _launch_count[f] = 0
        _halo_launch_count[f] = 0


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


# -- the vpu form's coefficients ----------------------------------------------

_COEFS_CACHE: dict[tuple, tuple] = {}


def vpu_coefs(rate: float, offsets: Sequence[tuple[int, int]],
              k: int) -> tuple[bool, tuple[float, ...]]:
    """(is_moore, coef_0 .. coef_k) of the binomial form: Moore (the eight
    offsets, any order) ``α = 1 - r - r/8`` with ``B`` the full 3×3 box,
    other neighbourhoods ``α = 1 - r`` with ``B`` the neighbor sum; ``β =
    r/|offsets|``; ``coef_j = C(k,j)·α^(k-j)·β^j`` formed in f64 (the JAX
    hook's Python floats) and rounded to f32 once, as JAX's weakly typed
    scalars are. A coefficient that underflows f32 is 0. Each returned
    float is exactly an f32 value."""
    offsets = check_offsets(offsets)
    k = int(k)
    key = taps_fingerprint(rate, offsets, k)
    cached = _COEFS_CACHE.get(key)
    if cached is None:
        kk = len(offsets)
        moore = set(offsets) == set(MOORE_OFFSETS)
        alpha = 1.0 - rate - rate / kk if moore else 1.0 - rate
        beta = rate / kk
        c64 = [math.comb(k, j) * (alpha ** (k - j)) * (beta ** j)
               for j in range(k + 1)]
        cached = (moore, tuple(float(np.float32(c)) for c in c64))
        _COEFS_CACHE[key] = cached
    return cached


def vpu_coefs_bf16(rate: float, offsets: Sequence[tuple[int, int]],
                   k: int) -> tuple[float, ...]:
    """The vpu form's coefficients under bf16 interior math: each f64
    ``coef_j`` rounded straight to bf16 (``round_bf16``), as the JAX
    hook's weakly typed Python floats are in a bf16 product."""
    offsets = check_offsets(offsets)
    kk = len(offsets)
    moore = set(offsets) == set(MOORE_OFFSETS)
    alpha = 1.0 - rate - rate / kk if moore else 1.0 - rate
    beta = rate / kk
    return tuple(round_bf16(math.comb(int(k), j) * (alpha ** (int(k) - j))
                            * (beta ** j)) for j in range(int(k) + 1))


def _vpu_interior_bf16(region: torch.Tensor, rate: float, offsets: tuple,
                       k: int) -> torch.Tensor:
    """``_vpu_interior`` in bf16 over a region of bf16 values (in f32):
    the same order, every operation rounded to bf16 (``rb``), the
    coefficients of ``vpu_coefs_bf16``; other neighbourhoods sum from 0,
    as the kernel's walk does. Returns bf16 values in f32."""
    moore = set(offsets) == set(MOORE_OFFSETS)
    coefs = vpu_coefs_bf16(rate, offsets, k)
    hh, ww = region.shape
    acc = rb(coefs[0] * region[k:hh - k, k:ww - k])
    cur = region
    for j in range(1, k + 1):
        hs, ws = cur.shape
        if moore:
            band = rb(rb(cur[0:hs - 2, :] + cur[1:hs - 1, :]) + cur[2:hs, :])
            cur = rb(rb(band[:, 0:ws - 2] + band[:, 1:ws - 1])
                     + band[:, 2:ws])
        else:
            nxt = torch.zeros_like(cur[1:hs - 1, 1:ws - 1])
            for dx, dy in offsets:
                nxt = rb(nxt + cur[1 + dx:hs - 1 + dx, 1 + dy:ws - 1 + dy])
            cur = nxt
        m = k - j
        hs, ws = cur.shape
        acc = rb(acc + rb(coefs[j] * cur[m:hs - m, m:ws - m]))
    return acc


def _tap_interior_bf16(region: torch.Tensor, rate: float, offsets: tuple,
                       k: int) -> torch.Tensor:
    """The tap correlation as the JAX mxu hook runs it in bf16: the window
    (bf16 values in f32) against the f32 table rounded to bf16, the
    products (exact in f32) accumulated in f32 from zero in row-major tap
    order."""
    taps = rb(device_taps(rate, offsets, k, torch.float32, region.device))
    hh, ww = region.shape
    ih, iw = hh - 2 * k, ww - 2 * k
    acc = torch.zeros((ih, iw), dtype=torch.float32, device=region.device)
    for dr in range(2 * k + 1):
        for dc in range(2 * k + 1):
            acc = acc + taps[dr, dc] * region[dr:dr + ih, dc:dc + iw]
    return acc


def _vpu_interior(region: torch.Tensor, rate: float, offsets: tuple,
                  k: int) -> torch.Tensor:
    """The binomial sum over the f32 ``[hh, ww]`` region, for its
    ``[hh - 2k, ww - 2k]`` centre: ``acc = coef_0·v``, then for j = 1..k
    ``cur = B(cur)`` (Moore ``band = (c[r-1] + c[r]) + c[r+1]``, ``(band[c-1]
    + band[c]) + band[c+1]``; else the neighbours in ``offsets`` order) and
    ``acc = acc + coef_j·cur``, each operation rounded once."""
    moore, coefs = vpu_coefs(rate, offsets, k)
    hh, ww = region.shape
    acc = coefs[0] * region[k:hh - k, k:ww - k]
    cur = region
    for j in range(1, k + 1):
        hs, ws = cur.shape
        if moore:
            band = cur[0:hs - 2, :] + cur[1:hs - 1, :] + cur[2:hs, :]
            cur = band[:, 0:ws - 2] + band[:, 1:ws - 1] + band[:, 2:ws]
        else:
            nxt = None
            for dx, dy in offsets:
                t = cur[1 + dx:hs - 1 + dx, 1 + dy:ws - 1 + dy]
                nxt = t if nxt is None else nxt + t
            cur = nxt
        m = k - j
        hs, ws = cur.shape
        acc = acc + coefs[j] * cur[m:hs - m, m:ws - m]
    return acc


def _tap_interior(region: torch.Tensor, rate: float, offsets: tuple,
                  k: int) -> torch.Tensor:
    """The ``(2k+1)²`` tap correlation over the f32 region, for its centre:
    the f32 table, accumulated from zero in row-major tap order."""
    taps = device_taps(rate, offsets, k, torch.float32, region.device)
    hh, ww = region.shape
    ih, iw = hh - 2 * k, ww - 2 * k
    n = 2 * k + 1
    acc = torch.zeros((ih, iw), dtype=torch.float32, device=region.device)
    for dr in range(n):
        for dc in range(n):
            acc = acc + taps[dr, dc] * region[dr:dr + ih, dc:dc + iw]
    return acc


def _interior(form: str, bf16: bool = False):
    if form not in FORMS:
        raise ValueError(f"the plain versions take a resolved form "
                         f"{FORMS}, got {form!r}")
    if bf16:
        return _vpu_interior_bf16 if form == "vpu" else _tap_interior_bf16
    return _vpu_interior if form == "vpu" else _tap_interior


# -- the mxu form's B table ----------------------------------------------------

def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 → the nearest TF32 value, ties away from zero (``cvt.rna``)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → bf16 bits (uint32, low half), rounded to nearest even."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(
        np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint32)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def mxu_blocks(rate: float, offsets: Sequence[tuple[int, int]], k: int,
               dtype) -> np.ndarray:
    """The banded tap blocks of the mxu form, f32 ``[2k+1, NB, KB, 8]``:
    block q of row offset dr is ``B[m, c] = taps[dr][rel + m - c]`` on
    ``0 <= rel + m - c <= 2k`` (else 0), ``rel = REL_MIN + 8q``, the offset
    of an A block's first column from an n8 tile's; NB covers every offset
    that meets the band at the dtype's largest k."""
    kb, kmax, rel_min = MXU_LAYOUT[dtype][:3]
    nb = (2 * kmax + 7 - rel_min) // 8 + 1
    taps = np.asarray(composed_taps(rate, offsets, k), np.float32)
    out = np.zeros((2 * k + 1, nb, kb, 8), np.float32)
    m = np.arange(kb)[:, None]
    c = np.arange(8)[None, :]
    for q in range(nb):
        d = rel_min + 8 * q + m - c
        ok = (d >= 0) & (d <= 2 * k)
        out[:, q] = np.where(ok[None], taps[:, np.clip(d, 0, 2 * k)], 0.0)
    return out


_FRAGS: dict[tuple, torch.Tensor] = {}


def mxu_fragments(rate: float, offsets: Sequence[tuple[int, int]], k: int,
                  dtype) -> np.ndarray:
    """The mxu kernel's B table, uint32 ``[2k+1, NB, 2, 32, 2]``: each
    block of ``mxu_blocks`` split in two terms and laid out as mma.sync's B
    fragment, per lane (``g = lane // 4``, ``t = lane % 4``) two registers.
    f32 storage (m16n8k8 TF32): the terms ``hi = tf32(b)`` and ``lo =
    tf32(b - hi)``, registers ``B[t, g]``, ``B[t + 4, g]``. bf16 (m16n8k16):
    ``t0 = bf16(b)``, ``t1 = bf16(b - t0)``, registers holding the pairs
    ``B[2t, g] | B[2t + 1, g] << 16`` and ``B[2t + 8, g] | B[2t + 9, g] <<
    16``."""
    blocks = mxu_blocks(rate, offsets, k, dtype)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    if dtype == torch.float32:
        hi = _tf32(blocks)
        lo = _tf32(blocks - hi)
        terms = [x.view(np.uint32) for x in (hi, lo)]
        regs = [[x[..., t, g], x[..., t + 4, g]] for x in terms]
    else:
        b0 = _bf16_bits(blocks)
        b1 = _bf16_bits(blocks - _bf16_value(b0))

        def pair(x, r):
            return x[..., r, g] | (x[..., r + 1, g] << np.uint32(16))

        regs = [[pair(x, 2 * t), pair(x, 2 * t + 8)] for x in (b0, b1)]
    # [2k+1, NB, term, lane, reg]
    return np.ascontiguousarray(np.stack(
        [np.stack(r, axis=-1) for r in regs], axis=2).astype(np.uint32))


def mxu_fragments16(rate: float, offsets: Sequence[tuple[int, int]],
                    k: int) -> np.ndarray:
    """The bf16 pass's B table, uint32 ``[2k+1, NB, 32, 2]``: the first
    term of ``mxu_fragments(..., torch.bfloat16)`` (the taps rounded to
    bf16), the only one the pass reads. The kernel copies it into shared
    memory once a block."""
    return np.ascontiguousarray(
        mxu_fragments(rate, offsets, k, torch.bfloat16)[:, :, 0])


def device_fragments(rate: float, offsets, k: int, dtype, device,
                     one_term: bool = False) -> torch.Tensor:
    """``mxu_fragments`` (``one_term``: ``mxu_fragments16``) on ``device``
    (as int32), cached."""
    key = (taps_fingerprint(rate, offsets, k), str(dtype), str(device),
           one_term)
    t = _FRAGS.get(key)
    if t is None:
        table = (mxu_fragments16(rate, offsets, k) if one_term
                 else mxu_fragments(rate, offsets, k, dtype))
        t = torch.from_numpy(table.view(np.int32)).to(device).contiguous()
        _FRAGS[key] = t
    return t


# -- variant and k selection -------------------------------------------------

def _resolve_variant(variant: str, k: int, bw: int) -> str:
    if variant not in ("auto", "vpu", "mxu"):
        raise ValueError(f"unknown composed variant {variant!r}")
    if variant == "auto":
        return ("mxu" if (2 * k + 1) >= MXU_MIN_TAPS and bw % LANE == 0
                else "vpu")
    return variant


def resolve_form(variant: str, k: int, bw: int) -> str:
    """The form ``variant`` runs at block width ``bw``: JAX's rule, and its
    refusal of ``"mxu"`` at a width that is not 128-aligned."""
    form = _resolve_variant(variant, k, bw)
    if form == "mxu" and bw % LANE != 0:
        raise ValueError(
            f"the MXU composed variant contracts per {LANE}-lane "
            f"output block; block width {bw} is not a multiple "
            f"of {LANE} (use variant='vpu' or a {LANE}-aligned "
            "block)")
    return form


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


# -- the plain versions --------------------------------------------------------

def composed_dense_step_plain(values: torch.Tensor, rate: float, k: int,
                              offsets: Sequence[tuple[int, int]]
                              = MOORE_OFFSETS,
                              variant: str = "mxu", compute_dtype=None,
                              block: Optional[tuple[int, int]] = None
                              ) -> torch.Tensor:
    """The plain torch version of K3, in f32: cells within k of the global
    edge (distance <= k) take ``exact_dense_step_plain(..., k)`` (K1's
    iterated exact path); every other cell the resolved form ``variant``
    (``"vpu"``: the binomial sum; ``"mxu"``: the tap correlation with the
    f32 table, accumulated from zero in row-major tap order). Cast back to
    the storage dtype once.

    ``compute_dtype=torch.bfloat16``: the cells of ``bf16_rect`` (JAX's
    interior tiles of ``block``, or of the block JAX picks) take the form
    in bf16; every other cell the f32 version over the grid rounded to
    bf16 once."""
    offsets = check_offsets(offsets)
    k = int(k)
    interior = _interior(variant)
    h, w = values.shape
    if resolve_compute_dtype(compute_dtype) is not None:
        v = rb(values.to(torch.float32))
        out = with_bf16_rect(
            composed_dense_step_plain(v, rate, k, offsets, variant),
            lambda: _interior(variant, True)(F.pad(v, (k, k, k, k)), rate,
                                             offsets, k),
            (h, w), values.dtype, block, k)
        return out.to(values.dtype)
    v = values.to(torch.float32)
    out = exact_dense_step_plain(v, rate, offsets, k)
    m = k + 1  # the first row/column the composed operator is exact on
    if h - 2 * m > 0 and w - 2 * m > 0:
        out[m:h - m, m:w - m] = interior(v[1:h - 1, 1:w - 1], rate, offsets,
                                         k)
    return out.to(values.dtype)


def composed_halo_step_plain(values: torch.Tensor,
                             ring: Mapping[str, torch.Tensor],
                             origin: tuple[int, int],
                             global_shape: tuple[int, int], rate: float,
                             k: int,
                             offsets: Sequence[tuple[int, int]]
                             = MOORE_OFFSETS,
                             variant: str = "mxu", compute_dtype=None,
                             block: Optional[tuple[int, int]] = None
                             ) -> torch.Tensor:
    """The plain torch version of K3-halo, in f32: the padded shard from the
    ring, masked to the grid; cells within k of the GLOBAL edge take
    ``halo_step_plain``'s iterated steps, every other cell the resolved
    form ``variant``, as ``composed_dense_step_plain`` computes it. Cast
    back once. Shards stepped so and put together equal
    ``composed_dense_step_plain`` bit for bit.

    ``compute_dtype=torch.bfloat16``: as ``composed_dense_step_plain``,
    with the shard's TPU tiles (``block``, or the block JAX picks for the
    shard) at its global origin."""
    offsets = check_offsets(offsets)
    k = int(k)
    interior = _interior(variant)
    h, w = values.shape
    d = int(ring["n"].shape[0])
    if resolve_compute_dtype(compute_dtype) is not None:
        vr = rb(values.to(torch.float32))
        ringr = {p: rb(t.to(torch.float32)) for p, t in ring.items()}
        def acc():
            _, mask, _ = padded_region(vr, ringr, origin, global_shape,
                                       offsets)
            v = torch.where(mask, pad_from_ring(vr, ringr), 0.0)
            return _interior(variant, True)(
                v[d - k:d + h + k, d - k:d + w + k], rate, offsets, k)

        out = with_bf16_rect(
            composed_halo_step_plain(vr, ringr, origin, global_shape, rate,
                                     k, offsets, variant),
            acc, (h, w), values.dtype, block, k, origin, global_shape)
        return out.to(values.dtype)
    org, mask, cnt = padded_region(values, ring, origin, global_shape,
                                   offsets)
    v = torch.where(mask, pad_from_ring(values, ring).to(torch.float32), 0.0)
    out = exact_steps_plain(v, cnt, rate, offsets, k, mask)[d:d + h,
                                                            d:d + w]
    acc = interior(v[d - k:d + h + k, d - k:d + w + k], rate, offsets, k)
    m = k + 1  # the first global row/column the composed operator holds on
    gh, gw = global_shape
    rows = org[0] + d + torch.arange(h, device=values.device)[:, None]
    cols = org[1] + d + torch.arange(w, device=values.device)[None, :]
    inner = (rows >= m) & (rows < gh - m) & (cols >= m) & (cols < gw - m)
    return torch.where(inner, acc, out).to(values.dtype)


# -- the kernels ---------------------------------------------------------------

def _kernel_lib():
    from ._build import load

    lib = load("composed_stencil")
    if not getattr(lib, "_mm_typed", False):
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fp = ctypes.POINTER(ctypes.c_float)
        for dt in ("f32", "bf16"):
            bf = [i] * 5  # the bf16 interior math: on, its rectangle
            fn = getattr(lib, f"mm_composed_vpu_{dt}")
            fn.argtypes = [p, p, i, i, f, f, i, i, i, i, i, fp] + bf + [fp, p]
            fn = getattr(lib, f"mm_composed_mxu_{dt}")
            fn.argtypes = [p, p, i, i, f, f, i, i, i, i, p] + bf + [p, p]
            fn = getattr(lib, f"mm_composed_halo_vpu_{dt}")
            fn.argtypes = [p, p, f, f, i, i, i, i, i, fp] + bf + [fp, p]
            fn = getattr(lib, f"mm_composed_halo_mxu_{dt}")
            fn.argtypes = [p, p, f, f, i, i, i, i, p] + bf + [p, p]
            for form in FORMS:
                for mode in ("", "halo_"):
                    getattr(lib, f"mm_composed_{mode}{form}_{dt}").restype = i
        lib.mm_cuda_error_string.argtypes = [i]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib.mm_composed_vpu_bf16_plan.argtypes = [i] * 15 + [
            ctypes.POINTER(i)]
        lib.mm_composed_vpu_bf16_plan.restype = i
        lib.mm_composed_mxu_layout.argtypes = [i, ctypes.POINTER(i)]
        lib.mm_composed_mxu_layout.restype = None
        for which, (what, layout) in enumerate(
                (f"{d}", MXU_LAYOUT[d]) if n == 0 else
                (f"{d} bf16 interior", MXU_LAYOUT_BF16[d])
                for n in (0, 1) for d in (torch.float32, torch.bfloat16)):
            kb, kmax, rel_min, bh, bw = layout
            got = (i * 7)()
            lib.mm_composed_mxu_layout(which, got)
            want = (kb, kmax, rel_min, (2 * kmax + 7 - rel_min) // 8 + 1,
                    MXU_WARP_COLS, bh, bw)
            if tuple(got) != want:
                raise KernelError(f"composed_stencil's mxu layout for "
                                   f"{what} is {tuple(got)}, the wrapper's "
                                   f"{want}")
        lib._mm_typed = True
    return lib


_COEF_ARRAYS: dict[tuple, ctypes.Array] = {}


def _coef_array(coefs: tuple, key: tuple) -> ctypes.Array:
    arr = _COEF_ARRAYS.get(key)
    if arr is None:
        arr = _COEF_ARRAYS[key] = (ctypes.c_float * len(coefs))(*coefs)
    return arr


def _form_args(form: str, rate: float, offsets: tuple, k: int, dtype,
               device, rect: Optional[tuple] = None) -> tuple:
    """The launch arguments after the geometry: ``rate``, ``1 - rate``, k,
    the neighbourhood (bitmask, size, ordered codes), then ``moore`` and
    the host coefficients (vpu) or the device B table (mxu); then the bf16
    interior math: whether it is on, the global rows and columns of its
    cells (``rect``), and the bf16 coefficients (vpu) or the bf16 pass's
    one-term B table (mxu, ``mxu_fragments16``: the taps rounded to
    bf16)."""
    common = (float(rate), float(1.0 - rate), int(k), _offset_mask(offsets),
              len(offsets), _offset_codes(offsets))
    bf = (int(rect is not None),) + (rect if rect is not None
                                     else (0, 0, 0, 0))
    key = taps_fingerprint(rate, offsets, k)
    if form == "vpu":
        moore, coefs = vpu_coefs(rate, offsets, k)
        arr16 = (_coef_array(vpu_coefs_bf16(rate, offsets, k), key + ("bf16",))
                 if rect is not None else None)
        return common + (int(moore), _coef_array(coefs, key)) + bf + (arr16,)
    table16 = (device_fragments(rate, offsets, k, torch.bfloat16, device,
                                one_term=True).data_ptr()
               if rect is not None else None)
    return common + (device_fragments(rate, offsets, k, dtype,
                                      device).data_ptr(),) + bf + (table16,)


def _what(form: str, dt: str, k: int, rect: Optional[tuple],
          mode: str = "", offsets: tuple = MOORE_OFFSETS) -> str:
    """A launch's name in its errors: form, storage dtype, k and, with
    bf16 interior math, that (vpu: each launch's kernel and window rows)."""
    if rect is None:
        return f"composed_stencil {form} {mode}kernel ({dt}, k={k})"
    if form != "vpu":
        return (f"composed_stencil {form} {mode}kernel ({dt}, k={k}, bf16 "
                "interior math)")
    (rows, off), (rows16, off16) = (window_rows(k, offsets),
                                    paired_rows(k, offsets))
    halo = "halo_" if mode else ""
    return (f"composed_stencil vpu {mode}kernel ({dt}, k={k}, bf16 interior "
            f"math: near launch composed_vpu_{halo}near_kernel {rows} rows "
            f"OFF {off}, paired launch composed_vpu16_{halo}kernel "
            f"{rows16} rows OFF {off16})")


# -- the vpu form's bf16 interior math: two launches ----------------------------
#
# Mirrors of the source's geometry (``csrc/composed_stencil.cu``:
# ``vpu_window``, ``paired_window``; the split and the tilings are
# ``fused_stencil.bf16_regions`` and ``region_tiles`` with the row halo OFF),
# for the tests and the bounds; ``kernel_plan`` reads the source's own.

#: the paired launch's window rows for Moore, by the row halo OFF (the
#: source's ``kPairedRows2``, ``kPairedRows8``, ``kPairedRows16``), chosen
#: by measurement on the H100 (``k3_variants.py``, ``PERF.md``)
PAIRED_ROWS = {2: 64, 8: 96, 16: 96}


def window_rows(k: int, offsets: Sequence[tuple[int, int]]
                ) -> tuple[int, int]:
    """The f32 walk's window ``(rows, OFF)`` (f32 interior math, and the
    bf16 interior math's near launch): Moore ``(48, 8)`` up to k = 8 and
    ``(64, 16)`` above; other neighbourhoods ``(48, 16)``."""
    if set(check_offsets(offsets)) != set(MOORE_OFFSETS):
        return 48, 16
    return (48, 8) if int(k) <= 8 else (64, 16)


def paired_rows(k: int, offsets: Sequence[tuple[int, int]]
                ) -> tuple[int, int]:
    """The paired launch's window ``(rows, OFF)``: Moore on row pairs at
    ``PAIRED_ROWS[OFF]`` with OFF the least of 2, 8 and 16 at least k (the
    pairs, their kept bands and the accumulator's pairs within the 128
    registers of two blocks an SM); other neighbourhoods the f32 walk's
    ``(48, 16)`` with every operation rounded."""
    if set(check_offsets(offsets)) != set(MOORE_OFFSETS):
        return 48, 16
    off = min(o for o in PAIRED_ROWS if o >= int(k))
    return PAIRED_ROWS[off], off


def kernel_plan(shape: tuple[int, int], rect: tuple, k: int, dtype,
                offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                origin: tuple[int, int] = (0, 0),
                global_shape: Optional[tuple[int, int]] = None
                ) -> tuple[tuple[int, int], tuple[int, int], list[tuple]]:
    """The two launches' geometry as the CUDA source computes it for a vpu
    bf16-interior call on a ``shape`` array at ``origin`` of
    ``global_shape`` (``rect``: global, as ``kernel_rect`` gives it): the
    near launch's ``(rows, OFF)``, the paired launch's, and for the paired
    region and the four bands ``(r0, r1, c0, c1, tiles)``. It launches
    nothing but needs the built library (the card): tests and
    ``chip_smoke.py`` hold ``window_rows``, ``paired_rows`` and the region
    tiles to it."""
    offsets = check_offsets(offsets)
    lib = _kernel_lib()
    out = (ctypes.c_int * 29)()
    h, w = shape
    H, W = global_shape or shape
    moore = int(set(offsets) == set(MOORE_OFFSETS))
    err = lib.mm_composed_vpu_bf16_plan(
        h, w, origin[0], origin[1], H, W, int(dtype == torch.bfloat16),
        int(k), _offset_mask(offsets), len(offsets), moore, *rect, out)
    if err != 0:
        raise ValueError(f"mm_composed_vpu_bf16_plan refused {shape} at "
                         f"{origin}, k={k}: "
                         f"{lib.mm_cuda_error_string(err).decode()}")
    return ((out[0], out[1]), (out[2], out[3]),
            [tuple(out[4 + 5 * i:9 + 5 * i]) for i in range(5)])


def plan_of(shape: tuple[int, int], rect: tuple, k: int,
            offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
            origin: tuple[int, int] = (0, 0)
            ) -> tuple[tuple[int, int], tuple[int, int], list[tuple]]:
    """``kernel_plan`` from the mirrors (``window_rows``, ``paired_rows``,
    ``bf16_regions``, ``region_tiles``), without the library: the same
    tuple the source gives when the mirrors hold."""
    local = (rect[0] - origin[0], rect[1] - origin[0], rect[2] - origin[1],
             rect[3] - origin[1])
    inner, bands = bf16_regions(shape, local)
    (rows, off), (rows16, off16) = window_rows(k, offsets), paired_rows(
        k, offsets)
    return ((rows, off), (rows16, off16),
            [(*inner, len(region_tiles(inner, rows16, k, off16))),
             *((*b, len(region_tiles(b, rows, k, off))) for b in bands)])


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise KernelError(
            f"{what} launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")


def _launch(values: torch.Tensor, out: torch.Tensor, rate: float,
            offsets: tuple, k: int, form: str,
            stepper: Optional["ComposedDiffusionStep"] = None,
            rect: Optional[tuple] = None) -> None:
    """Launch K3's ``form`` on the current stream; raises on any launch
    error. Counts the launch, module-wide and on ``stepper``, once the
    kernel is queued."""
    if values.numel() == 0:
        return
    lib = _kernel_lib()
    dt = "f32" if values.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"mm_composed_{form}_{dt}")
    args = _form_args(form, rate, offsets, k, values.dtype, values.device,
                      rect)
    h, w = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), out.data_ptr(), h, w, *args, stream)
    _raise_on(lib, err, _what(form, dt, k, rect, offsets=offsets))
    _launch_count[form] += 1
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
    cells by the resolved variant's form (algebraically equal, ~k ulp
    apart), the edge band by the exact iterated path. ``out`` (CUDA only)
    receives the result and must not alias ``values``."""
    return _composed_step(values, rate, k, offsets, block, variant,
                          compute_dtype, out)


def _check_call(values, k, compute_dtype) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    resolve_compute_dtype(compute_dtype)
    if values.dim() != 2:
        raise ValueError(f"values must be [H, W], got shape "
                         f"{tuple(values.shape)}")
    if values.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"the composed filter takes float32 or bfloat16 grids, got "
            f"{values.dtype}; float64 stays on the plain path "
            "(impl='xla')")
    return k


def _composed_step(values, rate, k, offsets, block, variant, compute_dtype,
                   out, stepper: Optional["ComposedDiffusionStep"] = None):
    offsets = check_offsets(offsets)
    k = _check_call(values, k, compute_dtype)
    h, w = values.shape
    blk = resolve_block((h, w), values.dtype, block)
    form = resolve_form(variant, k, blk[1])
    check_nsteps(k, blk, values.dtype)
    if values.device.type == "cpu":
        res = plain_version("K3", composed_dense_step_plain, values, rate,
                            k, offsets, form, compute_dtype, blk)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    out = check_out(values, out)
    _launch(values, out, float(rate), offsets, k, form, stepper,
            kernel_rect((h, w), values.dtype, blk, k, compute_dtype))
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
    takes ``composed_halo_step_plain`` with the resolved form; a CUDA shard
    launches that form's kernel or raises."""
    offsets = check_offsets(offsets)
    k = _check_call(values, k, compute_dtype)
    d = check_ring(values, ring)
    blk = check_ring_depth(d, tuple(values.shape), values.dtype, block)
    if k > d:
        raise ValueError(
            f"k={k} needs a ghost ring at least that deep; got depth {d} "
            f"(exchange_ring(..., depth={k}))")
    form = resolve_form(variant, k, blk[1])
    if values.device.type == "cpu":
        res = plain_version("K3-halo", composed_halo_step_plain, values,
                            ring, origin, global_shape, rate, k, offsets,
                            form, compute_dtype, blk)
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
    dt = "f32" if values.dtype == torch.float32 else "bf16"
    fn = getattr(lib, f"mm_composed_halo_{form}_{dt}")
    args = halo_args(values, ring, origin, global_shape)
    rect = kernel_rect(tuple(values.shape), values.dtype, blk, k,
                       compute_dtype, origin, global_shape)
    fargs = _form_args(form, float(rate), offsets, k, values.dtype,
                       values.device, rect)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(ctypes.addressof(args), out.data_ptr(), *fargs, stream)
    _raise_on(lib, err, _what(form, dt, k, rect, "halo ", offsets))
    _halo_launch_count[form] += 1
    return out


class ComposedDiffusionStep:
    """Reusable composed stepper bound to one geometry and rate: each call
    advances ``k`` flow steps in one pass. ``launches`` counts its K3
    launches; ``variant`` is the variant asked for (checked as the JAX
    package checks it) and ``form`` the one it resolves to, which the
    kernel runs."""

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
        self.form = resolve_form(variant, self.k, bw)
        self.variant = variant

    def __call__(self, values: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _composed_step(values, self.rate, self.k, self.offsets,
                              self.block, self.variant, self.compute_dtype,
                              out, self)


# -- operation counts (the bounds chip_smoke.py reports) -----------------------

def composed_cells(shape: tuple[int, int], k: int, origin=(0, 0),
                   global_shape=None) -> int:
    """Cells of the ``[h, w]`` region at global ``origin`` that take the
    composed form: distance to the global grid's edge above k."""
    (h, w), (r0, c0) = shape, origin
    gh, gw = global_shape if global_shape is not None else shape
    rows = max(0, min(r0 + h, gh - 1 - k) - max(r0, k + 1))
    cols = max(0, min(c0 + w, gw - 1 - k) - max(c0, k + 1))
    return rows * cols


def vpu_ops(shape: tuple[int, int], k: int,
            offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
            origin=(0, 0), global_shape=None) -> float:
    """f32 operations of one call in the vpu form, the cheapest exact form
    of S^k: per composed cell k sums (Moore: 2 band and 2 box adds; else
    |offsets| - 1 adds), k + 1 multiplies and k adds; per edge cell k exact
    steps of |offsets| + 3 (share: multiply and divide; |offsets| - 1
    gather adds; keep-multiply and add)."""
    offsets = check_offsets(offsets)
    inner = composed_cells(shape, k, origin, global_shape)
    moore = set(offsets) == set(MOORE_OFFSETS)
    box = 4 if moore else len(offsets) - 1
    edge = shape[0] * shape[1] - inner
    return float(inner * (k * box + 2 * k + 1)
                 + edge * k * (len(offsets) + 3))


def _mxu_pairs(layout: tuple, k: int) -> int:
    """(A block, n8 tile) pairs of one warp tile and row offset in
    ``layout`` at k: the MMA groups whose band the A block meets."""
    kb, kmax, rel_min = layout[:3]
    nb = (2 * kmax + 7 - rel_min) // 8 + 1
    na = -(-(MXU_WARP_COLS + 2 * kmax) // kb)
    return sum(1 for a in range(na) if a * kb < MXU_WARP_COLS + 2 * k
               for nt in range(MXU_WARP_COLS // 8)
               if rel_min <= a * kb - 8 * nt <= 2 * k + 7
               and (a * kb - 8 * nt - rel_min) // 8 < nb)


def mxu_mma_flops(shape: tuple[int, int], k: int, dtype, origin=(0, 0),
                  global_shape=None, rect: Optional[tuple] = None
                  ) -> dict[str, float]:
    """Tensor-core flops of one mxu call by the MMAs' input type (``"tf32"``,
    ``"bf16"``), on the layout that runs: every block tile (``MXU_LAYOUT``'s
    rows and columns, aligned to the global grid) runs, per 16 x
    MXU_WARP_COLS cells and row offset, one MMA group for each A block and
    n8 tile whose band it meets. f32 compute (``rect`` None): 3 m16n8k8
    TF32 MMAs of 2·16·8·8 flops a group (f32 storage), 2 m16n8k16 of
    2·16·8·16 (bf16). bf16 interior math (``rect``, the global rows and
    columns of its cells, ``fused_stencil.kernel_rect``'s): a tile whose
    part of the array meets the rectangle runs the bf16 pass
    (``MXU_LAYOUT_BF16``, one m16n8k16 a group: the taps' first term), and
    one that does not lie in it the f32 pass: 2 TF32 MMAs a group at f32
    storage (the window's low term is 0), 2 bf16 at bf16 storage."""
    kb, kmax, rel_min, bh, bw = MXU_LAYOUT[dtype]
    f32 = dtype == torch.float32
    kind = "tf32" if f32 else "bf16"
    per_mma = 2 * 16 * 8 * kb
    (h, w), (r0, c0) = shape, origin
    tr0, tc0 = r0 // bh, c0 // bw
    tiles_r = -(-(r0 + h) // bh) - tr0
    tiles_c = -(-(c0 + w) // bw) - tc0
    per_tile = (bh // 16) * (bw // MXU_WARP_COLS) * (2 * k + 1)
    if rect is None:
        return {kind: float(tiles_r * tiles_c * per_tile
                            * _mxu_pairs(MXU_LAYOUT[dtype], k)
                            * (3 if f32 else 2) * per_mma)}
    q0, q1, p0, p1 = rect
    meets = inside = 0
    for i in range(tr0, tr0 + tiles_r):
        ar0, ar1 = max(i * bh, r0), min((i + 1) * bh, r0 + h)
        rows = max(0, min(ar1, q1) - max(ar0, q0))
        for j in range(tc0, tc0 + tiles_c):
            ac0, ac1 = max(j * bw, c0), min((j + 1) * bw, c0 + w)
            cols = max(0, min(ac1, p1) - max(ac0, p0))
            meets += rows * cols > 0
            inside += rows * cols == (ar1 - ar0) * (ac1 - ac0)
    tiles = tiles_r * tiles_c
    bf16 = float(meets * per_tile * _mxu_pairs(MXU_LAYOUT_BF16[dtype], k)
                 * 2 * 16 * 8 * 16)
    rest = float((tiles - inside) * per_tile
                 * _mxu_pairs(MXU_LAYOUT[dtype], k) * 2 * per_mma)
    return {"tf32": rest, "bf16": bf16} if f32 else {"bf16": bf16 + rest}


def mxu_tensor_flops(shape: tuple[int, int], k: int, dtype, origin=(0, 0),
                     global_shape=None, rect: Optional[tuple] = None
                     ) -> float:
    """Tensor-core flops of one mxu call, every type together
    (``mxu_mma_flops``)."""
    return sum(mxu_mma_flops(shape, k, dtype, origin, global_shape,
                             rect).values())
