"""K6 and K7, the fused active-tile pass: wrappers, plain versions and the
whole-run runner (counterpart of ``mpi_model_tpu/ops/pallas_active.py``).

The active-tile engine (``ops/active.py``) with its per-tile update moved
into two hand-written kernels (``csrc/fused_active.cu``):

- **K6** (``fused_compute``) runs over the ``capacity`` lanes; a lane reads
  the live count from device memory and does nothing at or past
  ``clip(count, 1, K)``, so the host never sizes the launch. Each live lane
  advances its tile's ring-``k`` window ``k`` steps and emits ``upd[l]`` and
  the any-nonzero flag ``anyf[l]``. At ``k > 1`` interior tiles whose own
  cells were nonzero take the composed tap table; near-edge and frontier
  tiles take the exact iterated path.
- **K7** (``fused_scatter``) lands ``upd[l]`` in the padded state for the
  live lanes. It is a separate launch, so every K6 window reads the values
  from before the pass.

A CPU tensor takes the plain versions (``fused_compute_plain``,
``fused_scatter_plain``); a CUDA tensor launches the kernels or raises.
Both compute in the storage dtype with the plain step's operation order,
so at k=1 a pass equals ``ops.active.active_pass`` (and the dense step) bit
for bit at f32 and f64, and the kernel equals its plain version bit for bit
at every dtype (bf16 rounds after every operation on both sides).

The runner reads the dilated count on the host once per pass (the dense
fallback decision); the kernels themselves read the count on the device.
The port updates the padded state in place.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.cell import MOORE_OFFSETS
from .active import (
    ActivePlan,
    compact_tile_ids,
    dilate_tile_map,
    next_tile_map,
    plan_for,
    run_dense_fallback,
    tile_nonzero_map,
    window_counts,
    window_index,
    dense_transport_step,
)
from .composed_stencil import composed_taps
from .fused_stencil import _offset_codes, _offset_mask
from .stencil import neighbor_counts, transport

#: hard cap on the composed pass depth (the window is (th+2k, tw+2k); also
#: bounds the tap table at 33² taps)
MAX_FUSED_K = 16
#: storage dtypes the kernels take; the math runs in the storage dtype
KERNEL_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
#: K6 cuts each lane's tile into SUB x SUB sub-tiles, one block each
SUB = 32
#: shared memory one block may use on the H100 (232,448 bytes)
SMEM_LIMIT = 232448

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_launches = {"fused_compute": 0, "fused_scatter": 0}
_KERNEL_TAPS: dict[tuple, torch.Tensor] = {}


def launches(name: Optional[str] = None):
    """Launches since the last reset: of ``"fused_compute"`` (K6) or
    ``"fused_scatter"`` (K7), or both as a dict."""
    return dict(_launches) if name is None else _launches[name]


def reset_launches() -> None:
    for key in _launches:
        _launches[key] = 0


def choose_fused_k(substeps: int, plan: ActivePlan) -> int:
    """Largest divisor of ``substeps`` with ``k <= min(th, tw)`` (mass moves
    k cells a pass and must not cross a whole tile) and
    ``k <= MAX_FUSED_K``; 1 when there is none."""
    substeps = int(substeps)
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    cap = min(plan.tile[0], plan.tile[1], MAX_FUSED_K)
    for k in range(min(substeps, cap), 0, -1):
        if substeps % k == 0:
            return k
    return 1


def pass_count(steps: int, k: int) -> int:
    """Passes per attribute for ``steps`` flow steps at depth ``k``:
    ``steps // k`` full passes plus ``steps % k`` depth-1 passes, so
    ``flags_fused + fallback_steps == pass_count(n, k) × live attrs``."""
    steps, k = int(steps), int(k)
    return steps // k + steps % k


def _fused_taps(rate: float, offsets: tuple, k: int) -> Optional[np.ndarray]:
    """The composed tap table for the interior form (None at k=1, which
    must stay the explicit, bitwise expression)."""
    if k <= 1:
        return None
    return composed_taps(rate, offsets, k)


def smem_bytes(dtype, tile: tuple[int, int], k: int) -> int:
    """K6's dynamic shared memory for one block: two ring-k sub-tile
    windows in the compute type (f64 for float64, else f32)."""
    item = 8 if dtype == torch.float64 else 4
    sh, sw = min(SUB, tile[0]), min(SUB, tile[1])
    return 2 * (sh + 2 * k) * (sw + 2 * k) * item


def _origin(origin) -> tuple[int, int]:
    if isinstance(origin, torch.Tensor):
        origin = origin.tolist()
    return int(origin[0]), int(origin[1])


def _rate_value(rate, dtype) -> float:
    """``rate`` rounded to the storage dtype, as a Python float."""
    return float(torch.tensor(float(rate), dtype=dtype))


# -- plain versions ----------------------------------------------------------

def fused_compute_plain(padded, ids, count, selfnz, rate, plan: ActivePlan,
                        origin, global_shape: tuple[int, int], offsets,
                        dtype, k: int, ring: int,
                        taps: Optional[np.ndarray] = None):
    """The plain torch version of K6: ``(upd [K, th, tw], anyf [K] int32)``
    for the lanes below ``clip(count, 1, K)`` (later lanes: zero update,
    zero flag), vectorized over lanes, in the storage dtype."""
    (th, tw), (_, gj) = plan.tile, plan.grid
    K = plan.capacity
    H, W = global_shape
    orow, ocol = _origin(origin)
    dev = padded.device
    n = min(max(int(count), 1), K)
    wh, ww = th + 2 * k, tw + 2 * k
    rows, cols = window_index(ids, plan, n, k, ring - k)
    win = padded[rows[:, :, None], cols[:, None, :]]
    rows_g = rows + (orow - ring)
    cols_g = cols + (ocol - ring)
    cnt = window_counts(rows_g, cols_g, global_shape, offsets, dtype)
    mask = (((rows_g >= 0) & (rows_g < H))[:, :, None]
            & ((cols_g >= 0) & (cols_g < W))[:, None, :]).to(dtype)
    rate_c = torch.tensor(rate, dtype=dtype, device=dev)
    cur = win
    for s in range(k):
        hs, ws = cur.shape[1:]
        outflow = rate_c * cur
        share = outflow / cnt[:, s:wh - s, s:ww - s]
        inflow = torch.zeros((n, hs - 2, ws - 2), dtype=dtype, device=dev)
        for dx, dy in offsets:
            inflow = inflow + share[:, 1 + dx:hs - 1 + dx, 1 + dy:ws - 1 + dy]
        cur = (cur[:, 1:hs - 1, 1:ws - 1]
               - outflow[:, 1:hs - 1, 1:ws - 1]) + inflow
        if s < k - 1:
            cur = cur * mask[:, s + 1:wh - s - 1, s + 1:ww - s - 1]
    out = cur
    if taps is not None:
        tt = torch.from_numpy(np.array(taps)).to(device=dev, dtype=dtype)
        acc = torch.zeros((n, th, tw), dtype=dtype, device=dev)
        for dr in range(2 * k + 1):
            for dc in range(2 * k + 1):
                acc = acc + tt[dr, dc] * win[:, dr:dr + th, dc:dc + tw]
        t = ids[:n].to(torch.int64)
        tr0 = orow + t // gj * th
        tc0 = ocol + t % gj * tw
        near = ((tr0 <= k) | (tr0 + th >= H - k)
                | (tc0 <= k) | (tc0 + tw >= W - k))
        exact = near | (selfnz[:n] == 0)
        out = torch.where(exact[:, None, None], cur, acc)
    upd = torch.zeros((K, th, tw), dtype=dtype, device=dev)
    upd[:n] = out
    anyf = torch.zeros(K, dtype=torch.int32, device=dev)
    anyf[:n] = (out != 0).flatten(1).any(dim=1).to(torch.int32)
    return upd, anyf


def fused_scatter_plain(padded, upd, ids, count, plan: ActivePlan,
                        ring: int):
    """The plain torch version of K7: ``upd[l]`` into the padded state at
    tile ``ids[l]`` (offset by ``ring``) for lanes below
    ``clip(count, 1, K)``; in place."""
    n = min(max(int(count), 1), plan.capacity)
    rows, cols = window_index(ids, plan, n, 0, ring)
    padded[rows[:, :, None], cols[:, None, :]] = upd[:n]
    return padded


# -- the kernels -------------------------------------------------------------

def _kernel_lib():
    from ._build import load

    lib = load("fused_active")
    if not getattr(lib, "_mm_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mm_fused_compute.argtypes = [
            i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_double, i, i, i, p]
        lib.mm_fused_compute.restype = i
        lib.mm_fused_scatter.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
        lib.mm_fused_scatter.restype = i
        lib.mm_cuda_error_string.argtypes = [i]
        lib.mm_cuda_error_string.restype = ctypes.c_char_p
        lib._mm_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.mm_cuda_error_string(err).decode()} (cudaError {err})")


def _kernel_taps(taps: np.ndarray, dtype, device) -> torch.Tensor:
    """The table in K6's compute type on ``device``: f64 for float64, f32
    for float32, bf16-rounded values held in f32 for bfloat16 (the table
    the plain version uses, cast as it casts it)."""
    key = (taps.tobytes(), str(dtype), str(device))
    t = _KERNEL_TAPS.get(key)
    if t is None:
        t = torch.from_numpy(np.array(taps)).to(device=device, dtype=dtype)
        if dtype == torch.bfloat16:
            t = t.float()
        t = t.contiguous()
        _KERNEL_TAPS[key] = t
    return t


def _check_int32(name: str, t: torch.Tensor, n: int, device) -> None:
    if (t.dtype != torch.int32 or t.device != device or t.dim() != 1
            or t.shape[0] < n or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 vector of at "
                         f"least {n} entries on {device}")


def fused_compute(padded: torch.Tensor, ids: torch.Tensor,
                  cnt1: torch.Tensor, selfnz: torch.Tensor, *, rate,
                  plan: ActivePlan, origin, global_shape: tuple[int, int],
                  offsets, dtype, k: int, ring: int,
                  taps: Optional[np.ndarray] = None,
                  upd: Optional[torch.Tensor] = None,
                  anyf: Optional[torch.Tensor] = None):
    """K6: ``(upd [K, th, tw], anyf [K] int32)`` for the live lanes. On a
    CUDA tensor it launches the kernel (into ``upd``/``anyf`` when given;
    lanes past the count keep whatever ``upd`` held), else the plain
    version. ``cnt1`` is the live count as an int32 ``[1]`` tensor."""
    offsets = tuple(offsets)
    if padded.device.type == "cpu":
        return fused_compute_plain(padded, ids, cnt1.reshape(-1)[0], selfnz,
                                   rate, plan, origin, global_shape, offsets,
                                   dtype, k, ring, taps)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    if padded.dtype not in KERNEL_DTYPES or padded.dtype != dtype:
        raise TypeError(f"the fused active kernel takes float32, float64 "
                        f"or bfloat16 states of the given dtype; got "
                        f"{padded.dtype} (dtype={dtype})")
    if padded.dim() != 2 or not padded.is_contiguous():
        raise ValueError("padded must be a contiguous [H+2r, W+2r] tensor")
    (th, tw), (_, gj) = plan.tile, plan.grid
    K = plan.capacity
    h, w = plan.shape
    if tuple(padded.shape) != (h + 2 * ring, w + 2 * ring):
        raise ValueError(f"padded has shape {tuple(padded.shape)}, expected "
                         f"{(h + 2 * ring, w + 2 * ring)} for ring {ring}")
    if not 1 <= k <= min(MAX_FUSED_K, ring):
        raise ValueError(f"k={k} must be in [1, min({MAX_FUSED_K}, "
                         f"ring={ring})]")
    need = smem_bytes(dtype, plan.tile, k)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"K6 needs {need} bytes of shared memory per block for "
            f"{str(dtype).removeprefix('torch.')} at k={k}, tile "
            f"{plan.tile}; a block may use {SMEM_LIMIT}")
    dev = padded.device
    for name, t in (("ids", ids), ("selfnz", selfnz)):
        _check_int32(name, t, K, dev)
    _check_int32("cnt1", cnt1, 1, dev)
    if upd is None:
        upd = torch.empty((K, th, tw), dtype=dtype, device=dev)
    elif (tuple(upd.shape) != (K, th, tw) or upd.dtype != dtype
          or upd.device != dev or not upd.is_contiguous()):
        raise ValueError("upd must be a contiguous [K, th, tw] tensor of "
                         "the state's dtype and device")
    if anyf is None:
        anyf = torch.zeros(K, dtype=torch.int32, device=dev)
    else:
        _check_int32("anyf", anyf, K, dev)
        anyf.zero_()
    tap_t = None if taps is None else _kernel_taps(taps, dtype, dev)
    orow, ocol = _origin(origin)
    H, W = global_shape
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mm_fused_compute(
            _DTYPE_CODE[dtype], padded.data_ptr(), upd.data_ptr(),
            anyf.data_ptr(), ids.data_ptr(), cnt1.data_ptr(),
            selfnz.data_ptr(), None if tap_t is None else tap_t.data_ptr(),
            padded.shape[1], K, th, tw, gj, int(ring), int(k), orow, ocol,
            int(H), int(W), _rate_value(rate, dtype), len(offsets),
            _offset_codes(offsets), _offset_mask(offsets), stream)
    _raise_on(lib, err, "fused_compute (K6)")
    _launches["fused_compute"] += 1
    return upd, anyf


def fused_scatter(padded: torch.Tensor, upd: torch.Tensor, ids: torch.Tensor,
                  cnt1: torch.Tensor, *, plan: ActivePlan,
                  ring: int) -> torch.Tensor:
    """K7: land the live lanes' updates in ``padded`` (in place). On a CUDA
    tensor it launches the kernel, else the plain version."""
    if padded.device.type == "cpu":
        return fused_scatter_plain(padded, upd, ids, cnt1.reshape(-1)[0],
                                   plan, ring)
    if padded.device.type != "cuda":
        raise ValueError(f"unsupported device {padded.device}")
    (th, tw), (_, gj) = plan.tile, plan.grid
    K = plan.capacity
    if (padded.dim() != 2 or not padded.is_contiguous()
            or upd.dtype != padded.dtype or upd.device != padded.device
            or tuple(upd.shape) != (K, th, tw) or not upd.is_contiguous()):
        raise ValueError("fused_scatter takes a contiguous padded state and "
                         "a [K, th, tw] update buffer of its dtype")
    _check_int32("ids", ids, K, padded.device)
    _check_int32("cnt1", cnt1, 1, padded.device)
    lib = _kernel_lib()
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = lib.mm_fused_scatter(
            padded.element_size(), padded.data_ptr(), upd.data_ptr(),
            ids.data_ptr(), cnt1.data_ptr(), padded.shape[1], K, th, tw, gj,
            int(ring), stream)
    _raise_on(lib, err, "fused_scatter (K7)")
    _launches["fused_scatter"] += 1
    return padded


def fused_active_pass(padded, ids, count, selfnz, rate, plan: ActivePlan,
                      origin, global_shape: tuple[int, int],
                      offsets: Sequence[tuple[int, int]], dtype,
                      k: int = 1, ring: Optional[int] = None,
                      taps: Optional[np.ndarray] = None):
    """One fused pass over the compacted active set: ``k`` flow steps per
    tile window (K6), then the scatter (K7). Returns ``(padded, anyf)``,
    ``anyf`` the ``[K]`` bool flags (lanes past ``count`` False), with
    ``padded`` (the ring-``ring`` state, ring defaulting to ``k``) updated
    in place. ``origin`` is the state's global offset, ``selfnz`` the
    ``[K]`` int32 pre-pass self-tile-nonzero gather (read only with
    ``taps``)."""
    if ring is None:
        ring = k
    if k < 1 or k > min(plan.tile):
        raise ValueError(
            f"fused pass depth k={k} must be in [1, min(tile)="
            f"{min(plan.tile)}] (ring-1 dilation exactness bound)")
    if ring < k:
        raise ValueError(f"padding ring {ring} shallower than pass depth "
                         f"{k}")
    cnt1 = torch.as_tensor(count, dtype=torch.int32,
                           device=padded.device).reshape(1)
    selfnz = torch.as_tensor(selfnz, dtype=torch.int32, device=padded.device)
    upd, anyf = fused_compute(
        padded, ids, cnt1, selfnz, rate=rate, plan=plan, origin=origin,
        global_shape=tuple(global_shape), offsets=tuple(offsets),
        dtype=dtype, k=int(k), ring=int(ring), taps=taps)
    fused_scatter(padded, upd, ids, cnt1, plan=plan, ring=int(ring))
    return padded, anyf != 0


# -- dense fallback at pass depth k ------------------------------------------

def dense_chunk_from_padded(padded, rate, counts, offsets, dtype, k: int,
                            ring: int):
    """``k`` plain dense steps on the interior of a ring-``ring`` padded
    state, returned re-padded with a zero ring (bitwise the plain dense
    path)."""
    v = padded[ring:-ring, ring:-ring]
    rate_c = torch.tensor(rate, dtype=dtype, device=padded.device)
    for _ in range(k):
        v = transport(v, rate_c * v, counts, offsets)
    return F.pad(v, (ring, ring, ring, ring))


# -- the amortized whole-run runner ------------------------------------------

def build_fused_runner(shape: tuple[int, int], rates: dict,
                       offsets: Sequence[tuple[int, int]], dtype,
                       origin: tuple[int, int] = (0, 0),
                       global_shape: Optional[tuple[int, int]] = None,
                       plan: Optional[ActivePlan] = None,
                       k: int = 1,
                       dense_fns: Optional[dict] = None,
                       track_dirty: bool = False,
                       use_taps: bool = True) -> Callable:
    """Whole-run fused active stepper: ``run(values, n) -> (values,
    (fallback_events, active_tiles_total, flags_fused[, dirty_map]))``.
    ``use_taps=False`` runs every pass on the exact iterated path (the
    ensemble engine's lanes, as the JAX package's traced per-lane rates
    leave it no tap table).

    The state is padded once to ring ``k`` and carried; ``n // k``
    full-depth passes, then ``n % k`` depth-1 passes on the same buffer
    (taps never apply at depth 1). Each pass reads the dilated count on the
    host once: above the threshold it runs ``depth`` dense steps (the
    ``dense_fns`` stepper, else the plain transport), else K6 + K7.
    ``flags_fused`` counts the passes whose next tile map came from the
    kernel's flags. The dirty map unions the flagged set per pass (the
    ring-1 dilation of the pre-pass map, which bounds a dense chunk too)."""
    shape = tuple(shape)
    gshape = tuple(global_shape) if global_shape is not None else shape
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    if plan is None:
        plan = plan_for(shape)
    k = int(k)
    if k < 1 or k > min(min(plan.tile), MAX_FUSED_K):
        raise ValueError(
            f"fused runner depth k={k} must divide into "
            f"[1, min(min(tile), {MAX_FUSED_K})] for tile {plan.tile}")
    th, tw = plan.tile
    dense_fns = dense_fns or {}
    taps_by_attr = {a: _fused_taps(float(r), offsets, k) if use_taps
                    else None for a, r in rates.items()}

    def run(values: dict, n: int):
        n = int(n)
        out = dict(values)
        fb = at = ff = 0
        dev = next(iter(values.values())).device
        dirty = torch.zeros(plan.grid, dtype=torch.bool, device=dev)
        upd = torch.empty((plan.capacity, th, tw), dtype=dtype, device=dev)
        anyf = torch.empty(plan.capacity, dtype=torch.int32, device=dev)
        counts = None
        q, r = divmod(n, k)
        for a, rate in rates.items():
            v = values[a]
            padded = F.pad(v, (k, k, k, k))
            tmap = tile_nonzero_map(v, plan)
            for npasses, depth, taps in ((q, k, taps_by_attr[a]),
                                         (r, 1, None)):
                for _ in range(npasses):
                    flags = dilate_tile_map(tmap)
                    cnt_t = flags.sum(dtype=torch.int32).reshape(1)
                    cnt = int(cnt_t)  # the one host read per pass
                    at += cnt
                    if track_dirty:
                        dirty |= flags
                    if cnt <= plan.fallback_tiles:
                        ids, _ = compact_tile_ids(flags, plan)
                        selfnz = tmap.reshape(-1)[ids.to(torch.int64)].to(
                            torch.int32)
                        u, af = fused_compute(
                            padded, ids, cnt_t, selfnz, rate=rate,
                            plan=plan, origin=origin, global_shape=gshape,
                            offsets=offsets, dtype=dtype, k=depth, ring=k,
                            taps=taps, upd=upd, anyf=anyf)
                        fused_scatter(padded, u, ids, cnt_t, plan=plan,
                                      ring=k)
                        tmap = next_tile_map(af != 0, ids, cnt_t, plan)
                        ff += 1
                        continue
                    fb += 1
                    fn = dense_fns.get(a)
                    if fn is not None:
                        run_dense_fallback(padded, k, depth, fn)
                    else:
                        if counts is None:
                            counts = neighbor_counts(shape, offsets, origin,
                                                     gshape, dtype, dev)
                        padded = dense_chunk_from_padded(
                            padded, rate, counts, offsets, dtype, depth, k)
                    tmap = tile_nonzero_map(padded[k:-k, k:-k], plan)
            out[a] = padded[k:-k, k:-k].contiguous()
        if track_dirty:
            return out, (fb, at, ff, dirty)
        return out, (fb, at, ff)

    return run


# -- stateless per-step form (Model.make_step impl="active_fused") -----------

class FusedActiveStep:
    """Stateless fused active step for one channel: pad → activity →
    compact → K6 + K7 (or the dense fallback, same call) → unpad. One call
    advances ``k * passes`` flow steps."""

    def __init__(self, shape: tuple[int, int], rate: float, dtype,
                 offsets: Sequence[tuple[int, int]] = MOORE_OFFSETS,
                 origin: tuple[int, int] = (0, 0),
                 global_shape: Optional[tuple[int, int]] = None,
                 tile: Optional[tuple[int, int]] = None,
                 capacity: Optional[int] = None,
                 max_active_frac: float = 0.25,
                 k: int = 1, passes: int = 1,
                 dense_fn: Optional[Callable] = None):
        self.shape = tuple(shape)
        self.rate = float(rate)
        self.dtype = dtype
        self.offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
        self.origin = (int(origin[0]), int(origin[1]))
        self.global_shape = (tuple(global_shape)
                             if global_shape is not None else self.shape)
        self.plan = plan_for(self.shape, tile=tile, capacity=capacity,
                             max_active_frac=max_active_frac)
        self.k = int(k)
        self.passes = int(passes)
        if self.k < 1 or self.k > min(min(self.plan.tile), MAX_FUSED_K):
            raise ValueError(
                f"k={k} outside [1, min(min(tile), {MAX_FUSED_K})] for "
                f"tile {self.plan.tile}")
        self.taps = _fused_taps(self.rate, self.offsets, self.k)
        self.dense_fn = dense_fn or dense_transport_step(
            self.shape, self.rate, self.offsets, self.origin,
            self.global_shape, self.dtype)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        plan, k = self.plan, self.k
        for _ in range(self.passes):
            tmap = tile_nonzero_map(v, plan)
            flags = dilate_tile_map(tmap)
            count = flags.sum(dtype=torch.int32)
            if int(count) > plan.fallback_tiles:
                for _s in range(k):
                    v = self.dense_fn(v.contiguous())
                continue
            padded = F.pad(v, (k, k, k, k))
            ids, _ = compact_tile_ids(flags, plan)
            selfnz = tmap.reshape(-1)[ids.to(torch.int64)].to(torch.int32)
            fused_active_pass(padded, ids, count, selfnz, self.rate, plan,
                              self.origin, self.global_shape, self.offsets,
                              v.dtype, k=k, ring=k, taps=self.taps)
            v = padded[k:-k, k:-k].contiguous()
        return v
