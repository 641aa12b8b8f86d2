"""Point-subsystem runner: step only the cells a point flow touches
(counterpart of ``mpi_model_tpu/ops/point_kernel.py``).

The reference's live workload is one point flow on a 100×100 grid
(``Main.cpp:32-33``): per step only the source cell and its ≤8 neighbours
change (``Model.hpp:176-235``). This module extracts the *involved
subsystem*, the static union of the sources and their in-partition
neighbours (m ≤ 9·k cells), steps an ``[m+1]`` vector (the ``+1`` is a
dummy slot that absorbs dropped shares), and scatters the result back into
the grid once per run: one gather, ``n`` small vector steps and one scatter.
It is plain torch; the JAX package's version is an XLA program, not a
kernel.

Faithfulness: when every touched cell receives exactly one contribution per
step (any number of non-overlapping frozen flows, the reference's exact
workload) a step is one ``[m+1]`` vector add of the full path's own
per-step values, so results equal ``ops.stencil.point_flow_step`` bit for
bit. The sequenced branches (overlapping neighbourhoods, dynamic amounts)
do the same logical operations in the full path's order; they are held to
within one ulp a step.

Eligibility (``build_point_plans`` returns None otherwise): every flow a
``PointFlow``, at most ``MAX_FLOWS`` of them, a float dtype. The sharded use
also needs every flow frozen: a dynamic amount reads the owner shard's
source value, which other shards do not hold, while frozen amounts need no
exchange at all.

Plans keep their tables as numpy arrays in the space's dtype; numpy has no
bfloat16, so a bf16 plan keeps float32 arrays of bf16-rounded values (every
value is rounded in torch's bf16 arithmetic, as the full path rounds it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.cellular_space import CellularSpace
from .flow import PointFlow

#: fall back to the full-grid path beyond this many point flows: the
#: subsystem stops being small and the full path's vectorized scatters
#: amortize better
MAX_FLOWS = 64

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
              torch.float16: np.float16, torch.bfloat16: np.float32}


@dataclasses.dataclass
class PointPlan:
    """Per-attribute involved-cell subsystem (coordinates local to the
    space's tensor; validity and topology folded in at build time)."""

    attr: str
    #: [m] involved-cell local coordinates (unique, deterministic order)
    xs: np.ndarray
    ys: np.ndarray
    #: all-frozen single-add path: sub += delta per step ([m+1])
    delta: Optional[np.ndarray]
    #: all-frozen, per-phase-distinct targets: a sequence of [m+1] adds
    phase_deltas: Optional[list[np.ndarray]]
    #: general (dynamic flows): the vectorized per-flow spec
    dyn: Optional[dict]

    @property
    def m(self) -> int:
        return len(self.xs)

    @property
    def frozen_only(self) -> bool:
        return self.dyn is None


def _neighbor_count(gx: int, gy: int, gdx: int, gdy: int, offsets) -> int:
    return sum(1 for dx, dy in offsets
               if 0 <= gx + dx < gdx and 0 <= gy + dy < gdy)


def build_point_plans(flows: Sequence, space: CellularSpace,
                      offsets: Sequence[tuple[int, int]],
                      ) -> Optional[dict[str, PointPlan]]:
    """Static subsystem extraction; None when the model is ineligible."""
    if not flows or len(flows) > MAX_FLOWS:
        return None
    if not all(isinstance(f, PointFlow) for f in flows):
        return None
    tdt = space.dtype
    if not tdt.is_floating_point:
        return None
    npdt = np.dtype(_NP_DTYPES[tdt])

    def rnd(x) -> np.generic:
        """``x`` rounded once to the space dtype."""
        return npdt.type(float(torch.tensor(float(x), dtype=tdt)))

    def div(a, b) -> np.generic:
        """``a / b`` in the space dtype's arithmetic."""
        return npdt.type(float(torch.tensor(float(a), dtype=tdt)
                               / torch.tensor(float(b), dtype=tdt)))

    h, w = space.dim_x, space.dim_y
    gdx, gdy = space.global_shape
    x0, y0 = space.x_init, space.y_init

    by_attr: dict[str, list[PointFlow]] = {}
    for f in flows:
        lx, ly = f.source_xy[0] - x0, f.source_xy[1] - y0
        if 0 <= lx < h and 0 <= ly < w:  # owner test (Model.hpp:176)
            by_attr.setdefault(f.attr, []).append(f)

    plans: dict[str, PointPlan] = {}
    for attr, pflows in by_attr.items():
        # entry table: unique local cells, sources first then neighbours,
        # in flow × offset order (deterministic, so cache keys are stable)
        index: dict[tuple[int, int], int] = {}

        def entry(lx: int, ly: int) -> int:
            return index.setdefault((lx, ly), len(index))

        spec = []  # per flow: (src_entry, amt or None, rate, count, tgts)
        for f in pflows:
            lx, ly = f.source_xy[0] - x0, f.source_xy[1] - y0
            src_e = entry(lx, ly)
            count = _neighbor_count(lx + x0, ly + y0, gdx, gdy, offsets)
            # frozen amount with the full path's rounding: the Python f64
            # product, then one cast to the grid dtype
            amt = (rnd(f.flow_rate * f.frozen_source_value)
                   if f.frozen_source_value is not None else None)
            tgts = []
            for dx, dy in offsets:
                nx, ny = lx + dx, ly + dy
                # delivery is bounded by the partition (shares leaving it
                # drop), counts by the global grid
                tgts.append(entry(nx, ny) if 0 <= nx < h and 0 <= ny < w
                            else None)
            spec.append((src_e, amt, f.flow_rate, count, tgts))

        m = len(index)
        xs = np.fromiter((c[0] for c in index), np.int32, m)
        ys = np.fromiter((c[1] for c in index), np.int32, m)

        all_frozen = all(s[1] is not None for s in spec)
        delta = phase_deltas = dyn = None
        if all_frozen:
            # the contributions in the full path's order: one source-phase
            # scatter, then one scatter per offset
            phases: list[list[tuple[int, np.generic]]] = [
                [(s[0], npdt.type(-s[1])) for s in spec]]
            for oi in range(len(offsets)):
                phases.append([(tgts[oi], div(amt, count))
                               for _src, amt, _rate, count, tgts in spec
                               if tgts[oi] is not None])
            flat = [t for ph in phases for t, _ in ph]
            if len(set(flat)) == len(flat):
                # every touched cell gets exactly one add a step: the whole
                # step is one vector add (0.0 elsewhere)
                delta = np.zeros(m + 1, npdt)
                for ph in phases:
                    for t, v in ph:
                        delta[t] = v
            elif all(len({t for t, _ in ph}) == len(ph) for ph in phases):
                phase_deltas = []
                for ph in phases:
                    d = np.zeros(m + 1, npdt)
                    for t, v in ph:
                        d[t] = v
                    phase_deltas.append(d)
            # duplicate targets inside one phase: the scatter-add order is
            # the full path's, so fall through to the dynamic form
        if delta is None and phase_deltas is None:
            dyn = dict(
                src=np.asarray([s[0] for s in spec], np.int32),
                frozen=np.asarray([s[1] is not None for s in spec]),
                const_amt=np.asarray(
                    [s[1] if s[1] is not None else 0 for s in spec], npdt),
                rate=np.asarray([rnd(s[2]) for s in spec], npdt),
                count=np.asarray([s[3] for s in spec], npdt),
                # [n_offsets, k]: entry index, the dummy m when dropped
                tgt=np.asarray([[s[4][oi] if s[4][oi] is not None else m
                                 for s in spec]
                                for oi in range(len(offsets))], np.int32),
                valid=np.asarray([[s[4][oi] is not None for s in spec]
                                  for oi in range(len(offsets))]),
            )
        plans[attr] = PointPlan(attr, xs, ys, delta, phase_deltas, dyn)
    return plans


def subsystem_step(plan: PointPlan, dtype,
                   device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-step function on the ``[m+1]`` subsystem vector, parallel to
    ``point_flow_step`` on the full grid."""
    def t(a, dt=dtype):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    if plan.delta is not None:
        d = t(plan.delta)

        def step(sub):
            return sub + d
        return step
    if plan.phase_deltas is not None:
        ds = [t(d) for d in plan.phase_deltas]

        def step(sub):
            for d in ds:
                sub = sub + d
            return sub
        return step

    dyn = plan.dyn
    src = t(dyn["src"], torch.int64)
    frozen = t(dyn["frozen"], torch.bool)
    const_amt = t(dyn["const_amt"])
    rate = t(dyn["rate"])
    count = t(dyn["count"])
    tgt = t(dyn["tgt"], torch.int64)
    valid = t(dyn["valid"], torch.bool)
    zero = torch.zeros((), dtype=dtype, device=device)

    def step(sub):
        # amounts read the pre-step values (summed-outflow semantics)
        amts = torch.where(frozen, const_amt, rate * sub[src])
        share = amts / count
        out = sub.index_put((src,), -amts, accumulate=True)
        for oi in range(tgt.shape[0]):
            out.index_put_((tgt[oi],), torch.where(valid[oi], share, zero),
                           accumulate=True)
        return out
    return step


def _steppers(plans: dict[str, PointPlan], dtype):
    """Each plan's step function and index vectors, built once per device."""
    built: dict = {}

    def get(device):
        key = str(device)
        if key not in built:
            built[key] = {
                a: (subsystem_step(p, dtype, device),
                    torch.as_tensor(p.xs).to(device, torch.int64),
                    torch.as_tensor(p.ys).to(device, torch.int64))
                for a, p in plans.items()}
        return built[key]
    return get


def serial_point_runner(plans: dict[str, PointPlan], dtype):
    """``run(values, n) -> values``: gather each attr's subsystem, ``n``
    small steps, one scatter back."""
    get = _steppers(plans, dtype)

    def run(values: dict, n: int) -> dict:
        new = dict(values)
        for attr, plan in plans.items():
            v = values[attr]
            step, xs, ys = get(v.device)[attr]
            sub = torch.cat([v[xs, ys], torch.zeros(1, dtype=dtype,
                                                    device=v.device)])
            for _ in range(int(n)):
                sub = step(sub)
            out = v.clone()
            out[xs, ys] = sub[:plan.m]
            new[attr] = out
        return new
    return run


def shard_point_runner(plans: dict[str, PointPlan], dtype, local_h: int,
                       local_w: int):
    """Per-shard subsystem runner (every flow frozen): each shard evolves
    the whole entry table (constant deltas: no exchange, ever) and scatters
    back only the entries it owns; gathers it does not own read clipped
    cells, whose results land in a discarded pad cell. Returns
    ``run(values, off_x, off_y, n) -> values`` for one shard whose first
    cell is ``(off_x, off_y)`` of the space's tensor."""
    if not all(p.frozen_only for p in plans.values()):
        raise ValueError("shard_point_runner needs every point flow frozen")
    get = _steppers(plans, dtype)

    def run(values: dict, off_x: int, off_y: int, n: int) -> dict:
        new = dict(values)
        for attr, plan in plans.items():
            v = values[attr]
            step, xs, ys = get(v.device)[attr]
            sx, sy = xs - int(off_x), ys - int(off_y)
            owned = (sx >= 0) & (sx < local_h) & (sy >= 0) & (sy < local_w)
            sxc = sx.clamp(0, local_h - 1)
            syc = sy.clamp(0, local_w - 1)
            sub = torch.cat([v[sxc, syc], torch.zeros(1, dtype=dtype,
                                                      device=v.device)])
            for _ in range(int(n)):
                sub = step(sub)
            padded = F.pad(v, (0, 1, 0, 1))
            px = torch.where(owned, sxc, local_h)
            py = torch.where(owned, syc, local_w)
            padded[px, py] = sub[:plan.m]
            new[attr] = padded[:local_h, :local_w].contiguous()
        return new
    return run
