"""The one registered lowering from Flow IR terms to executable steps
(counterpart of ``mpi_model_tpu/ir/lower.py``).

Every step engine (the dense step, the composed path at k = 1 for
nonlinear terms, the active-tile engine, the sharded per-shard step and the
ensemble's batched step) consumes terms through this module. The engines
differ only in the **context** they build (how tensors are stored, padded
and gathered); the per-term physics is written once, in the
``@register_lowering`` entry for its kind, out of the context's
primitives:

- ``transport_update(channel, rate_c, weights)``: the ring-1
  mass-conserving redistribution, ``ops.stencil.transport``'s expression
  term for term in every context;
- ``apply_amount(channel, amount, sign)``: a pointwise add or subtract;
- ``add_budget(channel, amount, sign)``: integrate a declared source's or
  sink's signed contribution into its hidden budget channel.

The contexts: ``DenseCtx`` (full grids, and ``[B, H, W]`` ensemble lanes
with ``[B, 1, 1]`` rates), ``PaddedCtx`` (a shard padded with its
neighbours' values, ``ShardMapExecutor``), ``WindowCtx`` (the active tiles'
ring-1 windows, gathered as one ``[n, th+2, tw+2]`` batch).

All reads are pre-step: every term's amount is evaluated on the step's
input values, then the terms apply in order.

The JAX package puts ``optimization_barrier``s around outflows, amounts
and each term's written channels: XLA would otherwise contract multiplies
and adds into FMAs differently in each fusion context (a jit, a loop body,
a vmapped lane, a ``lax.cond`` branch), and the engines' results would part
in the last bit. Eager torch runs one kernel an operation and contracts
nothing across operations, so this port keeps the order of operations and
needs no barrier; what the barriers guarded (every engine computing the
same bits) is what the tests hold.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..ops.stencil import neighbor_counts, shift2d, transport, \
    weighted_counts
from .expr import evaluate
from .terms import Sink, Source, Term, Transfer, Transport

# -- the registry -------------------------------------------------------------

#: term kind -> lowering (one per kind)
LOWERINGS: dict[type, object] = {}


def register_lowering(term_cls: type):
    """Register the one lowering for ``term_cls``; a second registration
    is an error."""
    def deco(obj):
        if term_cls in LOWERINGS:
            raise ValueError(
                f"term kind {term_cls.__name__} already has a registered "
                f"lowering ({LOWERINGS[term_cls]!r}); every kind gets "
                "exactly one")
        LOWERINGS[term_cls] = obj
        return obj
    return deco


def lowering_for(term: Term):
    low = LOWERINGS.get(type(term))
    if low is None:
        raise TypeError(
            f"no registered lowering for term kind "
            f"{type(term).__name__} (register one in ir.lower)")
    return low


# -- step metadata ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepMeta:
    """Static geometry the lowering closes over."""

    shape: tuple[int, int]
    origin: tuple[int, int]
    global_shape: tuple[int, int]
    dtype: object
    offsets: tuple[tuple[int, int], ...]


def _opposite_weights(offsets, weights) -> list[float]:
    """weights reindexed by negated offset: the tap a cell receives along
    ``d`` is the tap its neighbour sends along ``-d``. Weighted transport
    therefore needs a symmetric offset set (Moore/von Neumann are)."""
    idx = {(dx, dy): i for i, (dx, dy) in enumerate(offsets)}
    out = []
    for dx, dy in offsets:
        j = idx.get((-dx, -dy))
        if j is None:
            raise ValueError(
                f"weighted Transport needs a symmetric offset set; "
                f"offset ({dx}, {dy}) has no opposite in {tuple(offsets)}")
        out.append(weights[j])
    return out


# -- contexts -----------------------------------------------------------------

def const(cache: dict, value: float, dtype, device) -> torch.Tensor:
    """``value`` as a 0-d tensor in ``dtype`` on ``device``, made once per
    ``cache`` (a step's constants: its contexts' and its activity
    probes')."""
    key = ("const", float(value), dtype)
    t = cache.get(key)
    if t is None:
        t = torch.tensor(float(value), dtype=dtype, device=device)
        cache[key] = t
    return t


class _Ctx:
    """Shared context machinery: pre-step reads, sequential accumulation,
    the pointwise primitives. ``cache`` keeps the 0-d constants (and the
    weighted divisors) a step makes, so a step built once makes each of
    them once on the device."""

    def __init__(self, pre: dict, meta: StepMeta,
                 cache: Optional[dict] = None):
        self.pre = pre          # channel -> pre-step tensor (interior view)
        self.cur = dict(pre)    # accumulates term applications in order
        self.meta = meta
        self.dtype = meta.dtype
        self.device = next(iter(pre.values())).device
        self.cache = {} if cache is None else cache

    def env(self) -> dict:
        return self.pre

    def scalar(self, value: float, dtype=None) -> torch.Tensor:
        """``value`` as a 0-d tensor in ``dtype`` (the space dtype by
        default) on the device."""
        return const(self.cache, value,
                     self.dtype if dtype is None else dtype, self.device)

    def rate_c(self, rate, dtype=None) -> torch.Tensor:
        """A term's rate as the lowering multiplies by it: a lane tensor
        (the ensemble's ``[B, 1, 1]`` rates, already in their dtype) as it
        is, a number as a 0-d tensor in ``dtype`` (the space dtype by
        default)."""
        if isinstance(rate, torch.Tensor):
            return rate
        return self.scalar(rate, dtype)

    def apply_amount(self, channel: str, amount, sign: int) -> None:
        if sign >= 0:
            self.cur[channel] = self.cur[channel] + amount
        else:
            self.cur[channel] = self.cur[channel] - amount

    def add_budget(self, channel: str, amount, sign: int) -> None:
        if channel not in self.cur:
            raise ValueError(
                f"budget channel {channel!r} missing from the space — "
                "build IR spaces with FlowIRModel.create_space (or "
                "with_budget_channels) so declared sources/sinks have "
                "their integration accumulator")
        self.apply_amount(channel, amount, sign)

    def transport_update(self, channel, rate_c, weights) -> None:
        raise NotImplementedError

    def _ring_update(self, cur, win, rate_c, counts, weights, mask=None):
        """The ring-1 transport of a padded array ``win`` (``[..., h+2,
        w+2]``) into ``cur`` (``[..., h, w]``): outflow on the whole padded
        array (a ghost cell's share is the value its owner computes),
        ``mask`` zeroing the ghost cells beyond the partition, inflow summed
        from zero in offset order, then ``(cur - outflow) + inflow``.
        ``counts`` are clamped to >= 1 for uniform taps, raw for weighted
        ones (a stranded cell, every in-bounds tap weighted zero, sheds
        nothing)."""
        zero = self.scalar(0.0)
        outflow = rate_c * win
        if mask is not None:
            outflow = torch.where(mask, outflow, zero)
        if weights is not None:
            outflow = torch.where(counts > 0, outflow, zero)
            counts = torch.maximum(counts, self.scalar(1.0))
        share = outflow / counts
        h, w = cur.shape[-2], cur.shape[-1]
        offsets = self.meta.offsets
        taps = (None if weights is None
                else _opposite_weights(offsets, weights))
        inflow = torch.zeros(share.shape[:-2] + (h, w), dtype=self.dtype,
                             device=self.device)
        for i, (dx, dy) in enumerate(offsets):
            s = share[..., 1 + dx:1 + dx + h, 1 + dy:1 + dy + w]
            inflow = inflow + (s if taps is None
                               else self.scalar(taps[i]) * s)
        return (cur - outflow[..., 1:-1, 1:-1]) + inflow


class DenseCtx(_Ctx):
    """Full-grid tensors (or ``[B, H, W]`` ensemble lanes); uniform
    transport is the hand-written ``ops.stencil.transport`` call, the
    anchor the diffusion-as-IR check holds bit for bit."""

    def __init__(self, pre: dict, meta: StepMeta, counts,
                 cache: Optional[dict] = None, out: Optional[dict] = None):
        super().__init__(pre, meta, cache)
        self.counts = counts
        # channel -> a buffer aliasing no input, which receives the
        # channel's first uniform transport in place of a fresh tensor
        self.out = dict(out or {})

    def _wcounts(self, weights) -> torch.Tensor:
        key = ("wcounts", weights)
        t = self.cache.get(key)
        if t is None:
            m = self.meta
            t = weighted_counts(m.shape, m.offsets, weights, m.origin,
                                m.global_shape, self.dtype, self.device)
            self.cache[key] = t
        return t

    def transport_update(self, channel, rate_c, weights) -> None:
        outflow = rate_c * self.pre[channel]
        if weights is None:
            self.cur[channel] = transport(self.cur[channel], outflow,
                                          self.counts, self.meta.offsets,
                                          out=self.out.pop(channel, None))
            return
        offsets = self.meta.offsets
        wcnt = self._wcounts(weights)
        # a stranded cell (every in-bounds tap weighted zero) has nowhere
        # to shed: it sheds nothing, which keeps the term conserving and
        # finite; the padded and window contexts apply the same rule
        shed = torch.where(wcnt > 0, outflow, self.scalar(0.0))
        share = shed / torch.maximum(wcnt, self.scalar(1.0))
        w_opp = _opposite_weights(offsets, weights)
        inflow = torch.zeros_like(share)
        for w, (dx, dy) in zip(w_opp, offsets):
            inflow = inflow + self.scalar(w) * shift2d(share, dx, dy)
        self.cur[channel] = self.cur[channel] - shed + inflow


class PaddedCtx(_Ctx):
    """Per-shard ghost-ring context (``ShardMapExecutor``): the channels a
    ring-1 term reads arrive padded one cell with the neighbour shards'
    values (zeros beyond the grid); outflow is computed on the padded
    array and masked to the partition, so a ghost cell's share equals the
    value its owning shard computes."""

    def __init__(self, pre: dict, meta: StepMeta, padded: dict,
                 counts_pad, wcounts_pad: Callable, mask_pb,
                 cache: Optional[dict] = None):
        super().__init__(pre, meta, cache)
        self.padded = padded          # channel -> [h+2, w+2] pre values
        self.counts_pad = counts_pad  # clamped >= 1
        self._wcounts_pad = wcounts_pad  # weights -> raw weighted counts
        self.mask_pb = mask_pb        # bool [h+2, w+2]: inside partition

    def transport_update(self, channel, rate_c, weights) -> None:
        counts = (self.counts_pad if weights is None
                  else self._wcounts_pad(weights))
        self.cur[channel] = self._ring_update(
            self.cur[channel], self.padded[channel], rate_c, counts,
            weights, self.mask_pb)


class WindowCtx(_Ctx):
    """The active engine's context: tensors are the compacted active
    tiles' ``[n, th+2, tw+2]`` windows gathered from the padded grid (their
    interiors ``[n, th, tw]``); neighbour counts come from the windows'
    global coordinates."""

    def __init__(self, pre_int: dict, meta: StepMeta, wins: dict,
                 counts_win, wcounts_win: Callable,
                 cache: Optional[dict] = None):
        super().__init__(pre_int, meta, cache)
        self.wins = wins              # channel -> [n, th+2, tw+2] windows
        self.counts_win = counts_win  # clamped >= 1
        self._wcounts_win = wcounts_win  # weights -> raw weighted counts

    def transport_update(self, channel, rate_c, weights) -> None:
        counts = (self.counts_win if weights is None
                  else self._wcounts_win(weights))
        self.cur[channel] = self._ring_update(
            self.cur[channel], self.wins[channel], rate_c, counts, weights)


# -- the per-term lowerings (one per kind; composed from ctx primitives) ------

@register_lowering(Transport)
class _LowerTransport:
    @staticmethod
    def apply(term: Transport, ctx: _Ctx, rate) -> None:
        # the rate is rounded to the channel's dtype, as a Diffusion
        # flow's is (the same as the space dtype's on an IR model's space)
        ctx.transport_update(
            term.channel, ctx.rate_c(rate, ctx.pre[term.channel].dtype),
            term.weights)


def _amount(term, ctx: _Ctx, rate):
    """``rate * expr``. A concrete rate that is 1 in the space dtype skips
    the multiply, as the JAX package's lowering does (``x * 1`` is exact,
    so an ensemble lane, which multiplies, gets the same values)."""
    amt = evaluate(term.expr, ctx.env(), ctx.dtype, ctx.cache, ctx.device)
    if not isinstance(rate, torch.Tensor) and float(
            torch.tensor(float(rate), dtype=ctx.dtype)) == 1.0:
        return amt
    return ctx.rate_c(rate) * amt


@register_lowering(Transfer)
class _LowerTransfer:
    @staticmethod
    def apply(term: Transfer, ctx: _Ctx, rate) -> None:
        amt = _amount(term, ctx, rate)
        ctx.apply_amount(term.src, amt, -1)
        ctx.apply_amount(term.dst, amt, +1)


@register_lowering(Source)
class _LowerSource:
    @staticmethod
    def apply(term: Source, ctx: _Ctx, rate) -> None:
        amt = _amount(term, ctx, rate)
        ctx.apply_amount(term.channel, amt, +1)
        ctx.add_budget(term.budget_channel, amt, +1)


@register_lowering(Sink)
class _LowerSink:
    @staticmethod
    def apply(term: Sink, ctx: _Ctx, rate) -> None:
        amt = _amount(term, ctx, rate)
        ctx.apply_amount(term.channel, amt, -1)
        ctx.add_budget(term.budget_channel, amt, -1)


def apply_terms(terms: Sequence[Term], ctx: _Ctx, rates: Sequence) -> dict:
    """Run every term's registered lowering against ``ctx`` in order;
    returns the accumulated values. ``rates`` aligns with ``terms``:
    numbers (serial) or lane tensors (ensemble)."""
    for term, rate in zip(terms, rates):
        lowering_for(term).apply(term, ctx, rate)
    return ctx.cur


# -- term-set introspection ---------------------------------------------------

def involved_channels(terms: Sequence[Term]) -> frozenset[str]:
    out: set[str] = set()
    for t in terms:
        out |= t.reads() | t.writes()
        if t.budget_channel is not None:
            out.add(t.budget_channel)
    return frozenset(out)


def budget_channels(terms: Sequence[Term]) -> dict[str, Term]:
    """budget channel -> owning source/sink term."""
    return {t.budget_channel: t for t in terms
            if t.budget_channel is not None}


def written_channels(terms: Sequence[Term]) -> list[str]:
    """Every channel a step writes (budgets included), sorted."""
    return sorted(set().union(*(t.writes() for t in terms))
                  | set(budget_channels(terms)))


def max_footprint(terms: Sequence[Term]) -> int:
    """The stencil depth the terms read: the sharded executor's required
    halo depth."""
    return max((t.footprint for t in terms), default=0)


def uniform_rates(terms: Sequence[Term]) -> Optional[dict[str, float]]:
    """attr -> summed rate when every term is a uniform (unweighted)
    Transport (the shape the kernel engines take); None otherwise."""
    rates: dict[str, float] = {}
    for t in terms:
        if not (isinstance(t, Transport) and t.is_uniform):
            return None
        rates[t.channel] = rates.get(t.channel, 0.0) + t.rate
    return rates


@dataclasses.dataclass(frozen=True)
class ActivitySpec:
    """Term-derived activity predicate of one model: a tile is active iff
    any term may contribute on it. ``probes`` are ``(channel, ref,
    dilate)``: the term acts where ``channel != ref``, with ring-1 tile
    dilation when its footprint reaches the ring. ``always``: some term
    offered no predicate, and the engine runs every tile (the dense
    fallback, visible in the run's fallback counters)."""

    probes: tuple[tuple[str, float, bool], ...]
    always: bool


def activity_spec(terms: Sequence[Term]) -> ActivitySpec:
    probes = []
    always = False
    for t in terms:
        p = t.activity()
        if p is None:
            always = True
            continue
        ch, ref = p
        probes.append((ch, float(ref), t.footprint >= 1))
    return ActivitySpec(tuple(dict.fromkeys(probes)), always)


def diffusion_terms(field_flows) -> Optional[tuple[Transport, ...]]:
    """Plain-``Diffusion`` flows as IR Transport terms: how
    ``Model.make_step``'s plain path and the ensemble's ``ScenarioStep``
    run this lowering. None when any
    flow is not a plain Diffusion or a channel carries several (two
    same-channel Diffusions sum their outflows, which is not bit for bit
    one summed-rate Transport: that case keeps the summed-outflow path)."""
    from ..ops.flow import Diffusion

    seen: set[str] = set()
    out = []
    for f in field_flows:
        if type(f) is not Diffusion or f.attr in seen:
            return None
        seen.add(f.attr)
        out.append(Transport(f.attr, rate=f.flow_rate))
    return tuple(out) if out else None


# -- step builders ------------------------------------------------------------

def dense_apply(terms, values: dict, rates, meta: StepMeta, counts,
                cache: Optional[dict] = None,
                out: Optional[dict] = None) -> dict:
    """One dense step over full-grid tensors: the dense engine's body, and
    the dense transport of plain ``Diffusion`` flows (``Model.make_step``
    and the ensemble's ``ScenarioStep``). ``out`` (channel -> a buffer that
    aliases no input) receives each channel's first uniform transport."""
    return apply_terms(terms, DenseCtx(dict(values), meta, counts, cache,
                                       out), rates)


def build_dense_step(terms, meta: StepMeta, rates) -> Callable:
    """``step(values, out=None) -> values`` for the serial dense engine
    (``out`` is accepted for the executor's signature and unused)."""
    terms = tuple(terms)
    rates = tuple(rates)
    cache: dict = {}

    def step(values: dict, out=None) -> dict:
        counts = cache.get("counts")
        if counts is None:
            dev = next(iter(values.values())).device
            counts = neighbor_counts(meta.shape, meta.offsets, meta.origin,
                                     meta.global_shape, meta.dtype, dev)
            cache["counts"] = counts
        return dense_apply(terms, values, rates, meta, counts, cache)

    return step


def padded_apply(terms, values: dict, padded: dict, rates,
                 meta: StepMeta, counts_pad, mask_pb,
                 cache: Optional[dict] = None) -> dict:
    """One per-shard step from the padded channels (the sharded IR
    runner's body). ``padded`` needs only the channels some ring-1 term
    reads; ``counts_pad`` are the clamped global neighbour counts over the
    padded shard; ``mask_pb`` bounds the partition."""
    cache = {} if cache is None else cache

    def wcounts_pad(weights):
        key = ("wcounts_pad", weights)
        t = cache.get(key)
        if t is None:
            h, w = meta.shape
            ox, oy = meta.origin
            t = weighted_counts((h + 2, w + 2), meta.offsets, weights,
                                (ox - 1, oy - 1), meta.global_shape,
                                meta.dtype, mask_pb.device)
            cache[key] = t
        return t

    ctx = PaddedCtx(dict(values), meta, padded, counts_pad, wcounts_pad,
                    mask_pb, cache)
    return apply_terms(terms, ctx, rates)


def build_active_step(terms, meta: StepMeta, rates, plan,
                      dense_step: Callable) -> Callable:
    """The active-tile step for IR models: the term-derived
    ``ActivitySpec`` decides which tiles may change; the compacted active
    tiles' windows are gathered as one ``[n, th+2, tw+2]`` batch per
    channel and every term's lowering runs on them (``WindowCtx``, all
    reads before all writes), then the results are scattered back. Above
    the threshold (``count > min(fallback_tiles, ntiles - 1)``, the JAX
    package's rule) the step is ``dense_step``. The count is read on the
    host once a step (the JAX package decides on the device, in a
    ``lax.cond``). Linear all-Transport models never come here (they take
    the active engines through the flows view).

    ``step.run(values, n)`` runs ``n`` steps; ``step(values)`` is one. A
    run copies each written channel once, into a tensor it owns, and
    scatters every later active step into it in place; the windows are
    gathered from the unpadded grid (clamped indices, zero beyond it). So
    an active step moves the windows and the activity probes' reads, not
    the grid. The step counts its calls, dense steps and active tiles in
    ``step.stats``."""
    from ..ops import active as act

    terms = tuple(terms)
    rates = tuple(rates)
    if plan.ntiles == 1:
        # the window is the grid: the dense step is the whole answer
        return dense_step
    spec = activity_spec(terms)
    th, tw = plan.tile
    gi, gj = plan.grid
    h, w = meta.shape
    ox, oy = meta.origin
    offsets = meta.offsets
    chans = sorted(involved_channels(terms))
    written = written_channels(terms)
    thresh = min(plan.fallback_tiles, plan.ntiles - 1)
    cache: dict = {}
    stats = {"calls": 0, "fallback_steps": 0, "active_tiles": 0}

    def tile_flags(values, device):
        if spec.always:
            return torch.ones((gi, gj), dtype=torch.bool, device=device)
        flags = torch.zeros((gi, gj), dtype=torch.bool, device=device)
        for ch, ref, dilate in spec.probes:
            v = values[ch]
            tm = (v != const(cache, ref, v.dtype, device)).reshape(
                gi, th, gj, tw).any(dim=3).any(dim=1)
            flags = flags | (act.dilate_tile_map(tm) if dilate else tm)
        return flags

    def active_update(cur: dict, flags, count: int) -> None:
        """One step over the ``count`` active tiles, scattered in place
        into ``cur``'s written channels (tensors the run owns)."""
        ids, _ = act.compact_tile_ids(flags, plan)
        rows, cols = act.window_index(ids, plan, count, 1, 0)
        # window coordinates in the unpadded grid: -1 and h (w) are the
        # zero ring F.pad would add
        r, c = rows - 1, cols - 1
        inside = (((r >= 0) & (r < h))[:, :, None]
                  & ((c >= 0) & (c < w))[:, None, :])
        ri = r.clamp(0, h - 1)[:, :, None]
        ci = c.clamp(0, w - 1)[:, None, :]
        wins = {ch: torch.where(inside, cur[ch][ri, ci],
                                const(cache, 0.0, cur[ch].dtype,
                                      cur[ch].device))
                for ch in chans}
        rows_g, cols_g = rows + (ox - 1), cols + (oy - 1)
        counts_win = act.window_counts(rows_g, cols_g, meta.global_shape,
                                       offsets, meta.dtype)

        def wcounts_win(weights):
            return weighted_counts((th + 2, tw + 2), offsets, weights,
                                   global_shape=meta.global_shape,
                                   dtype=meta.dtype,
                                   rows=rows_g[:, :, None],
                                   cols=cols_g[:, None, :])

        pre_int = {ch: wv[:, 1:-1, 1:-1] for ch, wv in wins.items()}
        res = apply_terms(terms, WindowCtx(pre_int, meta, wins, counts_win,
                                           wcounts_win, cache), rates)
        ti, tj = r[:, 1:-1, None], c[:, None, 1:-1]
        for ch in written:
            cur[ch][ti, tj] = res[ch]

    def run(values: dict, n: int) -> dict:
        cur = dict(values)
        owned: set = set()   # written channels that are this run's tensors
        for _ in range(int(n)):
            device = next(iter(cur.values())).device
            flags = tile_flags(cur, device)
            count = int(flags.sum())  # the one host read a step
            stats["calls"] += 1
            stats["active_tiles"] += count
            if count > thresh:
                stats["fallback_steps"] += 1
                cur = dense_step(cur)
                owned.update(written)  # the dense step's outputs are fresh
            elif count:
                for ch in written:
                    if ch not in owned:
                        cur[ch] = cur[ch].clone()
                        owned.add(ch)
                active_update(cur, flags, count)
        return cur

    def step(values: dict, out=None) -> dict:
        return run(values, 1)

    step.run = run
    step.stats = stats
    step.plan = plan
    return step
