"""Flow IR terms: the declarative units a model is a list of (counterpart
of ``mpi_model_tpu/ir/terms.py``; copied, not imported).

A **term** is one physical process over the grid's channels. Each term
declares, as data the engines can reason about:

- the channels it **reads** and **writes**;
- its stencil **footprint** (0 = pointwise, 1 = the Moore ring): the
  sharded executor derives its required halo depth from the model's
  largest footprint;
- its **conservation contract**: ``"conserving"`` (moves mass, never
  creates or destroys it: transport, transfers), ``"source"`` (declared
  mass injection) or ``"sink"`` (declared mass removal). Declared sources
  and sinks are integrated during the run into a hidden per-term budget
  channel (``budget_channel``) and reconciled against the observed
  total-mass drift: a violated contract raises ``ConservationError``
  naming the term;
- exactly one numeric **rate**, the per-scenario parameter. Every term's
  contribution is ``rate * amount``; the ensemble engine batches scenarios
  whose terms differ only in rates, shipping them as ``[B, T]`` lanes (a
  zero rate vector is a no-op, which keeps the scheduler's zero-padding
  lanes inert for any physics).

The reference's ``Flow``/``Exponencial`` hierarchy (a rate equation
attached to the space, executed then redistributed to the Moore
neighbours) is the one-term instance ``Transport(channel, rate)``.

Terms carry no compute: their lowerings live in ``ir.lower``, one per
term kind, shared by every step engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .expr import Chan, Const, Expr, as_expr, channels, fingerprint

#: prefix of the hidden per-term budget accumulator channels. They ride
#: the space like any float channel (stacked, sharded, checkpointed),
#: start at zero, and integrate a source/sink term's signed mass
#: contribution — conservation reconciliation reads their totals.
BUDGET_PREFIX = "_b_"

CONSERVING = "conserving"
SOURCE = "source"
SINK = "sink"


class Term:
    """Base of the term grammar. Concrete terms are frozen dataclasses;
    the common surface is the declaration API the engines consume."""

    name: str
    rate: float

    #: conservation contract (CONSERVING / SOURCE / SINK)
    conservation: str = CONSERVING
    #: stencil footprint: 0 pointwise, 1 = reads/writes the Moore ring
    footprint: int = 0

    # -- declarations --------------------------------------------------------

    def reads(self) -> frozenset[str]:
        raise NotImplementedError

    def writes(self) -> frozenset[str]:
        raise NotImplementedError

    @property
    def budget_channel(self) -> Optional[str]:
        """Hidden accumulator channel for declared sources/sinks (None
        for conserving terms — their net contribution is identically
        zero by construction of their lowering)."""
        if self.conservation in (SOURCE, SINK):
            return BUDGET_PREFIX + self.name
        return None

    def structure(self) -> tuple:
        """Hashable structural identity EXCLUDING the rate (the rate is
        the per-scenario parameter lane) — the ensemble batch-
        compatibility key component."""
        raise NotImplementedError

    def with_rate(self, rate: float) -> "Term":
        return dataclasses.replace(self, rate=float(rate))

    def activity(self) -> Optional[tuple[str, float]]:
        """``(channel, ref)`` such that this term provably contributes
        nothing wherever ``channel == ref`` — the term-derived activity
        predicate of the active engines. None = always active."""
        return None

    def _check_name(self):
        if not self.name or not self.name.replace("_", "a").isalnum():
            raise ValueError(
                f"term name {self.name!r} must be a non-empty "
                "identifier-like string (it names budget channels and "
                "conservation errors)")
        if self.name.startswith(BUDGET_PREFIX):
            raise ValueError(
                f"term name {self.name!r} collides with the "
                f"{BUDGET_PREFIX}* budget-channel namespace")


@dataclasses.dataclass(frozen=True)
class Transport(Term):
    """The linear stencil term: every cell sheds ``rate * value`` and
    distributes it to its in-bounds Moore neighbors — the reference's
    flow step generalized with optional per-tap ``weights`` (one weight
    per model offset; ``None`` = uniform, the classic counts-divided
    redistribution, bitwise-identical to the hand-written
    ``ops.stencil.transport``). Conserving by construction: what a cell
    emits is exactly what its neighbors receive.

    With ``weights=None`` this is the shape every kernel engine takes
    (through ``FlowIRModel``'s ``Diffusion`` flows view: K1, K2, K3, K5,
    K6/K7); weighted taps run the general lowering."""

    channel: str
    rate: float = 0.1
    weights: Optional[tuple[float, ...]] = None
    name: str = ""

    conservation = CONSERVING
    footprint = 1

    def __post_init__(self):
        object.__setattr__(self, "rate", float(self.rate))
        if self.weights is not None:
            w = tuple(float(x) for x in self.weights)
            if any(x < 0 for x in w) or not any(x > 0 for x in w):
                raise ValueError(
                    f"Transport weights must be non-negative with at "
                    f"least one positive tap, got {w}")
            object.__setattr__(self, "weights", w)
        if not self.name:
            object.__setattr__(self, "name", f"transport_{self.channel}")
        self._check_name()

    def reads(self) -> frozenset[str]:
        return frozenset((self.channel,))

    def writes(self) -> frozenset[str]:
        return frozenset((self.channel,))

    def structure(self) -> tuple:
        return ("Transport", self.name, self.channel, self.weights)

    def activity(self) -> Optional[tuple[str, float]]:
        # zero stays zero under linear transport: the active engines'
        # exact skip rule (ops.active module docstring)
        return (self.channel, 0.0)

    @property
    def is_uniform(self) -> bool:
        """True when this term is the uniform-rate shape the composed/
        pallas/active fast engines accept (``Diffusion`` equivalent)."""
        return self.weights is None


@dataclasses.dataclass(frozen=True)
class Transfer(Term):
    """Pointwise cross-channel coupling: ``rate * expr`` moves from
    ``src`` to ``dst`` at each cell — conserving across the pair by
    construction (one amount, subtracted and added). SIR's infection
    (``S -> I`` at ``beta * S * I``) and Gray-Scott's autocatalysis
    (``u -> v`` at ``u * v**2``) are Transfers."""

    src: str
    dst: str
    expr: Expr
    rate: float = 1.0
    name: str = ""

    conservation = CONSERVING
    footprint = 0

    def __post_init__(self):
        object.__setattr__(self, "rate", float(self.rate))
        object.__setattr__(self, "expr", as_expr(self.expr))
        if self.src == self.dst:
            raise ValueError(
                f"Transfer src and dst are both {self.src!r}: a "
                "self-transfer is a no-op — use Source/Sink for a net "
                "change, or drop the term")
        if not self.name:
            object.__setattr__(self, "name",
                               f"transfer_{self.src}_{self.dst}")
        self._check_name()

    def reads(self) -> frozenset[str]:
        return channels(self.expr) | {self.src, self.dst}

    def writes(self) -> frozenset[str]:
        return frozenset((self.src, self.dst))

    def structure(self) -> tuple:
        return ("Transfer", self.name, self.src, self.dst,
                fingerprint(self.expr))

    def activity(self) -> Optional[tuple[str, float]]:
        from .expr import zero_point
        return zero_point(self.expr)


@dataclasses.dataclass(frozen=True)
class Source(Term):
    """Declared mass injection: ``rate * expr`` is ADDED to ``channel``
    at each cell, and the same signed amount is integrated into the
    term's budget channel. ``expr`` may read a mask channel (masked
    sources) or a clock channel (time-varying sources — see ``Clock``).
    The contract: the integrated budget must be non-negative; the
    reconciliation gate raises naming this term otherwise."""

    channel: str
    expr: Expr
    rate: float = 1.0
    name: str = ""

    conservation = SOURCE
    footprint = 0

    def __post_init__(self):
        object.__setattr__(self, "rate", float(self.rate))
        object.__setattr__(self, "expr", as_expr(self.expr))
        if not self.name:
            object.__setattr__(self, "name", f"source_{self.channel}")
        self._check_name()

    def reads(self) -> frozenset[str]:
        return channels(self.expr) | {self.channel}

    def writes(self) -> frozenset[str]:
        return frozenset((self.channel,))

    def structure(self) -> tuple:
        return ("Source", self.name, self.channel, fingerprint(self.expr))

    def activity(self) -> Optional[tuple[str, float]]:
        from .expr import zero_point
        return zero_point(self.expr)


@dataclasses.dataclass(frozen=True)
class Sink(Term):
    """Declared mass removal: ``rate * expr`` is SUBTRACTED from
    ``channel``; the integrated budget must be non-positive (the
    reconciliation gate raises naming this term otherwise)."""

    channel: str
    expr: Expr
    rate: float = 1.0
    name: str = ""

    conservation = SINK
    footprint = 0

    def __post_init__(self):
        object.__setattr__(self, "rate", float(self.rate))
        object.__setattr__(self, "expr", as_expr(self.expr))
        if not self.name:
            object.__setattr__(self, "name", f"sink_{self.channel}")
        self._check_name()

    def reads(self) -> frozenset[str]:
        return channels(self.expr) | {self.channel}

    def writes(self) -> frozenset[str]:
        return frozenset((self.channel,))

    def structure(self) -> tuple:
        return ("Sink", self.name, self.channel, fingerprint(self.expr))

    def activity(self) -> Optional[tuple[str, float]]:
        from .expr import zero_point
        return zero_point(self.expr)


def Clock(channel: str = "t", name: str = "clock") -> Source:
    """A step counter as physics: a Source adding 1 to ``channel``
    everywhere each step (``rate=1``). Time-varying terms read
    ``Chan(channel)``; because the clock is a DECLARED source its
    growth reconciles exactly in the budget gate — no special-cased
    bookkeeping channel."""
    return Source(channel, Const(1.0), rate=1.0, name=name)


def validate_terms(terms) -> tuple[Term, ...]:
    """Shared construction-time validation: term types, unique names,
    and at least one term. Channel existence is checked against the
    space at lowering time (the step builder has the space)."""
    terms = tuple(terms)
    if not terms:
        raise ValueError("a Flow IR model needs at least one term")
    seen: set[str] = set()
    for t in terms:
        if not isinstance(t, Term):
            raise TypeError(
                f"{type(t).__name__} is not an IR Term (the grammar is "
                "Transport/Transfer/Source/Sink — see ir.terms)")
        if t.name in seen:
            raise ValueError(
                f"duplicate term name {t.name!r}: names key budget "
                "channels and conservation errors, so they must be "
                "unique within a model")
        seen.add(t.name)
    return terms
