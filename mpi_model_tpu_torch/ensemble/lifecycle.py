"""The declared ticket-lifecycle machines (counterpart of
``mpi_model_tpu/ensemble/lifecycle.py``; stdlib only, the port keeps its
own copy, equal to the JAX package's as data).

- **kind constants** (``SUBMIT`` … ``RECLAIM``): every journal append site
  and every reader dispatch names a record kind through these;
- **two machines** (:data:`FLEET`, :data:`TIERING`), one a journal stream,
  each declaring its states, legal transitions, terminal set and the meta
  keys each record kind carries;
- :data:`EVENT_KINDS`: every ``FailureEvent.kind`` the package builds;
- :data:`STAMPED_META`: the keys every record carries whatever its kind
  (``kind`` and ``t_wall`` stamped by ``TicketJournal.append``, ``arrays``
  by the payload codec, ``epoch`` by an epoch-fenced journal handle).

Consumers: ``journal.fold_records``/``replay`` fold the fleet stream with
:data:`FLEET`, ``obs.postmortem`` classifies timeline events through both,
and ``resilience.protocolcheck`` witnesses that live streams take only
declared transitions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "EPOCH",
    "EVENT_KINDS",
    "EXPIRED",
    "FLEET",
    "HIBERNATE",
    "HIBERNATED",
    "LifecycleMachine",
    "MIGRATE",
    "QUARANTINED",
    "READMIT",
    "RECLAIM",
    "REQUEUE",
    "SERVED",
    "SHED",
    "STAMPED_META",
    "SUBMIT",
    "TERMINAL_KINDS",
    "TIERING",
    "Transition",
    "WAKE",
    "machine_for_journal",
]

# -- record-kind constants (the only place these strings are spelled) ---------

#: fleet stream: admission and resolution
SUBMIT = "submit"
SERVED = "served"
QUARANTINED = "quarantined"
EXPIRED = "expired"
SHED = "shed"
#: fleet stream: attribution (the ticket moved, nothing resolved)
READMIT = "readmit"
MIGRATE = "migrate"
WAKE = "wake"
#: fleet stream: a supervisor declaring it owns the stream (first start or
#: takeover); appends stamped with a lower epoch are fenced
EPOCH = "epoch"
#: tiering stream: the hibernate/wake paging lifecycle
HIBERNATE = "hibernate"      # intent (written before the chain write)
HIBERNATED = "hibernated"    # commit (the chain record verified on disk)
REQUEUE = "requeue"          # woke, found no placement, back at the head
RECLAIM = "reclaim"          # chain deleted (resolution or orphan sweep)

#: kinds that resolve a fleet ticket (everything else is attribution)
TERMINAL_KINDS = (SERVED, QUARANTINED, EXPIRED)

#: meta keys every record carries whatever its kind
STAMPED_META = ("kind", "t_wall", "arrays", "epoch")

#: every ``resilience.FailureEvent.kind`` the package builds
EVENT_KINDS = frozenset({
    "exception",      # the step raised
    "nonfinite",      # NaN/Inf in the state
    "conservation",   # the invariant check failed
    "timeout",        # a dispatch/ticket deadline passed
    "expired",        # a ticket aged out before serving
    "member",         # a fleet member died/wedged (fence + re-admit)
    "hibernation",    # the hibernate/wake paging path failed
})


# -- the machines -------------------------------------------------------------

#: the implicit state of a ticket the stream has not mentioned yet
INITIAL = "new"


@dataclasses.dataclass(frozen=True)
class Transition:
    """One declared transition: the record ``kind`` that emits it, the
    states it is legal from, the state it lands in, and the meta keys its
    writer stamps (beyond :data:`STAMPED_META`). ``ticketless`` transitions
    are stream-level audit records with no per-ticket state."""

    kind: str
    sources: tuple
    target: str
    meta: tuple = ()
    terminal: bool = False
    ticketless: bool = False


@dataclasses.dataclass(frozen=True)
class LifecycleMachine:
    """One journal stream's declared protocol; ``journal_name`` is the
    stream's file basename (:func:`machine_for_journal`)."""

    stream: str
    journal_name: str
    states: tuple
    transitions: tuple

    def kinds(self) -> tuple:
        """Every declared record kind, in declaration order."""
        return tuple(t.kind for t in self.transitions)

    def terminal_kinds(self) -> tuple:
        return tuple(t.kind for t in self.transitions if t.terminal)

    def attribution_kinds(self) -> tuple:
        """Per-ticket kinds that move a ticket without starting or
        resolving it (what a timeline shows between submit and terminal)."""
        return tuple(t.kind for t in self.transitions
                     if not t.terminal and not t.ticketless
                     and INITIAL not in t.sources)

    def transition(self, kind: str) -> Optional[Transition]:
        for t in self.transitions:
            if t.kind == kind:
                return t
        return None

    def is_terminal(self, kind: str) -> bool:
        t = self.transition(kind)
        return t is not None and t.terminal

    def legal(self, kind: str, state: str) -> bool:
        """Is ``kind`` a declared transition out of ``state``?"""
        t = self.transition(kind)
        return t is not None and (t.ticketless or state in t.sources)

    def meta_keys(self) -> frozenset:
        """Every declared per-kind meta key plus the universal stamps."""
        keys = set(STAMPED_META)
        for t in self.transitions:
            keys.update(t.meta)
        return frozenset(keys)


#: the fleet ticket journal: one record per scheduler seam a ticket
#: crosses; a ticket is ``in-flight`` from its submit until one terminal
FLEET = LifecycleMachine(
    stream="fleet",
    journal_name="tickets.journal",
    states=(INITIAL, "in-flight", "resolved"),
    transitions=(
        Transition(SUBMIT, (INITIAL,), "in-flight",
                   meta=("ticket", "service_id", "steps", "model",
                         "trace", "dim_x", "dim_y")),
        Transition(SERVED, ("in-flight",), "resolved", terminal=True,
                   meta=("ticket", "service_id", "steps",
                         "initial_total", "final_total", "wall_time_s",
                         "dim_x", "dim_y", "recovered_from_journal")),
        Transition(QUARANTINED, ("in-flight",), "resolved",
                   terminal=True,
                   meta=("ticket", "service_id", "steps", "error",
                         "detail")),
        Transition(EXPIRED, ("in-flight",), "resolved", terminal=True,
                   meta=("ticket", "service_id", "steps", "error",
                         "detail")),
        Transition(SHED, (), INITIAL, ticketless=True,
                   meta=("depth", "members")),
        Transition(MIGRATE, ("in-flight",), "in-flight",
                   meta=("ticket", "from", "to", "reason")),
        Transition(READMIT, ("in-flight",), "in-flight",
                   meta=("ticket", "from", "to", "reason")),
        Transition(WAKE, ("in-flight",), "in-flight",
                   meta=("ticket", "to")),
        Transition(EPOCH, (), INITIAL, ticketless=True,
                   meta=("epoch", "supervisor", "takeover_from",
                         "lease_s")),
    ),
)

#: the hibernation lifecycle journal: the intent → commit → wake chain
#: around every paging operation; ``wake`` is legal only from the committed
#: state
TIERING = LifecycleMachine(
    stream="tiering",
    journal_name="hibernation.journal",
    states=(INITIAL, "hibernating", "hibernated", "resident",
            "reclaimed"),
    transitions=(
        Transition(HIBERNATE, (INITIAL, "resident"), "hibernating",
                   meta=("ticket", "seq", "steps", "nbytes", "model")),
        Transition(HIBERNATED, ("hibernating",), "hibernated",
                   meta=("ticket", "seq", "disk_bytes")),
        Transition(WAKE, ("hibernated",), "resident",
                   meta=("ticket", "seq", "source")),
        Transition(REQUEUE, ("resident",), "hibernated",
                   meta=("ticket", "seq")),
        Transition(RECLAIM, (INITIAL, "hibernating", "hibernated",
                             "resident"), "reclaimed", terminal=True,
                   meta=("ticket",)),
    ),
)

#: both declared machines, keyed by stream name
MACHINES = {FLEET.stream: FLEET, TIERING.stream: TIERING}


def machine_for_journal(path: str) -> Optional[LifecycleMachine]:
    """The machine owning a journal file, by basename; None for a journal
    the protocol does not declare."""
    import os

    base = os.path.basename(path)
    for m in MACHINES.values():
        if m.journal_name == base:
            return m
    return None
