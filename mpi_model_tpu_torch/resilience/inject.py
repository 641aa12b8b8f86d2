"""Deterministic fault injection (counterpart of
``mpi_model_tpu/resilience/inject.py``; the port keeps its own copy of the
data model and imports nothing of the JAX package).

A :class:`FaultPlan` is pure data: a seed and a tuple of :class:`Fault`
records naming the seam, the firing index and the corruption parameters, so
a chaos scenario is reproducible: the same plan against the same run fires
the same faults at the same places. The records have the JAX package's
fields, kinds and sites, and ``armed`` takes a plan of either package
(``FaultPlan.of``), so one plan arms the same firings in both.

Seams wired in the port:

=============  ==============================================================
site           where the seam lives / what the fault does
=============  ==============================================================
``executor``   ``SerialExecutor.run_model`` / ``ShardMapExecutor.run_model``
               — ``kind="exc"`` raises :class:`InjectedFault` (the call
               index in its message); ``kind="nan"`` poisons the chunk's
               output (and clears the serial executor's
               ``last_dirty_tiles``); ``kind="halo"`` (sharded) perturbs
               every ghost ring the chunk exchanges
               (``parallel.halo.exchange_ring``, ``pad_with_halo_1d``,
               ``refresh_rings``: ``halo_perturbation()`` added to the
               received top rows)
``checkpoint`` ``io.checkpoint.save_checkpoint`` and the delta chain's
               record and manifest writes — ``kind="torn"`` tears the
               file just written at step ``at`` (``channel`` pins the part:
               ``"keyframe"``, ``"delta"``, ``"chain"``; unpinned it
               matches the dense file and either record)
``ensemble``   ``batch.launch_ensemble`` — ``kind="lane_nan"`` poisons one
               scenario lane's output (by lane index, or by ticket through
               the scheduler's mapping; ``once=False`` makes it a sticky
               scenario fault that fires again on the solo retry)
``dispatch``   the scheduler — ``kind="batch_exc"`` fails one whole
               dispatch; ``kind="hang"`` adds ``seconds`` to the
               dispatch's injectable-clock duration (a hung dispatch)
``assemble``   batch assembly on the dispatching thread —
               ``kind="slow_compile"`` adds ``seconds`` to that dispatch's
               injectable-clock duration (a hung build)
``fetch``      ``batch.complete_ensemble`` — ``kind="fetch_nan"`` poisons
               lane ``lane`` (default 0) of the fetched output, downstream
               of the device work; per-lane conservation must catch it
``pump``       ``AsyncEnsembleService.pump_once`` —
               ``kind="thread_exc"`` raises :class:`InjectedFault` at the
               top of one loop iteration; the loop's supervisor counts it
               and keeps serving. The fleet's member faults, targeted by
               ``channel=service_id`` (``at``: a threshold on the pump
               count): ``kind="member_kill"`` raises :class:`MemberKilled`
               (the pump thread dies), ``kind="member_wedge"`` makes the
               iteration do nothing (a live thread making no progress)
``admission``  ``AsyncEnsembleService.submit`` — ``kind="queue_full"``
               makes one submission shed as if the queue were full
``journal``    ``ensemble.journal.TicketJournal.append`` —
               ``kind="journal_torn"`` tears the file right after record
               ``at`` (``offset`` from the record's start);
               ``kind="stale_epoch_append"`` (``channel`` = the journal
               path) makes one append behave as a one-epoch-older handle's
``wire``       ``ensemble.wire.FrameConn`` — ``kind="wire_torn"`` tears one
               outgoing frame (``tear="corrupt"`` or ``"truncate"``);
               ``kind="tcp_partition"`` closes the connection and raises
               ``WireTimeout`` on a send or receive (``channel`` pins the
               member, the connection's ``chaos_id``).
               ``ensemble.member_proc.ProcessMemberClient`` (every RPC and
               heartbeat counts the site) — ``kind="proc_kill"`` kills the
               member (a real ``SIGKILL`` of a child; the loopback
               hard-stops its serve thread); ``kind="heartbeat_loss"``
               makes a beat a miss
``handshake``  ``ensemble.wire.serve_handshake``/``client_handshake`` —
               ``kind="handshake_fail"`` garbles one side's proof
``lease``      ``ensemble.fleet.FleetSupervisor.tick`` of a named
               supervisor (``channel`` = its ``supervisor_id``; ``at``: a
               threshold on its tick count) — ``kind="supervisor_kill"``
               stops supervision dead, the journal handle left open
``tiering``    ``ensemble.tiering.ScenarioTiering``: ``hibernate`` tears the
               chain record it just wrote (``hibernate_torn``, ``at`` = the
               chain seq), ``wake`` damages the newest record before its
               restore (``wake_corrupt``, ``ticket``: None for any),
               ``pressure`` forces one admission down the paging path
               (``residency_pressure``)
=============  ==============================================================

Disarmed, every seam costs one module-global read (``active() is None``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Optional

__all__ = [
    "Fault",
    "FaultPlan",
    "ArmedPlan",
    "InjectedFault",
    "MemberKilled",
    "armed",
    "active",
    "halo_perturbation",
    "build_token",
    "poison_values",
    "poison_lane_values",
    "checkpoint_torn",
    "journal_torn",
    "hibernate_torn",
    "wake_corrupt",
    "stale_epoch_append",
    "tear_file",
]


class InjectedFault(RuntimeError):
    """What an armed ``exc``/``batch_exc``/``thread_exc`` fault raises: a
    type of its own, so injected chaos is told apart from a real failure
    leaking through the same path."""


class MemberKilled(BaseException):
    """The fleet's ``member_kill`` fault: a ``BaseException``, so a pump
    loop's ``except Exception`` supervisor does not survive it (the pump
    thread dies, and the fleet's health check fences the member)."""


#: fault kind → seam site (one table, so a misspelt kind fails when the
#: plan is built instead of never firing)
SITE_OF = {
    "exc": "executor",
    "nan": "executor",
    "halo": "executor",
    "torn": "checkpoint",
    "lane_nan": "ensemble",
    "batch_exc": "dispatch",
    "hang": "dispatch",
    # the always-on serving loop
    "thread_exc": "pump",
    "slow_compile": "assemble",
    "fetch_nan": "fetch",
    "queue_full": "admission",
    # fleet supervision
    "member_kill": "pump",
    "member_wedge": "pump",
    "journal_torn": "journal",
    # the multi-process fleet's wire
    "proc_kill": "wire",
    "heartbeat_loss": "wire",
    "wire_torn": "wire",
    # scenario tiering
    "hibernate_torn": "tiering",
    "wake_corrupt": "tiering",
    "residency_pressure": "tiering",
    # multi-host fleet and supervisor failover
    "handshake_fail": "handshake",
    "tcp_partition": "wire",
    "supervisor_kill": "lease",
    "stale_epoch_append": "journal",
}


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault: where (kind → seam site), when (``at``: the seam's
    0-based firing index; for ``torn`` the checkpoint step, for the member
    faults a threshold on the pump count) and the corruption parameters.
    ``once=True`` consumes the fault at its first firing (a transient fault
    the recovery layer must heal); ``once=False`` keeps it armed (a
    deterministic fault the layer must quarantine)."""

    kind: str
    #: seam firing index (None = first opportunity)
    at: Optional[int] = None
    #: channel to poison (None → first channel); the member faults' target
    #: ``service_id``, the tears' part name
    channel: Optional[str] = None
    #: cell to poison (None → (0, 0))
    cell: Optional[tuple] = None
    #: scenario lane to poison (direct ``run_ensemble`` use; the
    #: ``fetch_nan`` lane, default 0)
    lane: Optional[int] = None
    #: scheduler ticket whose lane to poison (the scheduler maps it)
    ticket: Optional[int] = None
    #: byte offset for the tears
    offset: int = 0
    #: bytes corrupted at the offset (tear="corrupt")
    nbytes: int = 64
    #: "truncate" (cut the file at offset) or "corrupt" (flip bytes)
    tear: str = "corrupt"
    #: injected hang ("hang"/"slow_compile"), injectable-clock seconds
    seconds: float = 0.0
    #: poison value (None → NaN) or halo perturbation (None → seeded)
    value: Optional[float] = None
    once: bool = True

    def __post_init__(self):
        if self.kind not in SITE_OF:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(expected one of {sorted(SITE_OF)})")
        if self.tear not in ("truncate", "corrupt"):
            raise ValueError(f"unknown tear mode {self.tear!r}")
        if (self.kind in ("member_wedge", "heartbeat_loss", "proc_kill",
                          "wire_torn", "tcp_partition")
                and not self.once and self.channel is None):
            raise ValueError(
                f"a sticky {self.kind} (once=False) must pin its member "
                "via channel=service_id: unpinned it would hit every "
                "replacement generation too, an unbounded fence/restart "
                "loop")

    @property
    def site(self) -> str:
        return SITE_OF[self.kind]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible chaos scenario: pure data. ``seed`` feeds the derived
    perturbation values (``value_for``), so an unpinned fault still
    corrupts deterministically."""

    faults: tuple
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def of(cls, plan) -> "FaultPlan":
        """``plan`` as this module's ``FaultPlan``: any object with
        ``faults`` (records carrying ``Fault``'s fields) and ``seed``, such
        as the JAX package's plan, is copied field by field."""
        if isinstance(plan, cls):
            return plan
        names = [f.name for f in dataclasses.fields(Fault)]
        return cls(tuple(Fault(**{n: getattr(f, n) for n in names})
                         for f in plan.faults), seed=plan.seed)

    def value_for(self, index: int) -> float:
        """Deterministic perturbation magnitude for fault ``index`` when
        its ``value`` is unpinned, from a generator seeded by
        ``(seed, index)``: stable across runs, platforms and packages."""
        import numpy as np

        return float(np.random.default_rng((self.seed, index))
                     .uniform(1.0, 2.0))


class ArmedPlan:
    """Runtime state of one armed plan: per-site firing counters, the
    consumed-fault set, and the ``fired`` log (what went off, in order).
    Internally locked (a plain leaf lock): the seams are consulted from the
    pump thread and from client threads at once."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._mutex = threading.Lock()
        self._counters: dict = {}
        self._consumed: set = set()
        #: [{"index", "site", "kind", "at"}]: every firing, in order
        self.fired: list = []
        #: halo perturbation of the current chunk (set only inside
        #: ``halo_window``)
        self.halo_eps: Optional[float] = None
        #: (lane, Fault) poisons the scheduler pushed for the current
        #: physical dispatch (the ticket → lane mapping is the scheduler's)
        self._lane_poisons: list = []

    def bump(self, site: str) -> int:
        """Advance and return ``site``'s firing index (every seam visit
        counts, retries included, so ``at`` is deterministic)."""
        with self._mutex:
            idx = self._counters.get(site, 0)
            self._counters[site] = idx + 1
            return idx

    def take(self, site: str, index: Optional[int] = None,
             kinds: Optional[tuple] = None) -> Optional[Fault]:
        """First live fault matching (site, index, kinds); consumed when
        ``once``. ``index=None`` matches only index-unpinned faults."""
        with self._mutex:
            for i, f in enumerate(self.plan.faults):
                if f.site != site or (kinds is not None
                                      and f.kind not in kinds):
                    continue
                if i in self._consumed:
                    continue
                if f.at is not None and f.at != index:
                    continue
                if f.ticket is not None:
                    continue  # ticket faults fire through ticket_fault
                self._fire_locked(i, f)
                return f
            return None

    def member_fault(self, service_id, kinds: tuple, site: str = "pump",
                     count: bool = False) -> Optional[Fault]:
        """Live member-targeted fault aimed at ``service_id`` (``channel``
        None or equal to it) whose ``at`` threshold on the ``site`` count
        has been reached; ``count=True`` advances the count first."""
        with self._mutex:
            if count:
                idx = self._counters.get(site, 0)
                self._counters[site] = idx + 1
            pumps = self._counters.get(site, 0)
            for i, f in enumerate(self.plan.faults):
                if f.kind not in kinds or i in self._consumed:
                    continue
                if f.channel is not None and f.channel != service_id:
                    continue
                if f.at is not None and pumps < f.at:
                    continue
                self._fire_locked(i, f)
                return f
            return None

    def ticket_fault(self, ticket) -> Optional[Fault]:
        """Live ``lane_nan`` fault bound to ``ticket``; consumed per its
        ``once``."""
        with self._mutex:
            for i, f in enumerate(self.plan.faults):
                if (f.kind == "lane_nan" and f.ticket == ticket
                        and i not in self._consumed):
                    self._fire_locked(i, f)
                    return f
            return None

    def _fire_locked(self, i: int, f: Fault) -> None:
        if f.once:
            self._consumed.add(i)
        self.fired.append({"index": i, "site": f.site, "kind": f.kind,
                           "at": f.at})

    def _fire(self, i: int, f: Fault) -> None:
        with self._mutex:
            self._fire_locked(i, f)

    @contextlib.contextmanager
    def halo_window(self, fault: Fault):
        """Arm the halo perturbation for one executor chunk."""
        idx = self.plan.faults.index(fault)
        eps = (fault.value if fault.value is not None
               else self.plan.value_for(idx))
        with self._mutex:
            self.halo_eps = eps
        try:
            yield
        finally:
            with self._mutex:
                self.halo_eps = None

    def push_lane_poisons(self, poisons: list) -> None:
        with self._mutex:
            self._lane_poisons = list(poisons)

    def clear_lane_poisons(self) -> None:
        with self._mutex:
            self._lane_poisons = []

    def ensemble_poisons(self, index: int) -> list:
        """(lane, Fault) pairs to poison in this dispatch: the scheduler's
        pushed ticket poisons plus any direct lane faults matching the
        ensemble-site firing index."""
        with self._mutex:
            out = list(self._lane_poisons)
        for i, f in enumerate(self.plan.faults):
            if (f.kind == "lane_nan" and f.ticket is None
                    and f.lane is not None and i not in self._consumed
                    and (f.at is None or f.at == index)):
                self._fire(i, f)
                out.append((f.lane, f))
        return out


_ACTIVE: Optional[ArmedPlan] = None


def active() -> Optional[ArmedPlan]:
    """The armed plan's runtime state, or None: the one read every seam
    makes first."""
    return _ACTIVE


@contextlib.contextmanager
def armed(plan):
    """Arm ``plan`` (this module's ``FaultPlan`` or the JAX package's,
    converted by ``FaultPlan.of``) for the duration of the block, one plan
    at a time."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already armed")
    st = ArmedPlan(FaultPlan.of(plan))
    _ACTIVE = st
    try:
        yield st
    finally:
        _ACTIVE = None


# -- seam helpers ---------------------------------------------------------------

def halo_perturbation() -> Optional[float]:
    """The current chunk's ghost-ring perturbation, or None."""
    st = _ACTIVE
    return None if st is None else st.halo_eps


def build_token():
    """Runner-cache key component: non-None only while a halo fault is
    armed, so a perturbed build never enters the clean cache."""
    st = _ACTIVE
    if st is None or st.halo_eps is None:
        return None
    return ("chaos-halo", st.halo_eps)


def _poison_value(fault: Fault) -> float:
    return float("nan") if fault.value is None else float(fault.value)


def poison_values(values: dict, fault: Fault, plan: FaultPlan) -> dict:
    """NaN (or ``fault.value``) in one cell of one channel of an executor
    chunk's output values (a copy; the input is untouched)."""
    ch = fault.channel if fault.channel is not None else next(iter(values))
    x, y = fault.cell if fault.cell is not None else (0, 0)
    v = values[ch].clone()
    v[x, y] = _poison_value(fault)
    return {**values, ch: v}


def poison_lane_values(values_b: dict, lane: int, fault: Fault) -> dict:
    """NaN (or ``fault.value``) in one cell of one channel of scenario
    ``lane``, written into the ensemble output in place (on the card, queued
    on the current stream)."""
    ch = fault.channel if fault.channel is not None else next(iter(values_b))
    x, y = fault.cell if fault.cell is not None else (0, 0)
    values_b[ch][lane, x, y] = _poison_value(fault)
    return values_b


def checkpoint_torn(path: str, step: int, part: str = "data") -> None:
    """Checkpoint-writer seam: tear the just-written file when a ``torn``
    fault is armed for this step and part."""
    st = _ACTIVE
    if st is None:
        return
    for i, f in enumerate(st.plan.faults):
        if f.kind != "torn" or i in st._consumed:
            continue
        if f.at is not None and f.at != step:
            continue
        want_part = f.channel or "data"
        if want_part != part and not (
                want_part == "data" and part in ("keyframe", "delta")):
            continue
        st._fire(i, f)
        tear_file(path, f.offset, f.nbytes, f.tear)
        return


def journal_torn(path: str, index: int, record_start: int) -> None:
    """Ticket-journal seam: tear the journal right after record ``index``
    (``offset`` relative to the record's start)."""
    st = _ACTIVE
    if st is None:
        return
    for i, f in enumerate(st.plan.faults):
        if f.kind != "journal_torn" or i in st._consumed:
            continue
        if f.at is not None and f.at != index:
            continue
        st._fire(i, f)
        tear_file(path, record_start + f.offset, f.nbytes, f.tear)
        return


def hibernate_torn(path: str, seq: int) -> None:
    """Tiering seam: tear the chain record a hibernation just wrote
    (``ScenarioTiering.hibernate``)."""
    st = _ACTIVE
    if st is None:
        return
    for i, f in enumerate(st.plan.faults):
        if f.kind != "hibernate_torn" or i in st._consumed:
            continue
        if f.at is not None and f.at != seq:
            continue
        st._fire(i, f)
        tear_file(path, f.offset, f.nbytes, f.tear)
        return


def wake_corrupt(ticket) -> Optional[Fault]:
    """Tiering seam: a live ``wake_corrupt`` fault aimed at ``ticket``
    (None matches any wake), consumed per ``once``
    (``ScenarioTiering.wake``)."""
    st = _ACTIVE
    if st is None:
        return None
    with st._mutex:
        for i, f in enumerate(st.plan.faults):
            if f.kind != "wake_corrupt" or i in st._consumed:
                continue
            if f.ticket is not None and f.ticket != ticket:
                continue
            st._fire_locked(i, f)
            return f
        return None


def stale_epoch_append(path: str) -> bool:
    """Journal epoch-fence seam: True when a live ``stale_epoch_append``
    fault says this append behaves as a zombie supervisor's."""
    st = _ACTIVE
    if st is None:
        return False
    with st._mutex:
        for i, f in enumerate(st.plan.faults):
            if f.kind != "stale_epoch_append" or i in st._consumed:
                continue
            if f.channel is not None and f.channel != path:
                continue
            st._fire_locked(i, f)
            return True
        return False


def tear_file(path: str, offset: int = 0, nbytes: int = 64,
              tear: str = "corrupt") -> None:
    """Damage ``path`` deterministically: ``truncate`` cuts it at
    ``offset``; ``corrupt`` flips ``nbytes`` bytes from there."""
    size = os.path.getsize(path)
    if tear == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(min(offset, size))
        return
    off = min(offset, max(size - 1, 0))
    with open(path, "r+b") as fh:
        fh.seek(off)
        data = fh.read(nbytes)
        fh.seek(off)
        fh.write(bytes(b ^ 0xFF for b in data))
