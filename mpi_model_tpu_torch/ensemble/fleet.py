"""The fleet supervisor: one arrival stream over N always-on members
(counterpart of ``mpi_model_tpu/ensemble/fleet.py``, with its names, its
surface and its journal records).

- **Routing.** Structure-affine with a least-queue-depth tiebreak: a
  scenario's ``structure_key`` (and step count) picks a preferred member,
  so scenarios that batch together keep landing on one member and its
  runner cache stays warm; when the preferred member sheds (full queue,
  health gate, an injected ``queue_full``) the others are tried in
  ascending queue depth. The fleet sheds only when every member refuses.
- **Autoscaling.** ``AutoscalePolicy`` over the serving signals (shed
  rate, p99 queue latency, queue-depth occupancy, ``intake_gated``),
  evaluated once a supervision tick on the injectable clock, within
  ``[min_services, max_services]``, with hysteresis both ways and a
  cooldown. Scale-down is drain-before-retire: the retiring member takes
  no intake, its queued tickets move through ``migrate_ticket`` (the
  CRC-checked handoff), and it leaves once it holds nothing.
- **Failure domains.** Each tick checks every member: a dead pump
  (``member_kill``, a real thread death), a member with due work and no
  progress past ``supervision_deadline_s`` (``member_wedge``), a wire
  member whose heartbeats went stale (``proc_kill``, ``heartbeat_loss``, a
  ``kill -9``), or one at the bottom of the degradation ladder is fenced:
  its queued tickets migrate, its claimed or launched ones are re-admitted
  from the fleet's own copy of their state, and a fresh member starts in
  the slot as generation + 1. Each fence is a ``FailureEvent(kind=
  "member")`` in ``member_log``, a ``fence`` flight record with the ring
  dumped beside it, and a ``respawn`` record when the replacement starts.
  Spawns run outside the fleet lock (a process member's spawn takes
  seconds); a failed spawn is retried the next tick, and the drain of a
  sole fenced member waits for it.
- **Crash-restart recovery.** With ``journal_dir`` every ticket's life is
  journaled (TJ1) at the fleet's seams: admission with its state, the
  harvest, quarantine or expiry, migration, re-admission, shed.
  ``FleetSupervisor.recover(journal_dir, model)`` replays the verified
  prefix: terminal tickets resolve from the journal (a served ticket is
  not run again), the rest are re-admitted under their original ids, on
  ``device``. Either package recovers the other's journal.
- **Failover.** A named supervisor (``supervisor_id``) declares a new
  journal epoch and renews ``supervisor.lease`` every tick; a
  ``StandbySupervisor`` takes the fleet over when the lease goes stale,
  and the old supervisor is fenced on the journal (``StaleEpochError``)
  and on its members' wires (their epoch ratchet). The
  ``supervisor_kill`` seam stops supervision dead.

- **Scenario tiering.** With ``residency_budget`` and ``hibernate_dir``
  (both or neither) a submission the budget cannot take, or that every
  member refuses, hibernates to the vault (``ensemble.tiering``) instead of
  shedding; each tick wakes hibernated tickets FIFO onto the affinity
  member as capacity frees (the chain restore outside the fleet lock, the
  placement atomic with the route table), attributed per member
  (``wakes_by_member``). A wake whose chain does not verify re-admits from
  the fleet journal's submit record; with neither it resolves as
  ``HibernationError``. ``stop`` wakes every hibernated ticket before the
  members drain; ``recover`` re-enters the tickets hibernated at a crash
  from their chains. A hibernated ticket belongs to no member and holds no
  state in the fleet: ``_hib_meta`` keeps its model, steps, structure key,
  submit time and trace.

Members are in-process ``AsyncEnsembleService``s (``member_transport=
"inproc"``) or members behind the wire (``"process"``: a child over a unix
socket from ``member_proc.spawn_process_member``; ``"tcp"``: the same child
over an authenticated TCP socket on ``member_host``, a fresh secret in its
environment and the HMAC handshake before the first frame; or any
``member_spawner``, such as ``spawn_loopback_member``). ``member_env`` is
laid over each child's environment: a dict for every member, a sequence
pinned per slot (``member_env[slot % len]``), or a callable of the slot.
``device`` is where the fleet's wire members serve and where journaled and
wired states land (the card unless the caller names the CPU).

The fleet lock is ``lockdep.condition("FleetSupervisor._cv")``, the JAX
package's key; members' device work never runs under it. ``start=False``
builds members in manual mode: ``pump_once()`` pumps each member once, then
runs one supervision ``tick``. The fleet has the service surface
(``submit``, ``poll``, ``result``, ``stats``, ``stop``, a context manager),
so ``run_soak`` drives it unchanged.

A ``mesh`` member kwarg (an ``EnsembleMesh``, a batch extent or a
``(batch, space)`` pair) places each member's dispatches over a mesh: an
in-process member's resolves against the fleet's ``device``, a wire
member's crosses as its extents and resolves in the child.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import threading
import time
import warnings
from typing import Callable, Optional

from ..core.cellular_space import CellularSpace, resolve_device
from ..obs.flight import get_recorder
from ..resilience import inject, lockdep
from ..utils.metrics import ThroughputCounter
from ..utils.tracing import TraceContext, get_tracer
from .batch import structure_key
from .journal import (StaleEpochError, TicketJournal, declare_epoch,
                      journal_path, model_from_meta, model_meta, replay,
                      space_from_record, space_payload)
from .lifecycle import (EXPIRED, MIGRATE, QUARANTINED, READMIT, SERVED,
                        SHED, SUBMIT, WAKE)
from .member_proc import resolve_deadlines, spawn_process_member
from .scheduler import TicketExpired, TicketNotMigratable
from .service import AsyncEnsembleService, ServiceOverloaded
from .tiering import HibernationError, ScenarioTiering, scenario_nbytes
from .wire import WireError

__all__ = ["AutoscalePolicy", "FleetSupervisor", "MemberFailure",
           "StandbySupervisor", "lease_path", "read_lease"]

#: the supervisor lease file in a journal directory: JSON ``{"owner",
#: "epoch", "t", "lease_s"}``, rewritten atomically every tick by the
#: active supervisor, on the clock it shares with its standby
LEASE_NAME = "supervisor.lease"


def lease_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, LEASE_NAME)


def read_lease(path: str) -> Optional[dict]:
    """The lease record, or None when the file is missing or garbled (a
    torn lease write is a missed renewal, never a crash)."""
    try:
        with open(path) as fh:
            rec = json.load(fh)
        return rec if isinstance(rec, dict) else None
    except (OSError, ValueError):
        return None


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When to grow or shrink the member count (evaluated each tick). A
    tick votes up on any pressure (a shed since the last tick, aggregate
    depth above ``depth_high`` of capacity, p99 latency above
    ``latency_p99_target_s``, a health-gated member with backlog) and down
    when depth sits below ``depth_low`` with no pressure. Votes must
    persist ``scale_up_after``/``scale_down_after`` consecutive ticks, and
    ``cooldown_ticks`` pass after an action."""

    min_services: int = 1
    max_services: int = 4
    depth_high: float = 0.75
    depth_low: float = 0.10
    latency_p99_target_s: Optional[float] = None
    scale_up_after: int = 2
    scale_down_after: int = 4
    cooldown_ticks: int = 2

    def __post_init__(self):
        if not 1 <= self.min_services <= self.max_services:
            raise ValueError(
                f"need 1 <= min_services ({self.min_services}) <= "
                f"max_services ({self.max_services})")


@dataclasses.dataclass
class _Member:
    """One fleet slot's current occupant."""

    service: AsyncEnsembleService
    slot: int
    gen: int
    fenced: bool = False
    retiring: bool = False
    #: why this member drains out: "scale" (autoscale, counted as a
    #: scale_down) or "fence" (a live fencing at the ladder's bottom: its
    #: in-flight batches finish here instead of being re-admitted)
    retire_kind: str = "scale"
    #: a manual-mode pump raised MemberKilled (a threaded death is probed
    #: through the thread)
    dead: bool = False
    #: wedge detection: the last progress signature and when it changed
    progress_sig: tuple = ()
    progress_t: float = 0.0

    @property
    def service_id(self) -> str:
        return self.service.service_id


@dataclasses.dataclass
class _Route:
    """One outstanding fleet ticket: where it lives now, and the fleet's
    own copy of the scenario (the re-admission source when its member dies
    with it claimed or launched)."""

    member: Optional[_Member]
    member_ticket: int
    space: CellularSpace
    model: object
    steps: int
    submitted_at: float
    #: the fleet submit span's TraceContext: re-admissions re-attach it,
    #: and the journal's submit record carries it
    trace: Optional[object] = None


class MemberFailure(RuntimeError):
    """A fleet member was fenced and no healthy member could take the
    ticket; carries the member's ``service_id``."""

    def __init__(self, message: str, service_id: str):
        super().__init__(message)
        self.service_id = service_id


class FleetSupervisor:
    """N ``AsyncEnsembleService`` members behind one service surface
    (module docstring). Keyword arguments not named here go to every member
    (``steps``, ``impl``, ``substeps``, ``max_queue``, ``deadline_s``,
    ``retry``, ``windows``, ...); ``clock`` is shared by the supervision
    timers and every member. ``start=True`` starts the members' pump
    threads and one supervision thread; ``start=False`` is manual mode."""

    def __init__(self, model, *, services: int = 2,
                 policy: Optional[AutoscalePolicy] = None,
                 journal_dir: Optional[str] = None,
                 journal_results: bool = True,
                 supervision_deadline_s: float = 5.0,
                 tick_interval_s: float = 0.05,
                 fence_on_ladder_bottom: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True,
                 poll_interval_s: float = 0.02,
                 member_transport: str = "inproc",
                 member_spawner: Optional[Callable] = None,
                 member_host: str = "127.0.0.1",
                 heartbeat_deadline_s: Optional[float] = None,
                 rpc_deadline_s: Optional[float] = None,
                 supervisor_id: Optional[str] = None,
                 lease_s: float = 2.0,
                 takeover_from: Optional[str] = None,
                 member_env: Optional[dict] = None,
                 residency_budget: Optional[int] = None,
                 hibernate_dir: Optional[str] = None,
                 hibernate_budget: Optional[int] = None,
                 device=None,
                 **member_kwargs):
        if services < 1:
            raise ValueError(f"services={services} must be >= 1")
        if policy is not None and services > policy.max_services:
            raise ValueError(
                f"services={services} exceeds the policy's max_services="
                f"{policy.max_services}")
        if member_transport not in ("inproc", "process", "tcp"):
            raise ValueError(
                f"unknown member_transport {member_transport!r} "
                "(expected 'inproc', 'process' or 'tcp')")
        if (residency_budget is None) != (hibernate_dir is None):
            raise ValueError(
                "scenario tiering needs BOTH residency_budget and "
                "hibernate_dir (or neither)")
        #: where wire members serve, journaled, wired and woken states land
        self.device = resolve_device(device)
        if member_kwargs.get("mesh") is not None \
                and member_transport == "inproc":
            from .mesh import resolve_ensemble_mesh

            member_kwargs["mesh"] = resolve_ensemble_mesh(
                member_kwargs["mesh"], device=self.device)
        self._transport = member_transport
        # TCP members get the jitter-tolerant deadlines (wire.TCP_*)
        self._heartbeat_deadline, self._rpc_deadline = resolve_deadlines(
            "tcp" if member_transport == "tcp" else "unix",
            heartbeat_deadline_s, rpc_deadline_s)
        if (member_env is not None and not isinstance(member_env, dict)
                and not callable(member_env)):
            member_env = [dict(e) if e else {} for e in member_env]
            if not member_env:
                raise ValueError(
                    "member_env sequence must not be empty (pass None "
                    "for no pinning)")
        self._member_env = member_env
        self._spawner = member_spawner
        if member_transport in ("process", "tcp"):
            if self._spawner is None:
                self._spawner = (
                    functools.partial(spawn_process_member,
                                      transport="tcp", host=member_host)
                    if member_transport == "tcp" else spawn_process_member)
            if model_meta(model) is None:
                raise ValueError(
                    f"member_transport={member_transport!r} needs a "
                    "template model model_meta() can serialize "
                    "(scalar-field flows); this model has no wire "
                    "recipe")
        self.model = model
        self.default_steps = (int(member_kwargs["steps"])
                              if member_kwargs.get("steps") is not None
                              else model.num_steps)
        self._policy = policy
        self._member_kwargs = dict(member_kwargs)
        self._member_kwargs["clock"] = clock
        self._member_kwargs.setdefault("max_queue", 64)
        self._member_kwargs.setdefault("poll_interval_s", poll_interval_s)
        self._max_queue = int(self._member_kwargs["max_queue"])
        self._supervision_deadline = float(supervision_deadline_s)
        self._tick_interval = float(tick_interval_s)
        self._fence_on_ladder_bottom = bool(fence_on_ladder_bottom)
        self._clock = clock
        self._threaded = bool(start)
        self._poll_interval = float(poll_interval_s)
        #: the fleet lock (a Condition: result() waiters park on it); every
        #: supervisor-state mutation holds it, no member device work runs
        #: under it
        self._cv = lockdep.condition("FleetSupervisor._cv")
        self._members: dict[int, _Member] = {}
        self._route: dict[int, _Route] = {}
        self._resolved: dict[int, object] = {}
        self._ids = itertools.count()
        self._slot_ids = itertools.count()
        #: FailureEvent(kind="member") per fencing, in order
        self.member_log: list = []
        #: the fleet's counters: fleet-wide sheds only, fleet-observed
        #: latency, member_faults/readmitted/scale_ups/scale_downs, the
        #: wire's and the failover's
        self.counter = ThroughputCounter()
        self.journal: Optional[TicketJournal] = None
        self._journal_results = bool(journal_results)
        #: a named supervisor declares a fresh journal epoch (fencing every
        #: older handle) and renews the lease each tick; an anonymous one
        #: stamps no epochs and keeps no lease
        self._supervisor_id = supervisor_id
        self._lease_s = float(lease_s)
        self._lease_path: Optional[str] = None
        if supervisor_id is not None and journal_dir is None:
            raise ValueError(
                "supervisor_id needs journal_dir: failover is fenced "
                "through the journal's epoch file and lease")
        if journal_dir is not None:
            if supervisor_id is not None:
                self.journal = TicketJournal(journal_path(journal_dir),
                                             epoch=0)
                declare_epoch(self.journal, supervisor=supervisor_id,
                              takeover_from=takeover_from,
                              lease_s=self._lease_s)
                self._lease_path = lease_path(journal_dir)
                self._renew_lease()
            else:
                self.journal = TicketJournal(journal_path(journal_dir))
        #: the paging tier (module docstring), None without a budget
        self.tiering: Optional[ScenarioTiering] = (
            ScenarioTiering(hibernate_dir,
                            residency_budget=residency_budget,
                            hibernate_budget=hibernate_budget,
                            clock=clock, counter=self.counter,
                            device=self.device)
            if residency_budget is not None else None)
        #: hibernated fleet tickets, under ``_cv``: ticket → (model, steps,
        #: skey, submitted_at, trace); the state lives only in the vault
        #: chain and the fleet journal's submit record
        self._hib_meta: dict = {}
        #: wake placements per member id (m<slot>g<gen>)
        self._wakes_by_member: dict = {}
        #: (stat signature, JournalState): the journal-fallback wake's
        #: replay cache (``_journal_state_fallback``)
        self._journal_fallback_cache: Optional[tuple] = None
        #: counters of fenced or retired members, folded into stats() so
        #: the work a dead member did still counts
        self._absorbed: dict = {}
        # autoscale hysteresis state
        self._up_ticks = 0
        self._down_ticks = 0
        self._cooldown = 0
        self._last_shed = 0
        self._stop_flag = False
        self._stopped = False
        #: spawn requests a tick failed to fulfil, retried the next tick
        self._pending_spawns: list = []
        #: fenced members whose drain waits for their replacement (its
        #: spawn failed and no live member remained)
        self._pending_fences: list = []
        #: a simulated process kill: tick() becomes a no-op
        self._abandoned = False
        self._thread: Optional[threading.Thread] = None
        with self._cv:
            for _ in range(services):
                self._spawn_locked(next(self._slot_ids), 0)
        if start:
            t = threading.Thread(target=self._supervise_loop, daemon=True,
                                 name="fleet-supervisor")
            with self._cv:
                self._thread = t
            t.start()

    # -- lifecycle -----------------------------------------------------------

    def _member_env_for(self, slot: int) -> Optional[dict]:
        """The environment pin of one slot: the dict, the sequence's
        ``slot % len`` entry (a respawned generation keeps its slot's pin),
        or the callable's answer."""
        me = self._member_env
        if me is None or isinstance(me, dict):
            return me
        if callable(me):
            return me(slot)
        return me[slot % len(me)]

    def _make_member(self, slot: int, gen: int) -> _Member:
        """Build one member without touching fleet state (safe outside the
        fleet lock: a process member's spawn takes seconds)."""
        sid = f"m{slot}g{gen}"
        if self._transport == "inproc":
            svc = AsyncEnsembleService(self.model, service_id=sid,
                                       start=self._threaded,
                                       **self._member_kwargs)
        else:
            # the spawner owns the transport; the member pumps itself when
            # the fleet is threaded, and is pumped over the wire in manual
            # mode
            svc = self._spawner(
                self.model, service_id=sid,
                member_kwargs=dict(self._member_kwargs),
                clock=self._clock,
                heartbeat_deadline_s=self._heartbeat_deadline,
                rpc_deadline_s=self._rpc_deadline,
                member_env=self._member_env_for(slot),
                pump_mode="thread" if self._threaded else "rpc",
                device=self.device)
        if (self.journal is not None and self.journal.epoch is not None
                and hasattr(svc, "epoch")):
            # the member-side fence: every RPC carries this supervisor's
            # epoch, and a member that saw a newer one refuses it
            svc.epoch = self.journal.epoch
        if gen > 0:
            self.counter.bump("respawns")
            get_recorder().record("respawn", service_id=sid)
        return _Member(service=svc, slot=slot, gen=gen,
                       progress_t=self._clock())

    def _install_locked(self, m: _Member) -> _Member:
        self._members[m.slot] = m
        return m

    def _spawn_locked(self, slot: int, gen: int) -> _Member:
        """Spawn and install in one step: the constructor's and recovery's
        path, before any traffic contends for the lock."""
        # analysis: ignore[blocking-under-lock] — constructor/recovery only:
        # no client traffic exists yet, so nothing contends for the fleet lock
        # during these spawns; every live spawn runs through tick()'s unlocked
        # phase
        return self._install_locked(self._make_member(slot, gen))

    def stop(self) -> None:
        """Drain and stop: members drain their queues, the final tick
        harvests everything, the journal closes. Idempotent."""
        with self._cv:
            if self._stopped:
                return
            self._stop_flag = True
            t = self._thread
            self._cv.notify_all()
        if t is not None:
            t.join()
        # hibernated tickets wake first, onto members still pumping, so the
        # members' drains below resolve them with the rest
        self._drain_hibernated()
        with self._cv:
            members = [m for m in self._members.values()
                       if not m.dead and not m.fenced]
        for m in members:
            m.service.stop()
        self.tick()
        with self._cv:
            self._stopped = True
            if self.journal is not None:
                self.journal.close()
            if self.tiering is not None:
                self.tiering.close()
            remaining = list(self._members.values())
        if self._transport != "inproc":
            # the wire teardown comes after the final harvest: stop()'s
            # drain kept each connection open for it
            for m in remaining:
                try:
                    m.service.close()
                except WireError:  # pragma: no cover - best effort
                    pass

    def abandon(self) -> None:
        """Walk away without draining (the crash the recovery tests
        simulate): supervision stops dead, members are abandoned, the
        journal closes with what was already written."""
        with self._cv:
            self._stop_flag = True
            self._stopped = True
            self._abandoned = True
            t = self._thread
            members = list(self._members.values())
            self._cv.notify_all()
        if t is not None:
            # join before closing the journal: a close racing a harvest
            # append would make the simulated kill a real I/O error
            t.join()
        for m in members:
            m.service.abandon()
        with self._cv:
            if self.journal is not None:
                self.journal.close()
            if self.tiering is not None:
                # the vault survives, as the journal does
                self.tiering.close()

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _supervise_loop(self) -> None:
        while True:
            try:
                self.tick()
            # analysis: ignore[broad-except] — the supervision loop's own
            # supervisor: a tick failure (a journal write on a full disk) is
            # counted and survived; a dead supervisor is a dead fleet
            # the supervision loop's supervisor: a failing tick (a journal
            # write on a full disk) is counted and survived
            except Exception:
                self.counter.bump("loop_faults")
            with self._cv:
                if self._stop_flag:
                    return
                self._cv.wait(self._tick_interval)

    def _renew_lease(self) -> None:
        """Re-stamp ``supervisor.lease`` (tmp and replace: a reader sees
        the old record or the new one). A failed write is a missed renewal,
        counted and warned."""
        if self._lease_path is None:
            return
        rec = {"owner": self._supervisor_id,
               "epoch": (self.journal.epoch
                         if self.journal is not None else None),
               "t": self._clock(), "lease_s": self._lease_s}
        tmp = self._lease_path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(json.dumps(rec))
            os.replace(tmp, self._lease_path)
        except OSError as e:
            self.counter.bump("loop_faults")
            warnings.warn(f"supervisor lease renewal failed: {e}; a "
                          "standby may take over", RuntimeWarning)

    # -- client surface ------------------------------------------------------

    def submit(self, space: CellularSpace, *, model=None,
               steps: Optional[int] = None) -> int:
        """Admit one scenario, or raise :class:`ServiceOverloaded` when
        every member refuses. The ticket is a fleet id, stable across
        fencing and migration. The admission runs in a ``fleet.submit``
        span whose context rides the ticket (the route, the journal's
        submit record, the wire's trace meta)."""
        with get_tracer().span("fleet.submit") as sm:
            ticket = self._submit_traced(space, model, steps)
            sm["ticket"] = ticket
            return ticket

    def _submit_traced(self, space: CellularSpace, model,
                       steps: Optional[int]) -> int:
        m_model = self.model if model is None else model
        trace = get_tracer().current()
        n = self.default_steps if steps is None else int(steps)
        skey = structure_key(m_model, space) + (n,)
        nbytes = scenario_nbytes(space)
        pressure = (self.tiering is not None
                    and self.tiering.pressure(nbytes))
        with self._cv:
            order = self._candidates_locked(skey)
            last: Optional[ServiceOverloaded] = None
            if pressure:
                order = []  # the residency budget pages before routing
            for mem in order:
                try:
                    # members run inline_dispatch=False: their submit is a
                    # depth check and an enqueue (a wire member's is a
                    # deadline-bounded RPC)
                    mt = mem.service.submit(space, model=model, steps=n)
                except ServiceOverloaded as e:
                    last = e
                    continue
                except WireError:
                    # the member's wire died: a member fault (the next
                    # tick fences it); try the next one
                    self.counter.bump("wire_errors")
                    mem.dead = True
                    continue
                ticket = next(self._ids)
                route = _Route(member=mem, member_ticket=mt, space=space,
                               model=m_model, steps=n,
                               submitted_at=self._clock(), trace=trace)
                self._route[ticket] = route
                self._journal_submit_locked(ticket, route)
                if self.tiering is not None:
                    self.tiering.admit(ticket, nbytes)
                return ticket
            if self.tiering is not None and self.tiering.room_for(nbytes):
                # every member refused, or the budget is exhausted: the
                # arrival hibernates; the journal's submit record is the
                # wake's last-resort source
                ticket = next(self._ids)
                self._journal_submit_hibernated_locked(
                    ticket, space, m_model, n, trace)
                self._hib_meta[ticket] = (m_model, n, skey, self._clock(),
                                          trace)
            else:
                ticket = None
                self.counter.bump("shed")
                get_recorder().record("shed", service_id=None)
                depth = sum(m.service.scheduler.pending_count()
                            for m in order)
                self._journal_append_locked(SHED, {
                    "depth": depth,
                    "members": [m.service_id for m in order]})
        if ticket is None:
            reason = ("hibernation tier exhausted"
                      if self.tiering is not None
                      else "every member refused")
            raise ServiceOverloaded(
                f"fleet admission shed — {reason}"
                + (f" (last: {last})" if last is not None else ""),
                queue_depth=depth,
                retry_after_s=(last.retry_after_s if last is not None
                               else self._tick_interval))
        # the chain write runs outside the fleet lock: paging I/O must not
        # stall every submit and poll
        try:
            self.tiering.hibernate(ticket, space, m_model, n,
                                   submitted_at=self._clock(), skey=skey)
        except (OSError, ValueError) as e:
            # the journaled submit must not become a ghost that never
            # resolves: journal its terminal, unregister, shed observably
            # (the caller still holds its state)
            with self._cv:
                self._hib_meta.pop(ticket, None)
                self._journal_append_locked(QUARANTINED, {
                    "ticket": ticket, "service_id": "hibernated",
                    "steps": n, "error": type(e).__name__,
                    "detail": f"hibernation write failed: {e}"})
                self.counter.bump("shed")
                get_recorder().record("shed", service_id=None)
            raise ServiceOverloaded(
                f"fleet admission shed — hibernation write failed: {e}",
                queue_depth=0, retry_after_s=self._tick_interval) from e
        return ticket

    def _candidates_locked(self, skey) -> list[_Member]:
        """Routable members, preferred first: the structure hash picks the
        affinity member; the rest follow in ascending queue depth."""
        cands = sorted(
            (m for m in self._members.values()
             if not m.fenced and not m.dead and not m.retiring),
            key=lambda m: m.slot)
        if not cands:
            return []
        preferred = cands[hash(skey) % len(cands)]
        rest = sorted(
            (m for m in cands if m is not preferred),
            key=lambda m: m.service.scheduler.pending_count())
        return [preferred] + rest

    def poll(self, ticket: int):
        """(space, Report) when resolved, None while outstanding; raises the
        ticket's quarantine, expiry or member error. Terminal outcomes are
        journaled at first sight (the harvest seam), then collected."""
        with self._cv:
            if ticket in self._resolved:
                res = self._resolved.pop(ticket)
            elif ticket in self._hib_meta:
                return None  # paged out; tick() wakes it
            else:
                route = self._route.get(ticket)
                if route is None:
                    raise KeyError(
                        f"unknown or already-collected fleet ticket "
                        f"{ticket}")
                if route.member.dead or route.member.fenced:
                    return None  # the fencing path owns this ticket
                try:
                    # analysis: ignore[blocking-under-lock] — member poll
                    # runs pump=False: it only checks the results table (the
                    # pump thread owns dispatching), so the statically visible
                    # dispatch chain never runs here
                    # pump=False on the member: a results-table check
                    r = route.member.service.poll(route.member_ticket)
                except WireError:
                    # a member fault, not the ticket's outcome: the next
                    # tick fences the member and re-admits this ticket
                    self.counter.bump("wire_errors")
                    route.member.dead = True
                    return None
                # analysis: ignore[broad-except] — harvest seam: any per-
                # ticket resolution error (quarantine, expiry, conservation,
                # dispatch fault) is journaled and returned to this ticket's
                # caller, never lost
                # the harvest seam: any per-ticket resolution error is
                # journaled and returned to this ticket's caller
                except Exception as e:
                    self._finalize_locked(ticket, e)
                    res = self._resolved.pop(ticket)
                else:
                    if r is None:
                        return None
                    self._finalize_locked(ticket, r)
                    res = self._resolved.pop(ticket)
        if isinstance(res, Exception):
            raise res
        return res

    def result(self, ticket: int, timeout: Optional[float] = None):
        """Block until ``ticket`` resolves; ``TimeoutError`` after
        ``timeout`` wall seconds (a client's bound). Manual mode pumps on
        the caller's thread."""
        deadline = (None if timeout is None
                    # analysis: ignore[naked-timer] — result()'s timeout= is
                    # a client-facing wall bound, not a measurement: nothing is
                    # recorded, so a span would be noise
                    else time.monotonic() + float(timeout))
        while True:
            res = self.poll(ticket)
            if res is not None:
                return res
            if not self._threaded:
                did = self.pump_once(force=True)
                if not did:
                    res = self.poll(ticket)
                    if res is not None:
                        return res
                    raise RuntimeError(
                        f"fleet ticket {ticket} pending but no member "
                        "found work — fleet state is inconsistent")
                continue
            with self._cv:
                # analysis: ignore[naked-timer] — the same client wall
                # bound's expiry check (no measurement recorded)
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"fleet ticket {ticket} still pending after "
                        f"{timeout}s")
                self._cv.wait(self._poll_interval)

    def pump_once(self, force: bool = False) -> bool:
        """Manual mode: pump every live member once (a ``thread_exc`` is
        counted and survived, a ``MemberKilled`` or a dead wire marks the
        member dead), then run one supervision ``tick``."""
        with self._cv:
            members = [m for m in self._members.values()
                       if not m.fenced and not m.dead]
        did = False
        for m in members:
            try:
                did = m.service.pump_once(force=force) or did
            except inject.MemberKilled:
                with self._cv:
                    m.dead = True
                did = True
            except WireError:
                self.counter.bump("wire_errors")
                with self._cv:
                    m.dead = True
                did = True
            # analysis: ignore[broad-except] — the manual-mode pump
            # supervisor mirrors AsyncEnsembleService._loop: a pump fault is
            # counted and survived, never fatal to the fleet
            # the manual-mode pump supervisor, as AsyncEnsembleService._loop
            except Exception:
                m.service.scheduler.counter.bump("loop_faults")
                did = True
        # the tick's wakes and hibernated resolutions are pump work too:
        # result()'s manual-mode progress check must see them
        c = self.counter
        before = c.wakes + c.expired + c.quarantined
        self.tick()
        return did or (self.tiering is not None
                       and c.wakes + c.expired + c.quarantined > before)

    # -- supervision ---------------------------------------------------------

    def tick(self) -> None:
        """One supervision pass: heartbeat the wire members (outside the
        lock), then (1) under the lock harvest resolved tickets, fence
        failed members and collect spawn requests; (2) without the lock
        build the replacements; (3) under the lock install them and drain
        the fenced members (harvest what resolved, migrate what is queued,
        re-admit the rest from the fleet's copy); then wake hibernated
        tickets into the freed capacity. Retired members stop after the lock
        is released."""
        if self._supervisor_id is not None:
            st = inject.active()
            if st is not None and st.member_fault(
                    self._supervisor_id, ("supervisor_kill",),
                    site="lease", count=True) is not None:
                # the simulated kill -9 of the active supervisor: the
                # flags are set here (abandon() would join the thread we
                # are on) and the journal handle stays open, a zombie's fd
                self.counter.bump("supervisor_kills")
                get_recorder().record("supervisor_kill",
                                      service_id=self._supervisor_id)
                with self._cv:
                    self._abandoned = True
                    self._stop_flag = True
                    self._stopped = True
                    self._cv.notify_all()
                return
            self._renew_lease()
        beat_t = self._heartbeat_members()
        with self._cv:
            if self._abandoned:
                return
            self._harvest_locked()
            to_fence, spawn_reqs = self._health_check_locked(beat_t)
            to_fence = self._pending_fences + to_fence
            self._pending_fences = []
            spawn_reqs = self._pending_spawns + spawn_reqs
            self._pending_spawns = []
            retired = self._advance_retirements_locked()
            if self._policy is not None and not self._stop_flag:
                req = self._autoscale_locked()
                if req is not None:
                    spawn_reqs.append(req)
            self._cv.notify_all()
        spawned = []
        failed_reqs = []
        for slot, gen in spawn_reqs:
            try:
                spawned.append(self._make_member(slot, gen))
            # analysis: ignore[broad-except] — spawn isolation: one
            # replacement failing to come up (a dead spawner, a full tmpdir)
            # must not unwind the tick past the fence drain; counted and re-
            # queued
            # spawn isolation: a replacement that fails to come up must not
            # unwind the tick past the fence drain; counted and re-queued
            except Exception:
                self.counter.bump("loop_faults")
                failed_reqs.append((slot, gen))
        completed_fences = []
        with self._cv:
            if not self._abandoned:
                self._pending_spawns.extend(failed_reqs)
                failed_slots = {slot for slot, _gen in failed_reqs}
                for m in spawned:
                    self._install_locked(m)
                live = any(not x.fenced and not x.dead
                           and not x.retiring
                           for x in self._members.values())
                for m, reason in to_fence:
                    if (m.slot in failed_slots and not m.retiring
                            and not live and not self._stop_flag):
                        # no replacement and nobody else to take its
                        # tickets: the drain waits for the re-queued spawn
                        self._pending_fences.append((m, reason))
                        continue
                    self._complete_fence_locked(m, reason)
                    completed_fences.append(m)
                self._cv.notify_all()
        # the flight ring is dumped beside each completed fence, outside the
        # lock (the dump may write a file)
        for m in completed_fences:
            get_recorder().dump("fence", service_id=m.service_id)
        self._wake_due()
        for m in retired:
            try:
                m.service.stop()
            # analysis: ignore[broad-except] — retiree-stop isolation: every
            # retiree is already out of the membership, so a failing drain on
            # one must not unwind past the next or out of tick()
            # retiree-stop isolation: a failing drain on one retiree must
            # not unwind past the next one or out of tick()
            except Exception:
                self.counter.bump("loop_faults")

    def _heartbeat_members(self) -> Optional[float]:
        """The wire transport's liveness phase (a no-op in-process): beat
        every live member outside the fleet lock, refreshing its telemetry
        cut; misses are counted. Returns the clock at the phase's end, the
        moment the health check reads each member's heartbeat age at: the
        harvest that follows moves a whole state per served ticket over
        the wire (a 4096² f32 lane is 64 MiB), and that time is the
        supervisor's, not a member's silence."""
        if self._transport == "inproc":
            return None
        with self._cv:
            if self._abandoned or self._stopped:
                return None
            members = [m for m in self._members.values()
                       if not m.fenced and not m.dead]
        for m in members:
            self.counter.bump("heartbeats")
            if not m.service.heartbeat():
                self.counter.bump("heartbeat_misses")
        return self._clock()

    def _harvest_locked(self) -> None:
        for ticket, route in list(self._route.items()):
            m = route.member
            if m.fenced or m.dead:
                continue  # the fencing path owns these
            try:
                # analysis: ignore[blocking-under-lock] — member poll runs
                # pump=False: results-table check only, the dispatch chain the
                # auditor sees is the pump's
                r = m.service.poll(route.member_ticket)
            except WireError:
                # a member fault: this tick's health check fences it
                self.counter.bump("wire_errors")
                m.dead = True
                continue
            # analysis: ignore[broad-except] — harvest seam (see poll)
            # the harvest seam (see poll)
            except Exception as e:
                self._finalize_locked(ticket, e)
                continue
            if r is not None:
                self._finalize_locked(ticket, r)

    def _journal_append_locked(self, kind: str, meta: dict,
                               arrays=None) -> None:
        """Every fleet journal write: an append failure (a full disk, a
        closed handle) is warned and counted as a loop fault, never allowed
        to unwind supervision; an epoch-fenced append (a newer supervisor
        owns the journal) writes nothing and counts a
        ``stale_epoch_rejection``. Appends run under the fleet lock, which
        orders each ticket's records (submit before its terminal);
        ``journal_results=False`` keeps served records metadata-only."""
        if self.journal is None:
            return
        try:
            # analysis: ignore[blocking-under-lock] — the documented journal-
            # append-under-the-fleet-lock cost: per-ticket record ordering
            # (submit before terminal) is exactly what this lock provides
            self.journal.append(kind, meta, arrays)
        except StaleEpochError as e:
            self.counter.bump("stale_epoch_rejections")
            warnings.warn(
                f"fleet journal append ({kind}) fenced: {e} — this "
                "supervisor was superseded; stop it", RuntimeWarning)
        except (OSError, ValueError) as e:
            self.counter.bump("loop_faults")
            warnings.warn(
                f"fleet journal append ({kind}) failed: {e} — serving "
                "continues; crash-restart recovery will re-run instead "
                "of replaying whatever this record would have resolved",
                RuntimeWarning)

    def _finalize_locked(self, ticket: int, outcome) -> None:
        route = self._route[ticket]
        sid = (route.member.service_id if route.member is not None
               else "recovery")
        try:
            if isinstance(outcome, Exception):
                kind = (EXPIRED
                        if isinstance(outcome, TicketExpired)
                        else QUARANTINED)
                self._journal_append_locked(kind, {
                    "ticket": ticket, "service_id": sid,
                    "steps": route.steps,
                    # a wire-crossed error journals its member-side class
                    "error": getattr(outcome, "remote_type",
                                     type(outcome).__name__),
                    "detail": str(outcome)})
            elif self.journal is not None:
                space, report = outcome
                meta, arrays = space_payload(space)
                if not self._journal_results:
                    arrays = None
                meta.update({
                    "ticket": ticket, "service_id": sid,
                    "steps": route.steps,
                    "initial_total": dict(report.initial_total),
                    "final_total": dict(report.final_total),
                    "wall_time_s": report.wall_time_s})
                self._journal_append_locked(SERVED, meta, arrays)
        finally:
            # the in-memory ledger resolves even if journaling failed
            self._route.pop(ticket, None)
            self._resolved[ticket] = outcome
            if self.tiering is not None:
                # analysis: ignore[blocking-under-lock] — reclaiming a
                # resolved ticket's chain (a few small files) must be atomic
                # with its resolution, or a racing wake could resurrect a
                # served scenario; the vault lock is a leaf
                # atomic with the resolution, or a racing wake could bring
                # a served scenario back; the vault lock is a leaf
                self.tiering.release(ticket)
            if not isinstance(outcome, Exception):
                self.counter.record_latency(
                    self._clock() - route.submitted_at)

    def _progress_sig(self, m: _Member) -> tuple:
        # completion-side progress only (dispatches finishing, scenarios
        # serving, lanes quarantined or recovered): queue churn and
        # supervised pump faults must not reset a wedged member's timer
        c = m.service.scheduler.counter
        return (c.dispatches, c.scenarios, c.quarantined,
                c.recovered_failures)

    def _health_check_locked(self, beat_t: Optional[float] = None
                             ) -> tuple[list, list]:
        """Mark failed members fenced; returns ``(to_fence,
        spawn_requests)`` for the tick's later phases. From here on the
        marked member takes no routing and no harvest. A wire member's
        heartbeat age is read at ``beat_t``, the end of the tick's
        heartbeat phase."""
        to_fence: list = []
        spawn_reqs: list = []
        now = self._clock()
        for m in list(self._members.values()):
            if m.fenced:
                continue
            # due-ness is part of the signature: work becoming due resets
            # the wedge timer, and a member waiting out its batching policy
            # is never wedged
            due = m.service.has_work_due()
            sig = self._progress_sig(m) + (due,)
            if sig != m.progress_sig:
                m.progress_sig = sig
                m.progress_t = now
            pending = m.service.scheduler.pending_count()
            reason = None
            if m.dead:
                reason = "pump thread died"
            elif (self._transport != "inproc" and not self._stop_flag
                  and not m.service.is_alive(beat_t)):
                reason = ("missed heartbeats: last good beat "
                          f"{m.service.heartbeat_age(beat_t):.3f}s ago "
                          "(heartbeat deadline "
                          f"{self._heartbeat_deadline}s)")
            elif (self._transport == "inproc" and self._threaded
                  and not self._stop_flag and not m.service.is_alive()):
                reason = "pump thread died"
            elif (pending > 0 and due
                  and now - m.progress_t > self._supervision_deadline):
                reason = (f"wedged: no progress for "
                          f"{now - m.progress_t:.3f}s with {pending} "
                          "pending (supervision deadline "
                          f"{self._supervision_deadline}s)")
            if reason is not None:
                req = self._fence_locked(m, reason)
                to_fence.append((m, reason))
                if req is not None:
                    spawn_reqs.append(req)
                continue
            if (self._fence_on_ladder_bottom and not m.retiring
                    and m.service.scheduler.degraded_from is not None
                    and m.service.scheduler.DEGRADE_TO.get(
                        m.service.scheduler.executor.impl) is None):
                # the pump is alive: drain out, never double-dispatch
                spawn_reqs.append(self._fence_live_locked(
                    m, "degradation ladder bottomed out (from "
                    f"{m.service.scheduler.degraded_from!r} to "
                    f"{m.service.scheduler.executor.impl!r})"))
        return to_fence, spawn_reqs

    #: the member-counter fields stats() aggregates, absorbed from a member
    #: when it is fenced or retired
    _ABSORB_KEYS = ("dispatches", "scenarios", "lanes", "cache_hits",
                    "solo_retries", "recovered_failures", "quarantined",
                    "impl_faults", "expired", "loop_faults", "busy_s",
                    "inflight_s")

    def _absorb_counters_locked(self, m: _Member) -> None:
        c = m.service.scheduler.counter
        for k in self._ABSORB_KEYS:
            self._absorbed[k] = self._absorbed.get(k, 0) + getattr(c, k)
        for k in ("wire_bytes_in", "wire_bytes_out"):
            v = getattr(m.service, k, None)
            if v is not None:
                self._absorbed[k] = self._absorbed.get(k, 0) + int(v)

    def _member_event_locked(self, m: _Member, reason: str) -> None:
        from ..resilience import FailureEvent

        self.member_log.append(FailureEvent(
            step=0, kind="member", detail=reason, rolled_back_to=0,
            attempt=m.gen + 1, wall_time_s=0.0,
            classification="transient", service_id=m.service_id))
        self.counter.bump("member_faults")
        # recorded here, under the lock; the ring dump happens in tick()'s
        # unlocked phase
        get_recorder().record("fence", service_id=m.service_id,
                              reason=reason)

    def _fence_locked(self, m: _Member, reason: str
                      ) -> Optional[tuple]:
        """Fence a member whose pump can no longer progress: mark it, log
        the member FailureEvent, and return the replacement request
        ``(slot, gen + 1)`` the tick fulfils outside the lock."""
        m.fenced = True
        self._member_event_locked(m, reason)
        warnings.warn(
            f"fleet member {m.service_id} fenced ({reason}); "
            f"restarting fresh as m{m.slot}g{m.gen + 1}",
            RuntimeWarning)
        if m.retiring:
            return None
        return (m.slot, m.gen + 1)

    def _complete_fence_locked(self, m: _Member, reason: str) -> None:
        """Move every ticket the fenced member held (harvest what resolved,
        migrate what is queued, re-admit what was claimed or launched from
        the fleet's copy) and abandon its pump."""
        self._drain_member_locked(m, reason)
        self._absorb_counters_locked(m)
        m.service.abandon()
        if m.slot in self._members and self._members[m.slot] is m:
            del self._members[m.slot]

    def _fence_live_locked(self, m: _Member, reason: str) -> tuple:
        """A member whose pump still works but whose engine is no longer
        trusted (the ladder's bottom) drains out: no intake, a fresh
        replacement in a new slot, queued tickets migrated, in-flight
        batches finishing here."""
        m.retiring = True
        m.retire_kind = "fence"
        self._member_event_locked(m, reason)
        warnings.warn(
            f"fleet member {m.service_id} draining out ({reason}); "
            "replacement starts fresh on the configured impl",
            RuntimeWarning)
        self._migrate_queued_locked(m, reason)
        return (next(self._slot_ids), 0)

    def _drain_member_locked(self, m: _Member, reason: str) -> None:
        for ticket, route in list(self._route.items()):
            if route.member is not m:
                continue
            try:
                # analysis: ignore[blocking-under-lock] — member poll runs
                # pump=False (results-table check only)
                r = m.service.poll(route.member_ticket)
            except WireError:
                # the fenced member's wire is gone: re-admit from the
                # fleet's copy
                self.counter.bump("wire_errors")
                self._readmit_locked(ticket, route, reason)
                continue
            # analysis: ignore[broad-except] — harvest seam (see poll)
            # the harvest seam (see poll)
            except Exception as e:
                self._finalize_locked(ticket, e)
                continue
            if r is not None:
                self._finalize_locked(ticket, r)
                continue
            moved = False
            skey = structure_key(route.model, route.space) + (route.steps,)
            order = self._candidates_locked(skey)
            if order:
                target = order[0]
                try:
                    # analysis: ignore[blocking-under-lock] — fencing drain
                    # must stay atomic with the route table (a concurrent
                    # submit must not route onto the fenced member mid-move);
                    # migration is rare (fence only)
                    new_mt = m.service.scheduler.migrate_ticket(
                        route.member_ticket, target.service.scheduler)
                except (TicketNotMigratable, KeyError):
                    pass  # claimed or launched: re-admit from the copy
                except WireError:
                    self.counter.bump("wire_errors")
                # analysis: ignore[broad-except] — fence-drain isolation: a
                # wire-crossed migrate can surface any member-side error;
                # unwinding would strand the fenced member's other tickets, and
                # the fleet's copy re-admits this one
                # fence-drain isolation: a wire-crossed migrate can raise
                # any member-side error; the fleet's copy re-admits
                except Exception:
                    self.counter.bump("loop_faults")
                else:
                    route.member, route.member_ticket = target, new_mt
                    moved = True
                    self._journal_append_locked(MIGRATE, {
                        "ticket": ticket, "from": m.service_id,
                        "to": target.service_id, "reason": reason})
            if not moved:
                self._readmit_locked(ticket, route, reason)

    def _readmit_locked(self, ticket: int, route: _Route,
                        reason: str) -> None:
        """Re-admit a ticket whose member can no longer serve it, from the
        fleet's copy, past the admission bound; with no healthy member it
        resolves as a counted :class:`MemberFailure`."""
        old_sid = (route.member.service_id if route.member is not None
                   else "recovery")
        skey = structure_key(route.model, route.space) + (route.steps,)
        for target in self._candidates_locked(skey):
            try:
                with get_tracer().attach(route.trace):
                    # analysis: ignore[blocking-under-lock] — re-admission
                    # must be atomic with the route table, and members run
                    # inline_dispatch=False: the scheduler's inline-dispatch
                    # tail the auditor sees is unreachable
                    new_mt = target.service.scheduler.submit(
                        route.space, route.model, route.steps)
            except WireError:
                # a rescue target whose wire is dead: mark it and try the
                # next candidate
                self.counter.bump("wire_errors")
                target.dead = True
                continue
            route.member, route.member_ticket = target, new_mt
            self.counter.bump("readmitted")
            self._journal_append_locked(READMIT, {
                "ticket": ticket, "from": old_sid,
                "to": target.service_id, "reason": reason})
            return
        self._finalize_locked(ticket, MemberFailure(
            f"member {old_sid} failed ({reason}) and no healthy "
            f"member remains to re-admit ticket {ticket}", old_sid))

    def _advance_retirements_locked(self) -> list[_Member]:
        """Advance every drain-before-retire: migrate queued tickets off,
        and remove a retiree that holds nothing (absorbing its counters).
        Returns the removed members, which ``tick`` stops outside the
        lock."""
        retired: list[_Member] = []
        for m in list(self._members.values()):
            if not m.retiring or m.fenced or m.dead:
                continue
            self._migrate_queued_locked(m, "retiring")
            if m.service.scheduler.pending_count() > 0:
                continue
            held = [t for t, r in self._route.items() if r.member is m]
            if held:  # pragma: no cover - defensive (harvest precedes)
                continue
            del self._members[m.slot]
            self._absorb_counters_locked(m)
            retired.append(m)
            if m.retire_kind == "scale":
                self.counter.bump("scale_downs")
        return retired

    def _migrate_queued_locked(self, m: _Member, reason: str) -> None:
        """Move every still-queued ticket off ``m``; claimed or launched
        tickets resolve in place (retire) or are re-admitted (fence)."""
        try:
            queued = m.service.scheduler.queued_tickets()
        except WireError:
            self.counter.bump("wire_errors")
            m.dead = True
            return
        for mt in queued:
            ticket = next((t for t, r in self._route.items()
                           if r.member is m and r.member_ticket == mt),
                          None)
            if ticket is None:  # pragma: no cover - defensive
                continue
            route = self._route[ticket]
            skey = structure_key(route.model, route.space) + (route.steps,)
            order = self._candidates_locked(skey)
            if not order:
                return  # nowhere to drain to; the next tick tries again
            try:
                # analysis: ignore[blocking-under-lock] — the drain-before-
                # retire move must stay atomic with the route table; retirement
                # is rare and the CRC-verified handoff is the point
                new_mt = m.service.scheduler.migrate_ticket(
                    mt, order[0].service.scheduler)
            except (TicketNotMigratable, KeyError):
                continue
            except WireError:
                # either side's wire died mid-move: the fleet's copy is the
                # one certain source
                self.counter.bump("wire_errors")
                self._readmit_locked(ticket, route, reason)
                continue
            # analysis: ignore[broad-except] — same mid-move shape for any
            # other wire-crossed member error: the extract may have landed, so
            # the route must not keep pointing at the source; re-admit from the
            # stored copy
            # any other member-side error mid-move: the extract may have
            # landed, so re-admit from the copy
            except Exception:
                self.counter.bump("loop_faults")
                self._readmit_locked(ticket, route, reason)
                continue
            route.member, route.member_ticket = order[0], new_mt
            self._journal_append_locked(MIGRATE, {
                "ticket": ticket, "from": m.service_id,
                "to": order[0].service_id, "reason": reason})

    # -- scenario tiering ----------------------------------------------------

    def _wake_due(self) -> int:
        """Wake hibernated fleet tickets FIFO into freed capacity: the chain
        restore outside the fleet lock, the placement (affinity routing and
        the member's submit) atomic with the route table. A wake every
        member refuses goes back to the head of the queue, its chain
        untouched. A hibernated ticket past the members' deadline resolves
        as ``TicketExpired``. Returns the wakes and resolutions made."""
        if self.tiering is None:
            return 0
        did = 0
        while True:
            nxt = self.tiering.peek_next()
            if nxt is None:
                return did
            ticket, nbytes = nxt
            with self._cv:
                meta = self._hib_meta.get(ticket)
                if meta is None:
                    # analysis: ignore[blocking-under-lock] — the reclaim (a
                    # few small files and one journal line) must be atomic with
                    # the bookkeeping check, or a racing wake could resurrect
                    # the orphan; the vault lock is a leaf
                    # a vault entry nothing routes to (recovery found a
                    # chain whose fleet ticket already resolved): reclaim
                    # it, atomic with the check
                    self.tiering.drop(ticket)
                    continue
                model, steps, skey, submitted_at, trace = meta
                live = [m for m in self._members.values()
                        if not m.fenced and not m.dead and not m.retiring]
                room = (any(m.service.scheduler.pending_count()
                            < self._max_queue for m in live)
                        and self.tiering.fits(nbytes))
                idle = not self._route and bool(live)
                if not (room or idle):
                    return did
                ddl = self._member_kwargs.get("deadline_s")
                if ddl is not None and self._clock() - submitted_at > ddl:
                    age = self._clock() - submitted_at
                    self._resolve_hibernated_locked(ticket, TicketExpired(
                        f"fleet ticket {ticket} expired after {age:.3f}s "
                        f"in the hibernation tier (deadline {ddl}s) — "
                        "never dispatched"), steps)
                    did += 1
                    continue
            try:
                # the wake span parents under the ticket's submit span
                with get_tracer().attach(trace):
                    space, entry = self.tiering.wake(
                        ticket, fallback=self._journal_state_fallback)
            except HibernationError as e:
                with self._cv:
                    self._resolve_hibernated_locked(ticket, e, steps)
                get_recorder().dump("hibernation", ticket=ticket)
                did += 1
                continue
            placed = self._place_woken(ticket, space, model, steps, skey,
                                       submitted_at, nbytes, bypass=False,
                                       trace=trace)
            del space
            if not placed:
                # every member refused mid-wake: back to the head; a later
                # tick retries once capacity really freed
                self.tiering.requeue(ticket, entry)
                return did
            did += 1

    def _place_woken(self, ticket: int, space, model, steps: int, skey,
                     submitted_at, nbytes: int, bypass: bool,
                     trace=None) -> bool:
        """Route one woken scenario onto a live member and install its
        route, atomic with the route table. ``bypass=True`` submits at the
        scheduler (the stop drain: an admitted ticket is never shed by its
        own drain)."""
        with self._cv:
            if skey is None:
                skey = structure_key(model, space) + (steps,)
            for mem in self._candidates_locked(skey):
                try:
                    with get_tracer().attach(trace):
                        if bypass:
                            # analysis: ignore[blocking-under-lock] — the re-
                            # admission contract of _readmit_locked: placement
                            # must be atomic with the route table; members run
                            # inline_dispatch=False
                            mt = mem.service.scheduler.submit(
                                space, model, steps)
                        else:
                            # analysis: ignore[blocking-under-lock] — same co
                            # ntract as submit()'s admission routing
                            mt = mem.service.submit(space, model=model,
                                                    steps=steps)
                except ServiceOverloaded:
                    continue
                except WireError:
                    self.counter.bump("wire_errors")
                    mem.dead = True
                    continue
                self._route[ticket] = _Route(
                    member=mem, member_ticket=mt, space=space, model=model,
                    steps=steps, submitted_at=submitted_at, trace=trace)
                self._hib_meta.pop(ticket, None)
                self.tiering.admit(ticket, nbytes)
                sid = mem.service_id
                self._wakes_by_member[sid] = \
                    self._wakes_by_member.get(sid, 0) + 1
                self._journal_append_locked(WAKE, {"ticket": ticket,
                                                   "to": sid})
                self._cv.notify_all()
                return True
            return False

    def _resolve_hibernated_locked(self, ticket: int, err: Exception,
                                   steps: int) -> None:
        """The terminal outcome of a ticket still in the hibernation tier
        (an expiry, an unwakeable chain, no member left at the drain):
        journaled, counted and published like any other."""
        from ..resilience import FailureEvent

        expired = isinstance(err, TicketExpired)
        err.ticket = ticket
        err.failure_event = FailureEvent(
            step=steps, kind="expired" if expired else "hibernation",
            detail=str(err), rolled_back_to=0, attempt=1, wall_time_s=0.0,
            classification="deterministic", ticket=ticket,
            service_id="hibernated")
        self._journal_append_locked(EXPIRED if expired else QUARANTINED, {
            "ticket": ticket, "service_id": "hibernated", "steps": steps,
            "error": type(err).__name__, "detail": str(err)})
        self._hib_meta.pop(ticket, None)
        self._resolved[ticket] = err
        self.counter.bump("expired" if expired else "quarantined")
        # analysis: ignore[blocking-under-lock] — reclaiming the resolved
        # ticket's chain must be atomic with its resolution (a racing wake
        # could resurrect it); the vault lock is a leaf and the reclaim is a
        # few small files and one journal line
        # the chain's reclaim is atomic with the resolution (a racing wake
        # could bring it back); the vault lock is a leaf
        self.tiering.drop(ticket)
        self._cv.notify_all()

    def _journal_state_fallback(self, ticket: int):
        """The wake's last resort (the ``wake_corrupt`` ladder's middle
        rung): the ticket's state from the fleet journal's CRC-checked
        submit record, on the fleet's device; None without a journal (the
        wake then raises ``HibernationError``). The replay is cached on the
        file's stat signature, so a burst of fallbacks reads the journal
        once."""
        if self.journal is None:
            return None
        try:
            st = os.stat(self.journal.path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:  # pragma: no cover - defensive
            return None
        cached = self._journal_fallback_cache
        if cached is not None and cached[0] == sig:
            state = cached[1]
        else:
            try:
                state = replay(self.journal.path)
            except (OSError, ValueError):  # pragma: no cover - defensive
                return None
            # analysis: ignore[unguarded-shared-mutation] — single writer by
            # construction: fallbacks only run inside tiering.wake, which
            # serializes under the vault lock (taking the fleet lock here would
            # invert the documented _cv -> vault order)
            # one writer: fallbacks run only inside tiering.wake, under the
            # vault lock (taking the fleet lock here would invert the
            # _cv → vault order)
            self._journal_fallback_cache = (sig, state)
        rec = state.submits.get(ticket)
        if rec is None or rec.arrays is None:
            return None
        warnings.warn(
            f"waking ticket {ticket} from the fleet journal's submit record "
            "(its hibernation chain did not verify)", RuntimeWarning)
        return space_from_record(rec, device=self.device)

    def _drain_hibernated(self) -> None:
        """``stop``'s paging drain: every hibernated ticket wakes onto a
        live member (a scheduler-level submit) before the members drain;
        with no live member left it resolves as a counted
        ``MemberFailure``."""
        if self.tiering is None:
            return
        while True:
            nxt = self.tiering.peek_next()
            if nxt is None:
                return
            ticket, nbytes = nxt
            with self._cv:
                meta = self._hib_meta.get(ticket)
                if meta is None:
                    # analysis: ignore[blocking-under-lock] — orphan reclaim
                    # atomic with the bookkeeping check (see _wake_due); the
                    # vault lock is a leaf
                    self.tiering.drop(ticket)
                    continue
            model, steps, skey, submitted_at, trace = meta
            try:
                with get_tracer().attach(trace):
                    space, _entry = self.tiering.wake(
                        ticket, fallback=self._journal_state_fallback)
            except HibernationError as e:
                with self._cv:
                    self._resolve_hibernated_locked(ticket, e, steps)
                get_recorder().dump("hibernation", ticket=ticket)
                continue
            if not self._place_woken(ticket, space, model, steps, skey,
                                     submitted_at, nbytes, bypass=True,
                                     trace=trace):
                with self._cv:
                    self._resolve_hibernated_locked(
                        ticket, MemberFailure(
                            "no healthy member remains to wake hibernated "
                            f"ticket {ticket} at stop", "hibernated"), steps)

    def _journal_submit_hibernated_locked(self, ticket: int, space, model,
                                          steps: int, trace=None) -> None:
        """The submit record of a ticket that hibernates on arrival (it
        precedes any terminal of the ticket, and is the wake's last-resort
        state source)."""
        if self.journal is None:
            return
        meta, arrays = space_payload(space)
        meta.update({
            "ticket": ticket, "service_id": "hibernated", "steps": steps,
            "model": model_meta(model)})
        if trace is not None:
            meta["trace"] = trace.to_meta()
        self._journal_append_locked(SUBMIT, meta, arrays)

    # -- autoscaling ---------------------------------------------------------

    def _autoscale_locked(self) -> Optional[tuple]:
        """Evaluate the policy; a scale-up returns the spawn request
        ``(slot, 0)`` for the tick to fulfil outside the lock."""
        p = self._policy
        live = [m for m in self._members.values()
                if not m.fenced and not m.dead and not m.retiring]
        n = len(live)
        if n == 0:
            return None
        depth = sum(m.service.scheduler.pending_count() for m in live)
        depth_frac = depth / (n * self._max_queue)
        shed_total = self.counter.shed
        shed_delta = shed_total - self._last_shed
        self._last_shed = shed_total
        p99 = self.counter.snapshot()["latency_p99_s"]
        gated_backlog = any(
            m.service.scheduler.intake_gated
            and m.service.scheduler.pending_count() > 0 for m in live)
        overload = (shed_delta > 0 or depth_frac >= p.depth_high
                    or gated_backlog
                    or (p.latency_p99_target_s is not None
                        and p99 is not None
                        and p99 > p.latency_p99_target_s))
        underload = (not overload and shed_delta == 0
                     and depth_frac <= p.depth_low)
        if self._cooldown > 0:
            self._cooldown -= 1
            self._up_ticks = self._down_ticks = 0
            return None
        if overload:
            self._up_ticks += 1
            self._down_ticks = 0
        elif underload:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = self._down_ticks = 0
        if self._up_ticks >= p.scale_up_after and n < p.max_services:
            self.counter.bump("scale_ups")
            self._cooldown = p.cooldown_ticks
            self._up_ticks = self._down_ticks = 0
            return (next(self._slot_ids), 0)
        if self._down_ticks >= p.scale_down_after and n > p.min_services:
            # drain-before-retire: the least-loaded member stops taking
            # intake; _advance_retirements_locked migrates and removes it
            victim = min(live, key=lambda m: (
                m.service.scheduler.pending_count(), -m.slot))
            victim.retiring = True
            self._cooldown = p.cooldown_ticks
            self._up_ticks = self._down_ticks = 0
        return None

    # -- journal / recovery --------------------------------------------------

    def _journal_submit_locked(self, ticket: int, route: _Route) -> None:
        if self.journal is None:
            return
        meta, arrays = space_payload(route.space)
        meta.update({
            "ticket": ticket, "service_id": route.member.service_id,
            "steps": route.steps, "model": model_meta(route.model)})
        if route.trace is not None:
            # the trace id rides the submit record: obs.timeline joins
            # exported spans through it
            meta["trace"] = route.trace.to_meta()
        self._journal_append_locked(SUBMIT, meta, arrays)

    @classmethod
    def recover(cls, journal_dir: str, model, **kwargs
                ) -> "FleetSupervisor":
        """Crash-restart recovery: replay the journal's verified prefix
        and build a fleet in which every journaled ticket is accounted for.
        Terminal tickets resolve from the journal (a served one with its
        state, not run again; quarantines and expiries as their errors);
        unresolved ones are re-admitted under their original ids from the
        journaled state, placed on the fleet's ``device``; with tiering, the
        tickets hibernated at the crash re-enter the hibernation tier from
        their chains instead (an in-flight hibernation resolves at its wake:
        the verified prefix, the journal's submit record, or a loud
        ``HibernationError``). A journal whose recovery ran to completion
        re-admits nothing."""
        from ..models.model import Report

        state = replay(journal_path(journal_dir))
        fleet = cls(model, journal_dir=journal_dir, **kwargs)
        with fleet._cv:
            fleet._ids = itertools.count(state.max_ticket() + 1)
            hib = (fleet.tiering.recover(model)
                   if fleet.tiering is not None else {})
            for t, rec in state.terminal.items():
                if rec.kind == SERVED:
                    if rec.arrays is None:
                        err: Exception = MemberFailure(
                            f"ticket {t} was served before the restart "
                            "but its result state was not journaled "
                            "(journal_results=False)", "recovery")
                        err.ticket = t
                        fleet._resolved[t] = err
                        continue
                    sp = space_from_record(rec, device=fleet.device)
                    rep = Report(
                        comm_size=1, rank_id=0,
                        steps=rec.meta.get("steps", 0),
                        initial_total=rec.meta.get("initial_total", {}),
                        final_total=rec.meta.get("final_total", {}),
                        last_execute=[],
                        wall_time_s=rec.meta.get("wall_time_s", 0.0),
                        backend_report={
                            "recovered_from_journal": True,
                            "service_id": rec.meta.get("service_id")})
                    fleet._resolved[t] = (sp, rep)
                elif rec.kind == EXPIRED:
                    err = TicketExpired(
                        rec.meta.get("detail",
                                     f"ticket {t} expired before restart"))
                    err.ticket = t
                    fleet._resolved[t] = err
                else:
                    err = RuntimeError(
                        f"ticket {t} quarantined before restart: "
                        f"{rec.meta.get('detail', '')}")
                    err.ticket = t
                    fleet._resolved[t] = err
            for t in [t for t in hib if t in state.terminal]:
                # terminal wins: the vault entry of a ticket the journal
                # resolved is a leftover
                fleet.tiering.drop(t)
                hib.pop(t)
            for t in state.unresolved():
                rec = state.submits[t]
                # the journaled trace context survives the crash: the
                # post-restart spans keep the ticket's trace id
                trace = TraceContext.from_meta(rec.meta.get("trace"))
                if t in hib:
                    e = hib[t]
                    fleet._hib_meta[t] = (
                        e.model, e.steps or rec.meta.get(
                            "steps", fleet.default_steps),
                        None, fleet._clock(), trace)
                    continue
                sp = space_from_record(rec, device=fleet.device)
                mm = rec.meta.get("model")
                if mm is None:
                    warnings.warn(
                        f"journal submit for ticket {t} carried no "
                        "model recipe; re-admitting with the fleet "
                        "template model", RuntimeWarning)
                m_model = model_from_meta(mm, model)
                route = _Route(
                    member=None, member_ticket=-1, space=sp,
                    model=m_model, steps=rec.meta.get("steps",
                                                      fleet.default_steps),
                    submitted_at=fleet._clock(), trace=trace)
                fleet._route[t] = route
                fleet._readmit_locked(t, route, "crash-restart recovery")
        return fleet

    # -- observability -------------------------------------------------------

    def dispatch_logs(self) -> list:
        """Recent dispatch-log entries across the current members (a
        debugging window, not a ledger), gathered outside the fleet lock: a
        wire member's log is an RPC."""
        with self._cv:
            members = [m for m in self._members.values()
                       if not m.dead and not m.fenced]
        out = []
        for m in members:
            try:
                out.extend(dict(e)
                           for e in m.service.scheduler.dispatch_log)
            except WireError:  # pragma: no cover - debugging window
                self.counter.bump("wire_errors")
        return out

    def stats(self) -> dict:
        """One fleet-level cut: member counters aggregated (fenced and
        retired members' absorbed), fleet-observed latency, the supervision
        and wire ledgers, and a per-member ``services`` breakdown by
        ``service_id``, with the JAX package's keys."""
        with self._cv:
            members = list(self._members.values())
            snap = self.counter.snapshot()
            agg = {k: 0 for k in (
                "dispatches", "scenarios", "lanes", "cache_hits",
                "solo_retries", "recovered_failures", "quarantined",
                "impl_faults", "expired", "loop_faults")}
            per = []
            degraded_from = None
            gated = False
            agg["loop_faults"] += snap["loop_faults"]
            busy = float(self._absorbed.get("busy_s", 0.0))
            inflight = float(self._absorbed.get("inflight_s", 0.0))
            wire_in = int(self._absorbed.get("wire_bytes_in", 0))
            wire_out = int(self._absorbed.get("wire_bytes_out", 0))
            for k in agg:
                agg[k] += self._absorbed.get(k, 0)
            for m in members:
                wire_in += int(getattr(m.service, "wire_bytes_in",
                                       0) or 0)
                wire_out += int(getattr(m.service, "wire_bytes_out",
                                        0) or 0)
                c = m.service.scheduler.counter
                for k in agg:
                    agg[k] += getattr(c, k)
                busy += c.busy_s
                inflight += c.inflight_s
                if degraded_from is None:
                    degraded_from = m.service.scheduler.degraded_from
                gated = gated or m.service.scheduler.intake_gated
                per.append({
                    "service_id": m.service_id, "slot": m.slot,
                    "gen": m.gen, "fenced": m.fenced,
                    "retiring": m.retiring, "dead": m.dead,
                    **m.service.stats()})
            return {
                **agg,
                "busy_s": busy,
                "inflight_s": inflight,
                "scenarios_per_s": (agg["scenarios"] / busy
                                    if busy > 0 else None),
                "batch_occupancy": (agg["scenarios"] / agg["lanes"]
                                    if agg["lanes"] else None),
                "compile_cache_hits": agg["cache_hits"],
                "compile_cache_hit_rate": (
                    agg["cache_hits"] / agg["dispatches"]
                    if agg["dispatches"] else None),
                "shed": snap["shed"],
                "latency_n": snap["latency_n"],
                "latency_p50_s": snap["latency_p50_s"],
                "latency_p99_s": snap["latency_p99_s"],
                "member_faults": snap["member_faults"],
                "readmitted": snap["readmitted"],
                "scale_ups": snap["scale_ups"],
                "scale_downs": snap["scale_downs"],
                "member_transport": self._transport,
                "supervisor_id": self._supervisor_id,
                "epoch": (self.journal.epoch
                          if self.journal is not None else None),
                "supervisor_kills": snap["supervisor_kills"],
                "stale_epoch_rejections": snap["stale_epoch_rejections"],
                "respawns": snap["respawns"],
                "heartbeats": snap["heartbeats"],
                "heartbeat_misses": snap["heartbeat_misses"],
                "wire_errors": snap["wire_errors"],
                "wire_bytes_in": wire_in,
                "wire_bytes_out": wire_out,
                # a hibernated ticket is outstanding work too
                "pending": len(self._route) + len(self._hib_meta),
                "degraded_from": degraded_from,
                "intake_gated": gated,
                "fleet": True,
                "members": len(members),
                "journal": (self.journal.path
                            if self.journal is not None else None),
                # the paging tier's gauges and counters, and the wakes per
                # member id
                **({"hibernations": snap["hibernations"],
                    "rehibernations": snap["rehibernations"],
                    "wakes": snap["wakes"],
                    "wake_faults": snap["wake_faults"],
                    "wake_latency_n": snap["wake_latency_n"],
                    "wake_latency_p50_s": snap["wake_latency_p50_s"],
                    "wake_latency_p99_s": snap["wake_latency_p99_s"],
                    "wakes_by_member": dict(self._wakes_by_member),
                    **self.tiering.stats()}
                   if self.tiering is not None else {}),
                "services": per,
            }


class StandbySupervisor:
    """The failover watcher: it tails a fleet's journal directory (the
    lease and the TJ1 journal) without owning any member, and takes the
    fleet over when the active supervisor's lease goes stale.

    1. The active (named) supervisor re-stamps the lease every tick on the
       clock both share.
    2. ``should_takeover()``: the lease older than its ``lease_s`` (or no
       lease beside an existing journal) means the active stopped ticking.
    3. ``takeover()`` runs ``FleetSupervisor.recover`` under this standby's
       ``supervisor_id``: the new fleet declares epoch N+1 before any
       member spawns, re-admits every unresolved ticket once, and stamps
       its frames with the new epoch.
    4. A wedged old supervisor that wakes is fenced twice: its appends
       raise ``StaleEpochError`` and write nothing, and its member RPCs
       come back ``err``.

    ``lease_s=None`` honours the lease's own advertised bound."""

    def __init__(self, journal_dir: str, model, *,
                 supervisor_id: str,
                 lease_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 **fleet_kwargs):
        self.journal_dir = journal_dir
        self.model = model
        self.supervisor_id = supervisor_id
        self._lease_s = lease_s
        self._clock = clock
        self._fleet_kwargs = dict(fleet_kwargs)
        #: the fleet built by takeover(), None while standing by
        self.fleet: Optional[FleetSupervisor] = None

    def lease(self) -> Optional[dict]:
        return read_lease(lease_path(self.journal_dir))

    def lease_age(self) -> Optional[float]:
        """Seconds since the active's last renewal; None with no lease."""
        rec = self.lease()
        if rec is None or not isinstance(rec.get("t"), (int, float)):
            return None
        return self._clock() - rec["t"]

    def should_takeover(self) -> bool:
        if self.fleet is not None:
            return False
        age = self.lease_age()
        if age is None:
            # no lease: a journal without one is a pre-lease supervisor's
            # (or one that crashed before its first stamp), claimed; no
            # journal means nothing to supervise yet
            return os.path.exists(journal_path(self.journal_dir))
        rec = self.lease() or {}
        bound = self._lease_s
        if bound is None:
            bound = rec.get("lease_s") or 2.0
        return age > bound

    def takeover(self) -> FleetSupervisor:
        """Fence the stale active and become the supervisor: recover the
        fleet from the journal under this standby's id."""
        prev = self.lease() or {}
        self.fleet = FleetSupervisor.recover(
            self.journal_dir, self.model,
            supervisor_id=self.supervisor_id,
            takeover_from=prev.get("owner"),
            clock=self._clock,
            **({"lease_s": self._lease_s}
               if self._lease_s is not None else {}),
            **self._fleet_kwargs)
        return self.fleet

    def poll(self) -> Optional[FleetSupervisor]:
        """One standby beat: take over if the lease is stale; returns the
        new fleet on the beat that fired, else None."""
        if self.should_takeover():
            return self.takeover()
        return None
