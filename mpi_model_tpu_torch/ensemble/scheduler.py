"""Scenario queue with bucketed batching (counterpart of
``mpi_model_tpu/ensemble/scheduler.py``).

Submissions queue per structure group: ``batch.structure_key`` plus the step
count, which every lane of one dispatch shares. A group flushes when it
holds ``max_batch`` scenarios, when its oldest submission has waited
``max_wait_s`` (checked at every ``pump``/``poll``), or on
``pump(force=True)``; due groups flush oldest first. Each dispatch pads its
k real scenarios up to the smallest bucket >= k with zero scenarios
(``batch.padding_scenarios``), so the runner cache sees a handful of batch
shapes: at most ``len(buckets)`` runner builds per structure.

``clock`` is injectable (tests drive the max-wait, deadline and expiry
policies with a fake clock); wall times for the counters come from
``time.perf_counter``.

Self-healing: with ``retry="solo"`` a failed scenario is re-dispatched alone
once: a solo success means the batch was at fault and the scenario is
recovered; a solo failure quarantines it with a ``FailureEvent``.
``dispatch_deadline_s`` bounds a dispatch by the injectable clock (an
overrun is a ``DispatchTimeout``), ``ticket_deadline_s`` a queued ticket
(``TicketExpired`` with a ``FailureEvent``), ``retry_budget`` the total solo
retries.

The degradation ladder (the JAX package's): an impl-level fault (a whole
dispatch failing, a lane failure that a solo run clears, a solo whole-batch
failure) counts in ``impl_faults``, and every ``degrade_after`` of them the
executor steps one rung down ``DEGRADE_TO``: ``active_fused`` (K6/K7) →
``active`` → ``xla``, ``pipeline`` (K5) → ``xla``. A rung is announced (a
``RuntimeWarning`` "degraded to ..."), raises ``intake_gated`` until the
next dispatch completes clean (the async service sheds while it holds and
backlog is unproven), and every report a degraded engine serves carries
``impl`` and ``degraded_from`` in its ``backend_report``; ``stats()`` reads
both. A hand kernel's own build, load or launch failure
(``ops._build.KernelError``, the error or one in its cause chain) counts in
``impl_faults`` but steps no rung, unlike the JAX package's ladder, which
steps on any impl-level fault: it reaches its tickets as that error, and
the plain engine never runs in a failing kernel's place.

A dispatch is two halves: launch (assemble, pad, resolve the runner, queue
the work: ``launch_due`` → ``batch.launch_ensemble``) and finish (wait on
the flight's own event, conservation, results: ``finish_flight`` →
``batch.complete_ensemble``); the synchronous path runs them back to back,
the async service's pump thread launches batch i before it finishes batch
i-1. The dispatch deadline bills the launch and finish segments, never the
gap between them. Shared state is mutated only under the one ``_lock``;
device work runs outside it. ``inline_dispatch=False`` (the async service)
makes ``submit`` enqueue only: a submission on the card records an event
on the submitter's current stream, and the launch makes its own stream
wait on it before the batch reads the space.

``windows``/``donate`` advance each ``impl="xla"`` dispatch in that many
runner calls, the ``[B, H, W]`` state carried between them in the
dispatch's own buffers (``batch.launch_ensemble``); ``windows > 1`` with
another impl is refused, ``donate`` turns off without a word for the other
impls, as in the JAX package. The dispatch log's ``windows`` and
``donated_windows`` say what ran.

Chaos seams (``resilience.inject``): ticket-bound ``lane_nan`` poisons are
mapped to lanes for the launch, ``batch_exc`` fails a whole dispatch,
``slow_compile`` and ``hang`` stretch its clock duration.

Migration (``migrate_ticket``/``extract_ticket``) drains a queued scenario
onto another scheduler through the delta stream's CRC-checked transfer
(``io.delta.transfer_space``); ``migrated_out``/``migrated_in`` count it.

Observability: ``submit`` keeps the submitter's current ``TraceContext``
on the ticket, and a dispatch opens ``ensemble.assemble``,
``ensemble.launch`` and ``ensemble.fetch`` with ``parent=`` the first
ticket's context (every ticket's trace id in the span's ``trace_ids``), so
the spans chain to the submit whichever thread launches them. The flight
recorder (``obs.flight``) gets ``submit``, ``expired``, ``served``,
``failed`` and ``quarantined``, and a quarantine dumps it.

``mesh=`` (an ``EnsembleMesh``, a batch extent or a ``(batch, space)``
pair) places every dispatch over the mesh: the bucket is rounded up to a
multiple of the batch extent with inert zero scenarios (the solo retry's
too), occupancy is judged against the rounded bucket, and ``stats()["mesh"]``
gives ``{batch, space, devices}``. The JAX package's ``counter`` argument
is left out.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import warnings
from typing import Callable, Optional, Sequence

import torch

from ..core.cellular_space import CellularSpace
from ..obs.flight import get_recorder
from ..ops._build import KernelError
from ..resilience import FailureEvent, inject, lockdep
from ..utils.metrics import ThroughputCounter
from .mesh import resolve_ensemble_mesh
from ..utils.tracing import get_tracer
from .batch import (EnsembleExecutor, complete_ensemble, launch_ensemble,
                    padding_scenarios, structure_key)

#: default bucket ladder: pad k scenarios up to the smallest entry >= k
DEFAULT_BUCKETS = (1, 2, 4, 8)


class DispatchTimeout(RuntimeError):
    """A dispatch overran ``dispatch_deadline_s`` by the scheduler's
    (injectable) clock. Its results are discarded; the affected tickets are
    retried solo or failed, per the retry policy."""


class TicketNotMigratable(RuntimeError):
    """``migrate_ticket`` found the ticket pending but not queued: it is
    inside a claimed or launched dispatch (a normal state with the async
    pump running). Migrating it would risk a double dispatch, so the caller
    waits for its result instead."""


class TicketExpired(RuntimeError):
    """A queued ticket's ``ticket_deadline_s`` passed before it was
    dispatched: ``poll`` raises this with a complete ``FailureEvent``
    (kind="expired") attached, never a silent drop."""


def _kernel_failed(err: BaseException) -> bool:
    """Whether ``err``, or an error in its cause chain, is a hand kernel's
    build, load or launch failure."""
    seen = set()
    while err is not None and id(err) not in seen:
        if isinstance(err, KernelError):
            return True
        seen.add(id(err))
        err = err.__cause__ or err.__context__
    return False


def buckets_for(n: int) -> tuple[int, ...]:
    """Power-of-two bucket ladder covering batches up to ``n``."""
    out = [1]
    while out[-1] < n:
        out.append(out[-1] * 2)
    return tuple(out)


@dataclasses.dataclass
class _Pending:
    ticket: int
    space: CellularSpace
    model: object
    steps: int
    submitted_at: float
    #: recorded on the submitter's stream at submission (async path, on the
    #: card): the launch's stream waits on it before reading the space
    ready: Optional[object] = None
    #: the submitter's TraceContext: the dispatch spans parent under it
    trace: Optional[object] = None


@dataclasses.dataclass
class _Flight:
    """One launched dispatch the scheduler tracks until ``finish_flight``."""

    items: list
    bucket: int
    inflight: object
    cache_hit: bool
    c0: float
    #: injectable clock when the launch returned: the deadline bills the
    #: launch and fetch segments
    c_launched: float
    #: the dispatch seam's firing index (the ``hang`` fault's), when armed
    didx: Optional[int] = None
    #: injectable-clock seconds a ``slow_compile`` fault added
    extra_s: float = 0.0


class EnsembleScheduler:
    """Bucketed-batching scenario queue (module docstring has the policy).
    ``submit`` returns an integer ticket; ``poll(ticket)`` pumps due groups
    and returns ``(space, Report)`` when served, ``None`` while queued, and
    raises the lane's ``EnsembleConservationError`` (with ``.ticket``) when
    that scenario violated: a bad scenario never poisons its batchmates'
    results."""

    def __init__(self, *, impl: str = "xla", substeps: int = 1,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.0, max_batch: Optional[int] = None,
                 compute_dtype=None, check_conservation: bool = True,
                 tolerance: float = 1e-3, rtol: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry: str = "none",
                 dispatch_deadline_s: Optional[float] = None,
                 degrade_after: int = 2,
                 ticket_deadline_s: Optional[float] = None,
                 retry_budget: Optional[int] = None,
                 windows: int = 1, donate: bool = False,
                 inline_dispatch: bool = True,
                 service_id: Optional[str] = None,
                 mesh=None):
        if retry not in ("none", "solo"):
            raise ValueError(
                f"unknown retry policy {retry!r} (expected 'none' or "
                "'solo')")
        bl = tuple(sorted({int(b) for b in buckets}))
        if not bl or bl[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        if windows > 1 and impl != "xla":
            raise ValueError(
                f"windows={windows} requires impl='xla' (the active/"
                "pipeline runners carry stat lanes that do not window); "
                f"got impl={impl!r}")
        self.buckets = bl
        self.max_batch = bl[-1] if max_batch is None else int(max_batch)
        if not 1 <= self.max_batch <= bl[-1]:
            raise ValueError(
                f"max_batch={max_batch} outside [1, {bl[-1]}] (the "
                "largest bucket bounds a dispatch)")
        self.max_wait_s = float(max_wait_s)
        #: the (batch, space) device mesh every dispatch is placed over
        #: (None: one device). An EnsembleMesh, a batch extent or a
        #: (batch, space) pair, resolved against this process's cards
        self.mesh = resolve_ensemble_mesh(mesh)
        self.executor = EnsembleExecutor(impl=impl, substeps=substeps,
                                         compute_dtype=compute_dtype,
                                         mesh=self.mesh)
        self.check_conservation = check_conservation
        self.tolerance = tolerance
        self.rtol = rtol
        self.counter = ThroughputCounter()
        self._clock = clock
        self.retry = retry
        self.dispatch_deadline_s = dispatch_deadline_s
        self.ticket_deadline_s = ticket_deadline_s
        self.retry_budget = retry_budget
        #: runner calls per dispatch; with donate=True the [B, H, W] state
        #: moves between them copy-free (xla impl only)
        self.windows = max(1, int(windows))
        self.donate = bool(donate)
        #: False: the async pump thread owns all dispatching, and submit
        #: never runs device work on the caller's thread
        self.inline_dispatch = bool(inline_dispatch)
        #: the serving member's identity, stamped into stats(), served
        #: backend reports and FailureEvents (None: a standalone scheduler)
        self.service_id = service_id
        #: impl-level faults tolerated a ladder rung (DEGRADE_TO)
        self.degrade_after = int(degrade_after)
        #: the impl the ladder first degraded away from (None: never)
        self.degraded_from: Optional[str] = None
        #: True from a rung until the next clean completion: the async
        #: service sheds new load while it holds and backlog is unproven
        self.intake_gated = False
        self._impl_fault_count = 0
        #: one FailureEvent per quarantined scenario, in order
        self.quarantine_log: list = []
        #: one FailureEvent per expired ticket, in order
        self.expired_log: list = []
        #: THE lock over the queues, results, pending set, logs and ladder
        #: state; re-entrant for the synchronous submit → dispatch chain.
        #: Made through the lock-order witness (a plain RLock disarmed)
        self._lock = lockdep.rlock("EnsembleScheduler._lock")
        self._queues: collections.OrderedDict[tuple, list[_Pending]] = \
            collections.OrderedDict()
        self._results: dict[int, object] = {}
        self._pending_tickets: set[int] = set()
        self._ids = itertools.count()
        #: one record per dispatch ({bucket, count, occupancy, steps,
        #: tickets, cache_hit, wall_s}) and per migrated ticket
        #: ({migrated_ticket, to_ticket, steps}), the most recent 256
        self.dispatch_log: collections.deque = collections.deque(maxlen=256)
        #: queued tickets drained to another scheduler, and taken from one
        self.migrated_out = 0
        self.migrated_in = 0

    # -- submission / results ------------------------------------------------

    def submit(self, space: CellularSpace, model, steps: Optional[int] = None
               ) -> int:
        """Queue one scenario; returns its ticket. The group dispatches
        at once when it holds ``max_batch`` scenarios (unless
        ``inline_dispatch=False``: then the pump thread owns it)."""
        steps = model.num_steps if steps is None else int(steps)
        key = structure_key(model, space) + (steps,)
        ready = None
        if not self.inline_dispatch and space.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(space.device))
        trace = get_tracer().current()
        with self._lock:
            ticket = next(self._ids)
            self._queues.setdefault(key, []).append(
                _Pending(ticket, space, model, steps, self._clock(), ready,
                         trace))
            self._pending_tickets.add(ticket)
            full = len(self._queues[key]) >= self.max_batch
        get_recorder().record("submit", service_id=self.service_id,
                              ticket=ticket, steps=steps)
        if full and self.inline_dispatch:
            self._dispatch_group(key)
        return ticket

    def migrate_ticket(self, ticket: int,
                       target: "EnsembleScheduler") -> int:
        """Drain one QUEUED scenario off this scheduler and resubmit it on
        ``target``: its state crosses through the delta stream's wire
        format (``io.delta.transfer_space``, a keyframe whose every piece is
        CRC-checked), so the handoff is bit for bit and a corrupted
        transfer fails loudly. Other tickets keep batching on both sides,
        and the target may run another bucket ladder, impl or retry policy.
        Returns the ticket on ``target``; the old one is forgotten here.
        A ticket already dispatched or served cannot migrate."""
        if target is self:
            raise ValueError(
                "migrate_ticket needs a DIFFERENT target scheduler "
                "(migrating onto oneself is a no-op with extra steps)")
        space, model, steps = self.extract_ticket(ticket)
        new_ticket = target.submit(space, model, steps)
        with target._lock:
            target.migrated_in += 1
        with self._lock:
            self.dispatch_log.append({"migrated_ticket": ticket,
                                      "to_ticket": new_ticket,
                                      "steps": steps})
        return new_ticket

    def extract_ticket(self, ticket: int
                       ) -> tuple[CellularSpace, object, int]:
        """Verify, then drain one QUEUED scenario out of this scheduler:
        ``(space, model, steps)`` with the state already through the
        CRC-checked transfer (the first half of ``migrate_ticket``). Raises
        ``KeyError`` for unknown or served tickets and
        ``TicketNotMigratable`` for claimed or launched ones; on any failure
        the ticket stays queued here."""
        from ..io.delta import transfer_space

        with self._lock:
            if ticket in self._results:
                raise KeyError(
                    f"ticket {ticket} is already served — collect it with "
                    "poll() instead of migrating it")
            if ticket not in self._pending_tickets:
                raise KeyError(
                    f"unknown or already-collected ticket {ticket}")
            found = None
            for key, q in self._queues.items():
                for i, it in enumerate(q):
                    if it.ticket == ticket:
                        found = (key, q, i, it)
                        break
                if found:
                    break
            if found is None:
                raise TicketNotMigratable(
                    f"ticket {ticket} is inside a claimed/launched "
                    "dispatch — not migratable without risking a double "
                    "dispatch; collect its result")
            key, q, i, it = found
            if it.ready is not None:
                # analysis: ignore[blocking-under-lock] — the submitter's
                # stream wrote this scenario: the CRC-verified transfer below
                # must read its finished bytes while the ticket is still queued
                # under this lock
                it.ready.synchronize()  # the submitter's stream wrote it
            # analysis: ignore[blocking-under-lock] — the CRC-verified
            # materialization must complete while the ticket is still queued
            # under this lock, or a failed transfer could both lose the local
            # copy and never deliver the remote one
            # the transfer completes while the ticket is still queued, so a
            # failed one leaves the scenario here
            space = transfer_space(it.space)
            q.pop(i)
            if not q:
                del self._queues[key]
            self._pending_tickets.discard(ticket)
            self.migrated_out += 1
        return space, it.model, it.steps

    def allocate_ticket(self) -> int:
        """Reserve one ticket id without queuing a scenario (the JAX
        package's paging overlay hands these out; kept with its API)."""
        with self._lock:
            return next(self._ids)

    def queued_since(self, ticket: int) -> Optional[float]:
        """The injectable-clock time a queued ticket was submitted, or None
        when it is not queued."""
        with self._lock:
            for q in self._queues.values():
                for it in q:
                    if it.ticket == ticket:
                        return it.submitted_at
            return None

    def pending_count(self) -> int:
        """Tickets submitted and not yet resolved (queued or in a
        dispatch): the admission queue depth the async service bounds."""
        with self._lock:
            return len(self._pending_tickets)

    def due_backlog(self) -> bool:
        """True when some queued group is due (full, or its oldest
        submission waited past ``max_wait_s``): work a healthy pump would
        be making progress on now."""
        with self._lock:
            now = self._clock()
            for q in self._queues.values():
                if q and (len(q) >= self.max_batch
                          or (now - q[0].submitted_at) >= self.max_wait_s):
                    return True
            return False

    def queued_tickets(self) -> list[int]:
        """Tickets still in a queue (submitted, not yet claimed into a
        dispatch)."""
        with self._lock:
            return [it.ticket for q in self._queues.values() for it in q]

    def poll(self, ticket: int, pump: bool = True):
        """Result for ``ticket`` if served (due groups are pumped first):
        ``(space, Report)``; ``None`` while queued; raises the scenario's
        ``EnsembleConservationError`` on violation, the dispatch's error
        when its whole batch failed, or ``TicketExpired``; ``KeyError`` for
        unknown or already-collected tickets. ``pump=False`` only checks."""
        if pump:
            self.pump()
        else:
            self.expire_due()
        with self._lock:
            if ticket in self._results:
                res = self._results.pop(ticket)
            elif ticket in self._pending_tickets:
                return None
            else:
                raise KeyError(
                    f"unknown or already-collected ticket {ticket}")
        if isinstance(res, Exception):
            raise res
        return res

    # -- deadlines -----------------------------------------------------------

    def expire_due(self) -> int:
        """Resolve every queued ticket whose ``ticket_deadline_s`` passed as
        ``TicketExpired`` with a complete ``FailureEvent``; returns how
        many expired."""
        if self.ticket_deadline_s is None:
            return 0
        expired: list[tuple[_Pending, float]] = []
        with self._lock:
            now = self._clock()
            for key in list(self._queues):
                keep = []
                for it in self._queues[key]:
                    age = now - it.submitted_at
                    if age > self.ticket_deadline_s:
                        expired.append((it, age))
                    else:
                        keep.append(it)
                if keep:
                    self._queues[key] = keep
                else:
                    del self._queues[key]
            for it, age in expired:
                err = TicketExpired(
                    f"ticket {it.ticket} expired after {age:.3f}s queued "
                    f"(deadline {self.ticket_deadline_s}s) — never "
                    "dispatched")
                ev = FailureEvent(
                    step=it.steps, kind="expired", detail=str(err),
                    rolled_back_to=0, attempt=1, wall_time_s=0.0,
                    classification="deterministic", ticket=it.ticket,
                    service_id=self.service_id)
                err.ticket = it.ticket
                err.failure_event = ev
                self.expired_log.append(ev)
                self.dispatch_log.append({"expired_ticket": it.ticket,
                                          "steps": it.steps,
                                          "queued_s": age})
                self._results[it.ticket] = err
                self._pending_tickets.discard(it.ticket)
                self.counter.bump("expired")
                # recorded only: a dump may touch the filesystem, and this
                # runs under the lock
                get_recorder().record("expired", service_id=self.service_id,
                                      ticket=it.ticket, queued_s=age)
        return len(expired)

    # -- flush policy --------------------------------------------------------

    def _claim_due_batch(self, force: bool = False):
        """Pop the next due batch (oldest head of queue first) under the
        lock, after expiring overdue tickets; None when nothing is due."""
        self.expire_due()
        with self._lock:
            now = self._clock()
            due = []
            for key, q in self._queues.items():
                if q and (force or len(q) >= self.max_batch
                          or (now - q[0].submitted_at) >= self.max_wait_s):
                    due.append((q[0].submitted_at, q[0].ticket, key))
            if not due:
                return None
            return self._pop_batch_locked(min(due)[2])

    def _pop_batch_locked(self, key: tuple):
        q = self._queues.get(key)
        if not q:
            return None
        k = min(len(q), self.buckets[-1])
        items, rest = q[:k], q[k:]
        if rest:
            self._queues[key] = rest
        else:
            del self._queues[key]
        bucket = next(b for b in self.buckets if b >= k)
        if self.mesh is not None:
            # pad-to-(bucket × mesh): the dispatch tiles the mesh's batch
            # extent. Occupancy is judged against THIS bucket, so the mesh's
            # padding shows as waste instead of hiding in the bucket
            bucket = self.mesh.round_up(bucket)
        return items, bucket

    def pump(self, force: bool = False) -> int:
        """Dispatch every due group, oldest first (``force`` makes every
        group due). Returns the number of dispatches."""
        n = 0
        while True:
            claimed = self._claim_due_batch(force)
            if claimed is None:
                return n
            self._dispatch_claimed(*claimed)
            n += 1

    def drain(self) -> int:
        """Force-flush until every queue is empty; returns dispatches."""
        n = 0
        while True:
            with self._lock:
                if not self._queues:
                    return n
            n += self.pump(force=True)

    def launch_due(self, force: bool = False) -> Optional[_Flight]:
        """Claim and launch the next due batch without finishing it: the
        returned flight's work is queued on the device; hand it to
        ``finish_flight``. A launch failure is fanned out to its tickets
        here and None is returned."""
        claimed = self._claim_due_batch(force)
        if claimed is None:
            return None
        items, bucket = claimed
        flight, err = self._launch_batch(items, bucket)
        if err is not None:
            self._fanout_whole_error(items, bucket, err, False, 0.0)
            return None
        return flight

    def flush_ticket(self, ticket: int) -> int:
        """Dispatch only the group holding ``ticket`` until that ticket is
        served; other groups keep accumulating toward their own flushes.
        Returns the number of dispatches."""
        n = 0
        while True:
            self.expire_due()
            with self._lock:
                if ticket not in self._pending_tickets:
                    return n
                key = next((k for k, q in self._queues.items()
                            if any(it.ticket == ticket for it in q)), None)
            if key is None or not self._dispatch_group(key):
                return n
            n += 1

    def _dispatch_group(self, key: tuple) -> bool:
        with self._lock:
            claimed = self._pop_batch_locked(key)
        if claimed is None:
            return False
        self._dispatch_claimed(*claimed)
        return True

    # -- dispatch ------------------------------------------------------------

    def _dispatch_claimed(self, items: list, bucket: int) -> None:
        """One synchronous dispatch: launch and finish back to back."""
        flight, err = self._launch_batch(items, bucket)
        if err is not None:
            self._fanout_whole_error(items, bucket, err, False, 0.0)
            return
        self.finish_flight(flight)

    def _span_meta(self, items: list, bucket: int) -> dict:
        """A dispatch span's meta: its tickets and every ticket's trace id
        (the span parents under the first ticket's context; the others
        correlate through ``trace_ids``)."""
        return {
            "tickets": [it.ticket for it in items],
            "trace_ids": [it.trace.trace_id for it in items
                          if it.trace is not None],
            "bucket": bucket,
            "service_id": self.service_id,
        }

    def _launch_batch(self, items: list, bucket: int):
        """Assemble, pad, resolve the runner and queue ``items`` as one
        batch: ``(_Flight, None)``, or ``(None, err)`` when that failed.
        Runs outside the lock."""
        k = len(items)
        template = items[0].model
        spaces = [it.space for it in items]
        models = [it.model for it in items]
        tracer = get_tracer()
        # chaos seams: ticket-bound lane poisons are mapped to lanes and
        # pushed for the launch; "batch_exc" fails this whole dispatch;
        # "slow_compile" stretches its clock duration like a hung build
        st = inject.active()
        didx = st.bump("dispatch") if st is not None else None
        extra_s = 0.0
        pushed = False
        if st is not None:
            poisons = []
            for i, it in enumerate(items):
                f = st.ticket_fault(it.ticket)
                if f is not None:
                    poisons.append((i, f))
            if poisons:
                st.push_lane_poisons(poisons)
                pushed = True
        builds0 = self.executor.builds
        c0 = self._clock()
        try:
            if st is not None:
                bf = st.take("dispatch", didx, kinds=("batch_exc",))
                if bf is not None:
                    raise inject.InjectedFault(
                        f"injected batch fault on dispatch {didx}")
                sf = st.take("assemble", st.bump("assemble"),
                             kinds=("slow_compile",))
                if sf is not None:
                    extra_s = sf.seconds
            with tracer.span("ensemble.assemble", parent=items[0].trace,
                             **self._span_meta(items, bucket)):
                for it in items:
                    # a space a client thread made on another stream is
                    # ready before the batch reads it
                    if it.ready is not None:
                        torch.cuda.current_stream(
                            it.space.device).wait_event(it.ready)
                if bucket > k:
                    pspaces, pmodels = padding_scenarios(
                        template, spaces[0], bucket - k)
                    spaces += pspaces
                    models += pmodels
            xla = self.executor.impl == "xla"
            # "launch" covers the runner's resolution too: on a cache miss
            # the build happens inside (cache_hit says which)
            with tracer.span("ensemble.launch", parent=items[0].trace,
                             **self._span_meta(items, bucket)) as sm:
                inflight = launch_ensemble(
                    template, spaces, models=models, executor=self.executor,
                    steps=items[0].steps, count=k,
                    windows=self.windows if xla else 1,
                    donate=self.donate and xla)
                sm["cache_hit"] = self.executor.builds == builds0
        # analysis: ignore[broad-except] — dispatch supervisor: any whole-
        # batch failure must fan out to the affected tickets instead of
        # stranding them or leaking into an unrelated caller
        # the dispatch boundary: any whole-batch failure (an ineligible
        # engine, a kernel error) fans out to the affected tickets instead of
        # stranding them or reaching an unrelated caller
        except Exception as e:
            return None, e
        finally:
            if pushed:
                st.clear_lane_poisons()
        return _Flight(items=items, bucket=bucket, inflight=inflight,
                       cache_hit=self.executor.builds == builds0, c0=c0,
                       c_launched=self._clock(), didx=didx,
                       extra_s=extra_s), None

    def _complete_batch(self, flight: _Flight):
        """Wait for a launched batch and enforce the dispatch deadline:
        ``(results, whole_err, cache_hit, wall)``. Serving counters are
        recorded here, so solo retries bill like any other dispatch."""
        k = len(flight.items)
        c_f0 = self._clock()
        try:
            with get_tracer().span(
                    "ensemble.fetch", parent=flight.items[0].trace,
                    **self._span_meta(flight.items, flight.bucket)):
                results = complete_ensemble(
                    flight.inflight,
                    check_conservation=self.check_conservation,
                    tolerance=self.tolerance, rtol=self.rtol,
                    on_violation="mark")
        # analysis: ignore[broad-except] — dispatch supervisor: a
        # fetch/conservation-machinery failure fans out like a launch failure
        except Exception as e:  # fanned out like a launch failure
            return None, e, flight.cache_hit, 0.0
        # the batch wall: from any served lane's Report, else from a marked
        # violation (so a dispatch whose every lane violated still bills)
        wall = 0.0
        for res in results:
            if not isinstance(res, Exception):
                wall = res[1].wall_time_s
                break
            wall = getattr(res, "wall_time_s", 0.0) or wall
        # the launch and fetch segments (+ injected build-hang seconds); the
        # async gap between them, this batch running while its successor
        # was assembled, is not billed. A real hang sits in the fetch.
        duration = ((flight.c_launched - flight.c0)
                    + (self._clock() - c_f0) + flight.extra_s)
        st = inject.active()
        if st is not None:
            hf = st.take("dispatch", flight.didx, kinds=("hang",))
            if hf is not None:
                duration += hf.seconds
        if (self.dispatch_deadline_s is not None
                and duration > self.dispatch_deadline_s):
            # an overrun dispatch's results are not trusted, nor billed
            return None, DispatchTimeout(
                f"dispatch overran its {self.dispatch_deadline_s}s "
                f"deadline ({duration:.3f}s by the scheduler clock)"
            ), flight.cache_hit, wall
        self.counter.record_dispatch(
            scenarios=k, bucket=flight.bucket, wall_s=wall,
            cache_hit=flight.cache_hit,
            # analysis: ignore[naked-timer] — the occupancy span (launch
            # start -> fetched) closes against the launch anchor batch.py
            # recorded; it feeds the inflight_s counter the spans are
            # reconciled against
            inflight_s=time.perf_counter() - flight.inflight.t0)
        with self._lock:
            # a clean completion closes the health gate: the (possibly
            # degraded) engine is serving again
            self.intake_gated = False
            degraded = self.degraded_from
        if degraded is not None or self.service_id is not None:
            # a report served after a rung says so, naming the engine that
            # ran its batch, and every served report names the member that
            # produced it
            extra = {}
            if degraded is not None:
                extra = {"impl": flight.inflight.executor.impl,
                         "degraded_from": degraded}
            if self.service_id is not None:
                extra["service_id"] = self.service_id
            for res in results:
                if not isinstance(res, Exception):
                    res[1].backend_report = {
                        **(res[1].backend_report or {}), **extra}
        return results, None, flight.cache_hit, wall

    def _execute_batch(self, items: list, bucket: int):
        """One synchronous physical dispatch (launch + complete)."""
        flight, err = self._launch_batch(items, bucket)
        if err is not None:
            return None, err, False, 0.0
        return self._complete_batch(flight)

    def finish_flight(self, flight: _Flight) -> None:
        """Complete a launched batch and resolve its tickets: lane errors go
        to solo retry or quarantine per policy, served lanes publish with
        their queue latency, and the dispatch log entry reconciles with the
        counters."""
        items, bucket = flight.items, flight.bucket
        k = len(items)
        results, whole_err, cache_hit, wall = self._complete_batch(flight)
        if whole_err is not None:
            self._fanout_whole_error(items, bucket, whole_err, cache_hit,
                                     wall)
            return
        failed: list[int] = []
        for it, res in zip(items, results):
            if isinstance(res, Exception) and self.retry == "solo":
                if k > 1:
                    failed.append(it.ticket)
                else:
                    # it already ran alone: nothing left to distinguish
                    self._quarantine(it, res, attempts=1)
                continue
            if isinstance(res, Exception):
                res.ticket = it.ticket
            self._publish(it, res)
        # the retry budget splits the failed lanes before the log entry is
        # written, so the entry reconciles with what actually runs
        retried: list[int] = []
        budget_starved: list[int] = []
        for t in failed:
            if (self.retry_budget is None
                    or self.counter.solo_retries + len(retried)
                    < self.retry_budget):
                retried.append(t)
            else:
                budget_starved.append(t)
        entry = {
            "bucket": bucket, "count": k, "occupancy": k / bucket,
            "steps": items[0].steps,
            "tickets": [it.ticket for it in items],
            "cache_hit": cache_hit, "wall_s": wall,
        }
        if flight.inflight.windows > 1 or self.donate:
            # the donation observable: how many of this dispatch's windows
            # the storage check found carried copy-free
            entry["windows"] = flight.inflight.windows
            entry["donated_windows"] = flight.inflight.donated_windows
        if retried:
            entry["retried_solo"] = list(retried)
        if budget_starved:
            entry["retry_budget_exhausted"] = list(budget_starved)
        with self._lock:
            self.dispatch_log.append(entry)
        # retries run after the batch entry, so the log reads in dispatch
        # order (batch, then its solos)
        by_ticket = {it.ticket: (it, res)
                     for it, res in zip(items, results)}
        for t in retried:
            it, res = by_ticket[t]
            self._serve_solo(it, res, batch_level=False)
        for t in budget_starved:
            it, res = by_ticket[t]
            self._quarantine(it, res, attempts=1,
                             note=f"retry budget ({self.retry_budget}) "
                                  "exhausted — quarantined without a "
                                  "solo retry")

    def fail_flight(self, flight: _Flight, err: Exception) -> None:
        """Last-resort resolution when ``finish_flight`` itself raised:
        ``err`` goes to every still-pending ticket of the flight, so no
        ticket stays pending forever."""
        for it in flight.items:
            with self._lock:
                still = it.ticket in self._pending_tickets
            if still:
                self._publish(it, err)

    def _publish(self, it: _Pending, res) -> None:
        """Resolve one ticket; served results record their queue latency
        (submit → served, injectable clock)."""
        with self._lock:
            self._results[it.ticket] = res
            self._pending_tickets.discard(it.ticket)
        if not isinstance(res, Exception):
            self.counter.record_latency(self._clock() - it.submitted_at)
            get_recorder().record("served", service_id=self.service_id,
                                  ticket=it.ticket)
        else:
            get_recorder().record("failed", service_id=self.service_id,
                                  ticket=it.ticket,
                                  error=type(res).__name__)

    def _fanout_whole_error(self, items: list, bucket: int,
                            whole_err: Exception, cache_hit: bool,
                            wall: float) -> None:
        """An impl- or dispatch-level fault (an ineligible engine, a kernel
        error, a deadline overrun): it is counted toward the degradation
        ladder (a kernel error steps no rung), then the solo-retry machinery
        serves each lane or, under policy "none", every affected ticket
        raises this error when polled."""
        k = len(items)
        self._note_impl_fault(whole_err)
        with self._lock:
            self.dispatch_log.append({
                "bucket": bucket, "count": k, "occupancy": k / bucket,
                "steps": items[0].steps,
                "tickets": [it.ticket for it in items],
                "cache_hit": cache_hit, "wall_s": wall,
                "error": f"{type(whole_err).__name__}: {whole_err}",
            })
        if self.retry == "solo":
            for it in items:
                if self._retry_budget_left():
                    self._serve_solo(it, whole_err, batch_level=True)
                else:
                    self._quarantine(
                        it, whole_err, attempts=1,
                        note=f"retry budget ({self.retry_budget}) "
                             "exhausted — quarantined without a solo "
                             "retry")
            return
        for it in items:
            self._publish(it, whole_err)

    def _retry_budget_left(self) -> bool:
        return (self.retry_budget is None
                or self.counter.solo_retries < self.retry_budget)

    def _serve_solo(self, it: _Pending, cause: Exception,
                    batch_level: bool) -> None:
        """Re-dispatch one failed scenario alone, once: success means the
        failure was the batch's and the scenario recovers; failure means the
        scenario is at fault and is quarantined. Solo dispatches get their
        own ``dispatch_log`` entries."""
        self.counter.bump("solo_retries")
        # a solo retry still tiles the mesh
        solo_bucket = (self.buckets[0] if self.mesh is None
                       else self.mesh.round_up(self.buckets[0]))
        results, whole_err, cache_hit, wall = self._execute_batch(
            [it], solo_bucket)
        err = whole_err
        if err is None and isinstance(results[0], Exception):
            err = results[0]
        entry = {
            "bucket": solo_bucket, "count": 1,
            "occupancy": 1 / solo_bucket, "steps": it.steps,
            "tickets": [it.ticket], "cache_hit": cache_hit,
            "wall_s": wall, "solo_retry": True,
            "outcome": "recovered" if err is None else "quarantined",
        }
        if err is not None:
            entry["error"] = f"{type(err).__name__}: {err}"
        with self._lock:
            self.dispatch_log.append(entry)
        if err is None:
            self.counter.bump("recovered_failures")
            if not batch_level:
                # a lane failure that vanishes when the scenario runs alone
                # is evidence of a batch-level fault: it feeds the ladder
                self._note_impl_fault(cause)
            self._publish(it, results[0])
            return
        if whole_err is not None:
            self._note_impl_fault(whole_err)
        self._quarantine(it, err, attempts=2)

    def _quarantine(self, it: _Pending, err: Exception,
                    attempts: int, note: Optional[str] = None) -> None:
        """Isolate a deterministically failing scenario: its error, with a
        complete ``FailureEvent``, is what ``poll`` raises."""
        msg = str(err)
        if isinstance(err, DispatchTimeout):
            kind = "timeout"
        elif "non-finite" in msg:
            kind = "nonfinite"
        elif "conservation" in msg:
            kind = "conservation"
        else:
            kind = "exception"
        detail = f"{type(err).__name__}: {err}"
        if note:
            detail = f"{note}; {detail}"
        ev = FailureEvent(
            step=it.steps, kind=kind, detail=detail, rolled_back_to=0,
            attempt=attempts, wall_time_s=0.0,
            classification="deterministic", ticket=it.ticket,
            service_id=self.service_id)
        with self._lock:
            self.quarantine_log.append(ev)
        self.counter.bump("quarantined")
        err.ticket = it.ticket
        err.failure_event = ev
        # the flight recorder dumps beside every quarantine's FailureEvent:
        # what this service did in the run-up
        get_recorder().record("quarantined", service_id=self.service_id,
                              ticket=it.ticket, fault_kind=kind)
        get_recorder().dump("quarantine", service_id=self.service_id,
                            ticket=it.ticket)
        self._publish(it, err)

    #: the degradation ladder: each impl's next-simpler engine. The fused
    #: active kernels step down to the plain active engine first (the same
    #: skip rule without K6/K7), then to the dense batched step.
    DEGRADE_TO = {"active_fused": "active", "active": "xla",
                  "pipeline": "xla"}

    def _note_impl_fault(self, err: Exception) -> None:
        """Count an impl-level fault toward the ladder; every
        ``degrade_after`` of them the executor steps one rung down
        ``DEGRADE_TO`` (its substeps and compute dtype kept), with the
        warning, the intake gate raised and ``degraded_from`` set to the
        impl first left (the current one is ``stats()["impl"]``). A hand
        kernel's own failure is counted and steps no rung."""
        self.counter.bump("impl_faults")
        if _kernel_failed(err):
            return
        with self._lock:
            self._impl_fault_count += 1
            nxt = self.DEGRADE_TO.get(self.executor.impl)
            if (nxt is None
                    or self._impl_fault_count < self.degrade_after):
                return
            old = self.executor.impl
            if self.degraded_from is None:
                self.degraded_from = old
            # each further rung needs degrade_after new faults
            self._impl_fault_count = 0
            self.executor = EnsembleExecutor(
                impl=nxt, substeps=self.executor.substeps,
                compute_dtype=self.executor.compute_dtype, mesh=self.mesh)
            # mid-fall: intake pauses until a dispatch completes clean
            self.intake_gated = True
        warnings.warn(
            f"ensemble impl {old!r} degraded to {nxt!r} after "
            f"{self.degrade_after} impl-level dispatch fault(s) "
            f"(last: {type(err).__name__}: {err})", RuntimeWarning)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters (``ThroughputCounter.snapshot``), runner-cache
        accounting and queue depth, with the JAX package's keys; one
        consistent cut."""
        with self._lock:
            out = self.counter.snapshot()
            out.update({
                "runner_builds": self.executor.builds,
                "runner_cache_hits": self.executor.cache_hits,
                "pending": len(self._pending_tickets),
                "impl": self.executor.impl,
                "substeps": self.executor.substeps,
                "buckets": list(self.buckets),
                "mesh": (None if self.mesh is None else
                         {"batch": self.mesh.batch,
                          "space": self.mesh.space,
                          "devices": self.mesh.devices}),
                "retry": self.retry,
                "retry_budget": self.retry_budget,
                "ticket_deadline_s": self.ticket_deadline_s,
                "degraded_from": self.degraded_from,
                "intake_gated": self.intake_gated,
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "service_id": self.service_id,
            })
            return out
