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
recovered; a solo failure quarantines it with a ``FailureEvent``. An
impl-level fault (a kernel's build or launch error, an ineligible engine)
reaches every affected ticket as that error: the JAX package's degradation
ladder (``pipeline`` → ``xla``, ``active_fused`` → ``active`` → ``xla``) is
not carried over, because every lower rung in the port is plain torch, and
a kernel's failure must not turn into the plain version running on the card.
``impl_faults`` counts them; ``degraded_from`` and ``intake_gated`` keep the
JAX package's ``stats()`` keys and never change. ``dispatch_deadline_s`` bounds a dispatch by the injectable clock (an
overrun is a ``DispatchTimeout``), ``ticket_deadline_s`` a queued ticket
(``TicketExpired`` with a ``FailureEvent``), ``retry_budget`` the total solo
retries.

A dispatch is two halves: launch (assemble, pad, resolve the runner, queue
the work: ``launch_due`` → ``batch.launch_ensemble``) and finish (wait,
conservation, results: ``finish_flight`` → ``batch.complete_ensemble``); the
synchronous path runs them back to back. Shared state is mutated only under
the one ``_lock``; device work runs outside it.

Not ported (``NotImplementedError`` naming ROADMAP.md):
``windows > 1``, ``donate=True``, ``mesh=``, migration between schedulers,
the chaos seams, tracing spans and the flight recorder; the fleet's
``counter`` and ``service_id`` arguments are left out with the fleet
(``stats()`` keeps their keys).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable, Optional, Sequence

from ..core.cellular_space import CellularSpace
from ..models.model import _not_ported
from ..resilience import FailureEvent
from ..utils.metrics import ThroughputCounter
from .batch import (EnsembleExecutor, complete_ensemble, launch_ensemble,
                    padding_scenarios, structure_key)

#: default bucket ladder: pad k scenarios up to the smallest entry >= k
DEFAULT_BUCKETS = (1, 2, 4, 8)


class DispatchTimeout(RuntimeError):
    """A dispatch overran ``dispatch_deadline_s`` by the scheduler's
    (injectable) clock. Its results are discarded; the affected tickets are
    retried solo or failed, per the retry policy."""


class TicketExpired(RuntimeError):
    """A queued ticket's ``ticket_deadline_s`` passed before it was
    dispatched: ``poll`` raises this with a complete ``FailureEvent``
    (kind="expired") attached, never a silent drop."""


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
                 ticket_deadline_s: Optional[float] = None,
                 retry_budget: Optional[int] = None,
                 windows: int = 1, donate: bool = False,
                 mesh=None):
        if retry not in ("none", "solo"):
            raise ValueError(
                f"unknown retry policy {retry!r} (expected 'none' or "
                "'solo')")
        bl = tuple(sorted({int(b) for b in buckets}))
        if not bl or bl[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        if int(windows) > 1:
            raise _not_ported("windowed dispatch (windows > 1)")
        if donate:
            raise _not_ported("donated dispatch (donate=True)")
        if mesh is not None:
            raise _not_ported("the mesh-sharded ensemble (mesh=...)")
        self.buckets = bl
        self.max_batch = bl[-1] if max_batch is None else int(max_batch)
        if not 1 <= self.max_batch <= bl[-1]:
            raise ValueError(
                f"max_batch={max_batch} outside [1, {bl[-1]}] (the "
                "largest bucket bounds a dispatch)")
        self.max_wait_s = float(max_wait_s)
        self.executor = EnsembleExecutor(impl=impl, substeps=substeps,
                                         compute_dtype=compute_dtype)
        self.check_conservation = check_conservation
        self.tolerance = tolerance
        self.rtol = rtol
        self.counter = ThroughputCounter()
        self._clock = clock
        self.retry = retry
        self.dispatch_deadline_s = dispatch_deadline_s
        self.ticket_deadline_s = ticket_deadline_s
        self.retry_budget = retry_budget
        #: one FailureEvent per quarantined scenario, in order
        self.quarantine_log: list = []
        #: one FailureEvent per expired ticket, in order
        self.expired_log: list = []
        #: THE lock over the queues, results, pending set and logs; re-entrant for the synchronous submit → dispatch chain
        self._lock = threading.RLock()
        self._queues: collections.OrderedDict[tuple, list[_Pending]] = \
            collections.OrderedDict()
        self._results: dict[int, object] = {}
        self._pending_tickets: set[int] = set()
        self._ids = itertools.count()
        #: one record per dispatch ({bucket, count, occupancy, steps,
        #: tickets, cache_hit, wall_s}), the most recent 256
        self.dispatch_log: collections.deque = collections.deque(maxlen=256)

    # -- submission / results ------------------------------------------------

    def submit(self, space: CellularSpace, model, steps: Optional[int] = None
               ) -> int:
        """Queue one scenario; returns its ticket. The group dispatches
        at once when it holds ``max_batch`` scenarios."""
        steps = model.num_steps if steps is None else int(steps)
        key = structure_key(model, space) + (steps,)
        with self._lock:
            ticket = next(self._ids)
            self._queues.setdefault(key, []).append(
                _Pending(ticket, space, model, steps, self._clock()))
            self._pending_tickets.add(ticket)
            full = len(self._queues[key]) >= self.max_batch
        if full:
            self._dispatch_group(key)
        return ticket

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
                    classification="deterministic", ticket=it.ticket)
                err.ticket = it.ticket
                err.failure_event = ev
                self.expired_log.append(ev)
                self.dispatch_log.append({"expired_ticket": it.ticket,
                                          "steps": it.steps,
                                          "queued_s": age})
                self._results[it.ticket] = err
                self._pending_tickets.discard(it.ticket)
                self.counter.bump("expired")
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
        return items, next(b for b in self.buckets if b >= k)

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

    def _launch_batch(self, items: list, bucket: int):
        """Assemble, pad, resolve the runner and queue ``items`` as one
        batch: ``(_Flight, None)``, or ``(None, err)`` when that failed.
        Runs outside the lock."""
        k = len(items)
        template = items[0].model
        spaces = [it.space for it in items]
        models = [it.model for it in items]
        builds0 = self.executor.builds
        c0 = self._clock()
        try:
            if bucket > k:
                pspaces, pmodels = padding_scenarios(template, spaces[0],
                                                     bucket - k)
                spaces += pspaces
                models += pmodels
            inflight = launch_ensemble(
                template, spaces, models=models, executor=self.executor,
                steps=items[0].steps, count=k)
        # the dispatch boundary: any whole-batch failure (an ineligible
        # engine, a kernel error) fans out to the affected tickets instead of
        # stranding them or reaching an unrelated caller
        except Exception as e:
            return None, e
        return _Flight(items=items, bucket=bucket, inflight=inflight,
                       cache_hit=self.executor.builds == builds0, c0=c0,
                       c_launched=self._clock()), None

    def _complete_batch(self, flight: _Flight):
        """Wait for a launched batch and enforce the dispatch deadline:
        ``(results, whole_err, cache_hit, wall)``. Serving counters are
        recorded here, so solo retries bill like any other dispatch."""
        k = len(flight.items)
        c_f0 = self._clock()
        try:
            results = complete_ensemble(
                flight.inflight, check_conservation=self.check_conservation,
                tolerance=self.tolerance, rtol=self.rtol,
                on_violation="mark")
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
        duration = (flight.c_launched - flight.c0) + (self._clock() - c_f0)
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
            inflight_s=time.perf_counter() - flight.inflight.t0)
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
            self._serve_solo(it, batch_level=False)
        for t in budget_starved:
            it, res = by_ticket[t]
            self._quarantine(it, res, attempts=1,
                             note=f"retry budget ({self.retry_budget}) "
                                  "exhausted — quarantined without a "
                                  "solo retry")

    def _publish(self, it: _Pending, res) -> None:
        """Resolve one ticket; served results record their queue latency
        (submit → served, injectable clock)."""
        with self._lock:
            self._results[it.ticket] = res
            self._pending_tickets.discard(it.ticket)
        if not isinstance(res, Exception):
            self.counter.record_latency(self._clock() - it.submitted_at)

    def _fanout_whole_error(self, items: list, bucket: int,
                            whole_err: Exception, cache_hit: bool,
                            wall: float) -> None:
        """An impl- or dispatch-level fault (an ineligible engine, a kernel
        error, a deadline overrun): it is counted, then the solo-retry
        machinery serves each lane or, under policy "none", every affected
        ticket raises this error when polled."""
        k = len(items)
        self.counter.bump("impl_faults")
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
                    self._serve_solo(it, batch_level=True)
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

    def _serve_solo(self, it: _Pending, batch_level: bool) -> None:
        """Re-dispatch one failed scenario alone, once: success means the
        failure was the batch's and the scenario recovers; failure means the
        scenario is at fault and is quarantined. Solo dispatches get their
        own ``dispatch_log`` entries."""
        self.counter.bump("solo_retries")
        solo_bucket = self.buckets[0]
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
                # is evidence of a batch-level fault
                self.counter.bump("impl_faults")
            self._publish(it, results[0])
            return
        if whole_err is not None:
            self.counter.bump("impl_faults")
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
            classification="deterministic", ticket=it.ticket)
        with self._lock:
            self.quarantine_log.append(ev)
        self.counter.bump("quarantined")
        err.ticket = it.ticket
        err.failure_event = ev
        self._publish(it, err)

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
                "mesh": None,
                "retry": self.retry,
                "retry_budget": self.retry_budget,
                "ticket_deadline_s": self.ticket_deadline_s,
                "degraded_from": None,
                "intake_gated": False,
                "migrated_out": 0,
                "migrated_in": 0,
                "service_id": None,
            })
            return out
