"""Serving facades over the bucketed scheduler (counterpart of
``mpi_model_tpu/ensemble/service.py``).

- ``EnsembleService``: the synchronous submit/poll facade. Dispatch happens
  inline on the caller's thread when a bucket fills or the caller flushes.
- ``AsyncEnsembleService``: the always-on loop. A pump thread launches
  batch i (host assembly, runner lookup, the work queued on the card) and
  then finishes batch i-1 (a wait on that flight's own event, then the
  results), so the host work of one batch overlaps the device work of the
  one before. Admission is bounded (``ServiceOverloaded`` with the queue
  depth and a retry-after estimate), queued tickets have deadlines
  (``TicketExpired`` with a complete ``FailureEvent``), solo retries have a
  budget, and an exception on the pump thread is counted (``loop_faults``)
  while the loop keeps serving. Every submitted ticket resolves to a
  result, a quarantine error or ``TicketExpired``; a shed submission gets no
  ticket.
- ``run_soak``: the open-loop arrivals behind the CLI's ``--serve``:
  submissions arrive on a fixed-rate schedule whatever the completions, and
  the report carries sustained scenarios/s, p50/p99 queue latency,
  occupancy and the served/failed/expired/shed ledger. With
  ``snapshot_path`` it writes the telemetry snapshot (``obs``) on an
  interval and at the end; with ``status_port`` it serves the live scrape
  endpoint for the soak's length.

``compile_cache`` is the kernel build directory
(``utils.compile_cache``): ``"auto"`` (the default) the package's
``_build/``, a directory that one, ``None`` a private directory nothing is
reused from. A shed submission is recorded in the flight recorder.

The pump thread launches on its current stream, the device's default
stream; a space a client made on another stream is waited for before a
batch reads it (``EnsembleScheduler.submit``). ``impl="pipeline"`` builds
K5 on the constructing thread, so no build runs inside a dispatch
deadline, and a K5 build error is fatal at the service's start. A kernel's
launch error in the pump reaches each ticket as that error (the solo retry,
then quarantine) and never steps the scheduler's degradation ladder; every
``degrade_after`` other impl-level faults (an injected batch fault, a
dispatch deadline overrun, an ineligible engine) step the engine one rung
down, announced and stamped on every report it serves (``scheduler``'s
docstring). While a rung's
``intake_gated`` holds, ``AsyncEnsembleService.submit`` sheds
(``ServiceOverloaded`` "health-gated") unless the queue is empty: an idle
degraded service admits the next scenario as its probe. The synchronous
service bounds no queue and sheds nothing, as in the JAX package.

The serving locks are made through ``resilience.lockdep`` with the JAX
package's keys (``"AsyncEnsembleService._lock_cv"`` here), so an armed
witness watches the loop's acquisition orders.

Not ported (``NotImplementedError`` naming ROADMAP.md): the JAX package's
scenario tiering (``residency_budget``, ``hibernate_dir``,
``hibernate_budget``), ``mesh=``, and the fleet's member faults in the
pump.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Optional, Sequence

import torch

from ..core.cellular_space import CellularSpace
from ..models.model import _not_ported
from ..obs.flight import get_recorder
from ..resilience import inject, lockdep
from ..utils.compile_cache import (configure_compile_cache,
                                   resolve_compile_cache)
from .scheduler import DEFAULT_BUCKETS, EnsembleScheduler, TicketExpired


class ServiceOverloaded(RuntimeError):
    """Admission refused: the bounded queue is full or an injected
    ``queue_full`` fault fired. Carries ``queue_depth`` (pending tickets at
    refusal) and ``retry_after_s`` (a drain-time estimate from the recent
    per-scenario service time), so a client can back off."""

    def __init__(self, message: str, *, queue_depth: int,
                 retry_after_s: float):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = float(retry_after_s)


class EnsembleService:
    """submit/poll API over ``EnsembleScheduler``.

    ``steps`` sets the default per-submission step count (falling back to
    the template's ``time/time_step``); the other keyword arguments
    configure the scheduler (impl, substeps, buckets, max_wait_s, max_batch,
    the conservation policy, clock, ``retry="solo"``,
    ``dispatch_deadline_s``, ``degrade_after`` for the degradation
    ladder, ``ticket_deadline_s``, ``retry_budget``, ``windows``,
    ``donate``, ``service_id``). ``compile_cache`` points the kernel build
    directory (``utils.compile_cache``) before the first dispatch builds:
    ``"auto"`` (the default) the package's ``_build/``, a directory that
    one, ``None`` a private directory (``compile_cache`` then stays None).
    """

    def __init__(self, model, *, steps: Optional[int] = None,
                 impl: str = "xla", substeps: int = 1,
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
                 compile_cache: Optional[str] = "auto",
                 service_id: Optional[str] = None,
                 mesh=None):
        #: the build directory armed (None: a private one, reused by no
        #: other process)
        self.compile_cache = configure_compile_cache(
            resolve_compile_cache(compile_cache))
        self.model = model
        self.default_steps = (model.num_steps if steps is None
                              else int(steps))
        self.service_id = service_id
        self.scheduler = EnsembleScheduler(
            impl=impl, substeps=substeps, buckets=buckets,
            max_wait_s=max_wait_s, max_batch=max_batch,
            compute_dtype=compute_dtype,
            check_conservation=check_conservation, tolerance=tolerance,
            rtol=rtol, clock=clock, retry=retry,
            dispatch_deadline_s=dispatch_deadline_s,
            degrade_after=degrade_after,
            ticket_deadline_s=ticket_deadline_s,
            retry_budget=retry_budget,
            windows=windows, donate=donate, service_id=service_id,
            mesh=mesh)

    def submit(self, space: CellularSpace, *, model=None,
               steps: Optional[int] = None) -> int:
        """Queue one scenario; returns its ticket. ``model`` (default: the
        template) may vary numeric flow parameters; its structure must match
        the template's."""
        m = self.model if model is None else model
        return self.scheduler.submit(
            space, m, self.default_steps if steps is None else int(steps))

    def poll(self, ticket: int):
        """(space, Report) when served, None while queued; raises the
        scenario's ``EnsembleConservationError`` on violation."""
        return self.scheduler.poll(ticket)

    def result(self, ticket: int):
        """Force this ticket's scenario through (flushing only its structure
        group: other partial batches keep accumulating toward their own
        flushes) and return its (space, Report)."""
        res = self.poll(ticket)
        if res is None:
            self.scheduler.flush_ticket(ticket)
            res = self.poll(ticket)
        if res is None:  # pragma: no cover - flush_ticket serves it
            raise RuntimeError(f"ticket {ticket} still pending after flush")
        return res

    def migrate(self, ticket: int, target: "EnsembleService") -> int:
        """Move one queued scenario to ``target`` through the CRC-checked
        delta-stream handoff (``EnsembleScheduler.migrate_ticket``) and
        return its new ticket there: rebalancing between services without
        stopping either."""
        return self.scheduler.migrate_ticket(ticket, target.scheduler)

    def flush(self) -> int:
        """Dispatch everything queued; returns the dispatch count."""
        return self.scheduler.drain()

    def stats(self) -> dict:
        """Serving counters: scenarios/s, batch occupancy, runner-cache
        hits, dispatches, queue depth (``EnsembleScheduler.stats``)."""
        return self.scheduler.stats()


class AsyncEnsembleService:
    """The always-on serving loop (module docstring): an
    ``EnsembleScheduler`` with ``inline_dispatch=False`` and a pump thread
    driving launch and finish in a double-buffered cadence.

    ``start=False`` skips the thread: tests drive ``pump_once()`` on their
    own thread, with the injectable clock. ``stop()`` drains (every
    outstanding ticket resolves before it returns), and the service is a
    context manager that stops on exit.

    ``donate=True`` (the default; xla impl only, off without a word for the
    other impls) carries each dispatch's ``[B, H, W]`` state between its
    windows in the dispatch's own buffers. The JAX package's signature is
    accepted, ``degrade_after`` (the degradation ladder) included."""

    def __init__(self, model, *, steps: Optional[int] = None,
                 max_queue: int = 64,
                 deadline_s: Optional[float] = None,
                 impl: str = "xla", substeps: int = 1,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_s: float = 0.0, max_batch: Optional[int] = None,
                 compute_dtype=None, check_conservation: bool = True,
                 tolerance: float = 1e-3, rtol: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry: str = "solo",
                 dispatch_deadline_s: Optional[float] = None,
                 degrade_after: int = 2,
                 retry_budget: Optional[int] = None,
                 windows: int = 1, donate: bool = True,
                 compile_cache: Optional[str] = "auto",
                 start: bool = True, poll_interval_s: float = 0.02,
                 service_id: Optional[str] = None,
                 residency_budget: Optional[int] = None,
                 hibernate_dir: Optional[str] = None,
                 hibernate_budget: Optional[int] = None,
                 mesh=None):
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        if (residency_budget is not None or hibernate_dir is not None
                or hibernate_budget is not None):
            raise _not_ported(
                "scenario tiering (residency_budget/hibernate_dir/"
                "hibernate_budget: ensemble/tiering.py)")
        self.compile_cache = configure_compile_cache(
            resolve_compile_cache(compile_cache))
        self.model = model
        self.default_steps = (model.num_steps if steps is None
                              else int(steps))
        self.max_queue = int(max_queue)
        self.service_id = service_id
        self.scheduler = EnsembleScheduler(
            impl=impl, substeps=substeps, buckets=buckets,
            max_wait_s=max_wait_s, max_batch=max_batch,
            compute_dtype=compute_dtype,
            check_conservation=check_conservation, tolerance=tolerance,
            rtol=rtol, clock=clock, retry=retry,
            dispatch_deadline_s=dispatch_deadline_s,
            degrade_after=degrade_after,
            ticket_deadline_s=deadline_s,
            retry_budget=retry_budget,
            windows=windows, donate=donate,
            inline_dispatch=False, service_id=service_id, mesh=mesh)
        if impl == "pipeline":
            _warm_pipeline_kernel()
        self._poll_interval = float(poll_interval_s)
        #: guards the loop state below (witnessed when lockdep is armed)
        self._lock_cv = lockdep.condition("AsyncEnsembleService._lock_cv")
        self._inflight = None
        self._stop = False
        #: abandon(): exit now, no drain (``_stop`` alone means drain, then
        #: exit)
        self._abandoned = False
        self._thread: Optional[threading.Thread] = None
        #: the most recent supervised pump-loop failures (bounded)
        self.loop_errors: list = []
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the dispatch thread (idempotent)."""
        with self._lock_cv:
            if self._thread is not None:
                return
            if self._abandoned:
                raise RuntimeError(
                    "this service was abandoned; build a fresh one instead "
                    "of restarting it")
            self._stop = False
            t = threading.Thread(target=self._loop, daemon=True,
                                 name="ensemble-dispatch")
            self._thread = t
        t.start()

    def stop(self) -> None:
        """Drain and stop: the loop pumps until every pending ticket is
        resolved (served, quarantined or expired), then the thread exits.
        Without a thread (``start=False``) the drain runs here. Idempotent;
        the service may be started again afterwards."""
        with self._lock_cv:
            t = self._thread
            self._stop = True
            self._lock_cv.notify_all()
        if t is not None:
            t.join()
            with self._lock_cv:
                self._thread = None
                self._stop = False
            return
        while True:
            if not self.pump_once(force=True):
                with self._lock_cv:
                    idle = (self._inflight is None
                            and self.scheduler.pending_count() == 0)
                if idle:
                    break
        with self._lock_cv:
            self._stop = False

    def abandon(self) -> None:
        """Signal the loop to exit now, with no drain and no join (a failed
        member's escape hatch: a wedged pump never drains). Unresolved
        tickets are the caller's to re-admit; an abandoned service cannot
        be started again."""
        with self._lock_cv:
            self._stop = True
            self._abandoned = True
            self._thread = None
            self._lock_cv.notify_all()

    def is_alive(self) -> bool:
        """True while the dispatch thread exists and runs (manual mode has
        no thread and reports False)."""
        with self._lock_cv:
            t = self._thread
        return t is not None and t.is_alive()

    def has_work_due(self) -> bool:
        """True when the pump should be making progress now: a launched
        flight is outstanding, or a queued group is due. Work waiting out
        the batching policy is not due."""
        with self._lock_cv:
            if self._inflight is not None:
                return True
        return self.scheduler.due_backlog()

    def __enter__(self) -> "AsyncEnsembleService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ------------------------------------------------------

    def submit(self, space: CellularSpace, *, model=None,
               steps: Optional[int] = None) -> int:
        """Admit one scenario, or raise :class:`ServiceOverloaded` (bounded
        queue full, the health gate up, or an injected ``queue_full``
        fault). The depth check and the enqueue are atomic under the
        scheduler's lock, so the bound holds under concurrent submitters; no
        device work runs on the caller's thread."""
        m = self.model if model is None else model
        n = self.default_steps if steps is None else int(steps)
        st = inject.active()
        forced = False
        if st is not None:
            forced = st.take("admission", st.bump("admission"),
                             kinds=("queue_full",)) is not None
        sched = self.scheduler
        with sched._lock:
            depth = sched.pending_count()
            # the gate sheds new load only while the degraded engine still
            # has backlog to prove itself on: an idle degraded service
            # accepts the next scenario as its health probe
            gated = sched.intake_gated and depth > 0
            if forced or gated or depth >= self.max_queue:
                sched.counter.bump("shed")
                get_recorder().record("shed", service_id=self.service_id,
                                      depth=depth)
                reason = (
                    "injected queue-full fault" if forced
                    else "intake health-gated (degradation ladder "
                         "mid-fall)" if gated
                    else f"admission queue full ({depth}/{self.max_queue})")
                raise ServiceOverloaded(
                    f"submission shed — {reason}; retry after the "
                    "estimated drain time",
                    queue_depth=depth,
                    retry_after_s=self._retry_after(depth))
            ticket = sched.submit(space, m, n)
        with self._lock_cv:
            self._lock_cv.notify_all()
        return ticket

    def _retry_after(self, depth: int) -> float:
        """Drain-time estimate: queue depth × the per-scenario busy time,
        floored at the pump interval (O(1): it runs under the scheduler's
        lock)."""
        per = self.scheduler.counter.busy_per_scenario()
        if per is None:
            return max(self._poll_interval, self.scheduler.max_wait_s)
        return max(depth * per, self._poll_interval)

    def poll(self, ticket: int):
        """(space, Report) when served, None while in flight; raises the
        ticket's quarantine or expiry error. Never dispatches on the
        caller's thread: the loop owns the device."""
        return self.scheduler.poll(ticket, pump=False)

    def result(self, ticket: int, timeout: Optional[float] = None):
        """Block until ``ticket`` resolves; ``TimeoutError`` after
        ``timeout`` seconds (a client's wall bound). In manual mode
        (``start=False``) this pumps on the caller's thread instead."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            res = self.poll(ticket)
            if res is not None:
                return res
            with self._lock_cv:
                threaded = self._thread is not None
            if not threaded:
                if not self.pump_once(force=True):
                    # an expiry inside the claim is not pump work: poll
                    # again (raises TicketExpired or returns)
                    res = self.poll(ticket)
                    if res is not None:  # pragma: no cover - defensive
                        return res
                    raise RuntimeError(  # pragma: no cover - defensive
                        f"ticket {ticket} pending but the pump found no "
                        "work: the queue state is inconsistent")
                continue
            with self._lock_cv:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"ticket {ticket} still pending after {timeout}s")
                self._lock_cv.wait(self._poll_interval)

    def stats(self) -> dict:
        out = self.scheduler.stats()
        with self._lock_cv:
            out.update({
                "max_queue": self.max_queue,
                "async": True,
                "running": self._thread is not None,
                "loop_errors": len(self.loop_errors),
            })
        return out

    # -- the pump ------------------------------------------------------------

    def pump_once(self, force: bool = False) -> bool:
        """One double-buffered iteration on the calling thread: launch the
        next due batch (overdue tickets expire first), then finish the
        previously launched one. Returns whether any work was done. The
        ``thread_exc`` seam fires at the top, before any state moves; a
        failure escaping the finish resolves the flight's tickets
        (``fail_flight``) before it propagates."""
        st = inject.active()
        if st is not None:
            if st.take("pump", st.bump("pump"),
                       kinds=("thread_exc",)) is not None:
                raise inject.InjectedFault(
                    "injected dispatch-thread exception")
        flight = self.scheduler.launch_due(force=force)
        with self._lock_cv:
            prev, self._inflight = self._inflight, flight
        if prev is not None:
            try:
                self.scheduler.finish_flight(prev)
            except BaseException as e:
                self.scheduler.fail_flight(prev, e)
                raise
            finally:
                with self._lock_cv:
                    self._lock_cv.notify_all()
        return flight is not None or prev is not None

    def _loop(self) -> None:
        while True:
            try:
                with self._lock_cv:
                    if self._abandoned:
                        return
                    draining = self._stop
                did = self.pump_once(force=draining)
            # the pump-loop supervisor: an exception on this thread (the
            # thread_exc fault included) is counted and survived; a dead
            # loop is a dead service, and per-dispatch failures already
            # reach their tickets
            except Exception as e:
                self.scheduler.counter.bump("loop_faults")
                with self._lock_cv:
                    self.loop_errors.append(f"{type(e).__name__}: {e}")
                    del self.loop_errors[:-32]
                did = True
            with self._lock_cv:
                if (self._stop and self._inflight is None
                        and self.scheduler.pending_count() == 0):
                    return
                if not did and not self._stop:
                    self._lock_cv.wait(self._poll_interval)


def _warm_pipeline_kernel() -> None:
    """Build (or load from the build cache) K5 on this thread when a card
    is present, so the pump never builds it inside a dispatch deadline. A
    build error propagates: a service whose kernel cannot build does not
    start."""
    if torch.cuda.is_available():
        from ..ops import _build

        _build.load("pipeline_stencil")


def run_soak(service, scenarios, *, arrival_rate_hz: float,
             clock: Callable[[], float] = time.monotonic,
             sleep: Callable[[float], None] = time.sleep,
             snapshot_path: Optional[str] = None,
             snapshot_interval_s: float = 5.0,
             status_port: Optional[int] = None) -> dict:
    """Open-loop soak: submit ``scenarios`` (``(space, model, steps)``
    triples; model/steps may be None for the service's defaults) at a fixed
    arrival rate (arrivals do not wait for completions, so a service slower
    than the offered load builds real backlog and sheds), then collect every
    issued ticket. Returns the serving report: sustained scenarios/s (served
    / soak wall), p50/p99 queue latency, occupancy (dispatch in-flight
    seconds / soak wall) and the ledger (served + failed + expired + shed ==
    offered: ``ledger_complete``), with the JAX package's keys.

    ``clock``/``sleep`` are injectable, so tests drive the arrivals without
    wall-clock sleeps.

    ``snapshot_path``: the telemetry snapshot (``obs.write_snapshot``,
    atomic) is written there every ``snapshot_interval_s`` of clock time
    during the soak (in the arrival waits and between results) and once at
    the end; the report's ``telemetry_snapshot`` names it.
    ``status_port``: the live scrape endpoint (``obs.serve_status``: ``GET
    /metrics``, ``GET /``, fresh per request) serves the live service for
    the soak's length and is torn down before the report returns (port 0:
    an ephemeral port; one that cannot be bound raises)."""
    if arrival_rate_hz <= 0:
        raise ValueError(
            f"arrival_rate_hz={arrival_rate_hz} must be positive")
    if status_port is not None:
        from .. import obs

        server = obs.serve_status(
            status_port, lambda: obs.fleet_snapshot(service))
        try:
            return run_soak(service, scenarios,
                            arrival_rate_hz=arrival_rate_hz, clock=clock,
                            sleep=sleep, snapshot_path=snapshot_path,
                            snapshot_interval_s=snapshot_interval_s)
        finally:
            server.shutdown()
            server.server_close()

    def dump_snapshot() -> None:
        from .. import obs

        try:
            obs.write_snapshot(snapshot_path, service)
        except OSError as e:  # the soak goes on; the loss is loud
            warnings.warn(f"telemetry snapshot write failed: {e}",
                          RuntimeWarning)

    scenarios = list(scenarios)
    t0 = clock()
    next_snap = t0 + float(snapshot_interval_s)

    def maybe_dump(now: Optional[float] = None) -> None:
        """The one owner of the interval: a due snapshot is written and
        the next one scheduled."""
        nonlocal next_snap
        if snapshot_path is None:
            return
        if (clock() if now is None else now) < next_snap:
            return
        dump_snapshot()
        next_snap = clock() + float(snapshot_interval_s)

    tickets: list = []
    shed = 0
    for i, (space, model, steps) in enumerate(scenarios):
        due = t0 + i / arrival_rate_hz
        while True:
            now = clock()
            if now >= due:
                break
            maybe_dump(now)
            sleep(min(due - now, 0.01))
        maybe_dump()
        try:
            tickets.append(service.submit(space, model=model, steps=steps))
        except ServiceOverloaded:
            shed += 1
            tickets.append(None)
    served = failed = expired = 0
    for t in tickets:
        maybe_dump()
        if t is None:
            continue
        try:
            if snapshot_path is None:
                service.result(t)
            else:
                # a long wait must not freeze the snapshot: wait in
                # interval-sized slices, keeping the cadence between them
                while True:
                    try:
                        service.result(t, timeout=float(snapshot_interval_s))
                        break
                    except TimeoutError:
                        maybe_dump()
            served += 1
        except TicketExpired:
            expired += 1
        # the soak's ledger: every ticket not served is counted
        # (quarantine, conservation, a dispatch error), never raised
        except Exception:
            failed += 1
    wall = clock() - t0
    if snapshot_path is not None:
        dump_snapshot()  # the plane at the soak's end
    st = service.stats()
    offered = len(scenarios)
    return {
        "telemetry_snapshot": snapshot_path,
        "offered": offered,
        "arrival_rate_hz": arrival_rate_hz,
        "served": served,
        "failed": failed,
        "expired": expired,
        "shed": shed,
        "ledger_complete": served + failed + expired + shed == offered,
        "wall_s": wall,
        "sustained_scenarios_per_s": served / wall if wall > 0 else None,
        # in-flight share: how much of the soak wall a dispatch was
        # outstanding (launch to fetched, the async gap included)
        "occupancy": st["inflight_s"] / wall if wall > 0 else None,
        "latency_p50_s": st["latency_p50_s"],
        "latency_p99_s": st["latency_p99_s"],
        "batch_occupancy": st["batch_occupancy"],
        "compile_cache_hit_rate": st["compile_cache_hit_rate"],
        "dispatches": st["dispatches"],
        "solo_retries": st["solo_retries"],
        "recovered_failures": st["recovered_failures"],
        "quarantined": st["quarantined"],
        "expired_total": st["expired"],
        "shed_total": st["shed"],
        "loop_faults": st["loop_faults"],
        "degraded_from": st["degraded_from"],
    }
