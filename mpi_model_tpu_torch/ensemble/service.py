"""The synchronous serving facade over the bucketed scheduler (counterpart
of ``mpi_model_tpu/ensemble/service.py:75-179``).

``EnsembleService``: submit/poll/result/flush/stats. Dispatch happens inline
on the caller's thread when a bucket fills or the caller flushes. The JAX
package's always-on ``AsyncEnsembleService`` and its open-loop
``run_soak`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from ..core.cellular_space import CellularSpace
from ..models.model import _not_ported
from .scheduler import DEFAULT_BUCKETS, EnsembleScheduler


class EnsembleService:
    """submit/poll API over ``EnsembleScheduler``.

    ``steps`` sets the default per-submission step count (falling back to
    the template's ``time/time_step``); the other keyword arguments
    configure the scheduler (impl, substeps, buckets, max_wait_s, max_batch,
    the conservation policy, clock, ``retry="solo"``,
    ``dispatch_deadline_s``, ``ticket_deadline_s``, ``retry_budget``).
    ``compile_cache`` is accepted so that a caller of the JAX package's
    service runs unchanged: ``"auto"`` (the default) or ``None``, and it
    arms nothing (``compile_cache`` stays None), since the port compiles no
    programs and its kernels' build cache (``mpi_model_tpu_torch/_build/``)
    is always on. The JAX package's ``degrade_after`` has no counterpart:
    the port has no degradation ladder (``scheduler``'s docstring).
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
                 ticket_deadline_s: Optional[float] = None,
                 retry_budget: Optional[int] = None,
                 windows: int = 1, donate: bool = False,
                 compile_cache: Optional[str] = "auto",
                 mesh=None):
        if compile_cache not in ("auto", None):
            raise ValueError(
                f"compile_cache={compile_cache!r}: the port accepts 'auto' "
                "or None and arms nothing (it compiles no programs; its "
                "kernels' build cache is mpi_model_tpu_torch/_build/)")
        #: what the JAX package arms here; the port arms nothing
        self.compile_cache = None
        self.model = model
        self.default_steps = (model.num_steps if steps is None
                              else int(steps))
        self.scheduler = EnsembleScheduler(
            impl=impl, substeps=substeps, buckets=buckets,
            max_wait_s=max_wait_s, max_batch=max_batch,
            compute_dtype=compute_dtype,
            check_conservation=check_conservation, tolerance=tolerance,
            rtol=rtol, clock=clock, retry=retry,
            dispatch_deadline_s=dispatch_deadline_s,
            ticket_deadline_s=ticket_deadline_s,
            retry_budget=retry_budget,
            windows=windows, donate=donate, mesh=mesh)

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
        """Moving a queued scenario to another service needs the delta
        stream (``io/delta.py``), which is not ported yet."""
        raise _not_ported("EnsembleService.migrate (it needs io/delta.py)")

    def flush(self) -> int:
        """Dispatch everything queued; returns the dispatch count."""
        return self.scheduler.drain()

    def stats(self) -> dict:
        """Serving counters: scenarios/s, batch occupancy, runner-cache
        hits, dispatches, queue depth (``EnsembleScheduler.stats``)."""
        return self.scheduler.stats()
