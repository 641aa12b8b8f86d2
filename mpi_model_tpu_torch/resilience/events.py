"""``FailureEvent`` (counterpart of
``mpi_model_tpu/resilience/supervisor.py:72``; the port keeps its own copy).
The supervisor (``resilience.supervisor``) and the ensemble scheduler emit
the same record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FailureEvent:
    """One detected failure and what the recovery layer did about it: the
    supervisor emits one per failed chunk (rollback and retry), the ensemble
    scheduler one per quarantined scenario and per expired ticket."""

    #: step the failed chunk (or run) would have reached
    step: int
    #: "exception" (the executor raised) | "nonfinite" | "conservation" |
    #: "timeout" (a dispatch overran its deadline) | "expired" (a queued
    #: ticket's deadline passed before dispatch)
    kind: str
    detail: str
    #: step rolled back to: the supervisor's last good step (that of the
    #: last good checkpoint); 0 for the scheduler (a scenario restarts whole)
    rolled_back_to: int
    #: consecutive failures at the time (1 = first); the scheduler's attempts
    attempt: int
    #: seconds from the chunk's start to the failure's detection
    wall_time_s: float
    #: "transient" (retried) or "deterministic" (the same fault recurred
    #: identically after a rollback, and the supervisor failed fast; for the
    #: scheduler, a scenario whose solo retry failed too)
    classification: str = "transient"
    #: backoff slept before the retry this event triggered (0 = none)
    backoff_s: float = 0.0
    #: the scheduler ticket this event resolved
    ticket: Optional[int] = None
    #: the serving member that emitted this event; None outside serving
    service_id: Optional[str] = None
