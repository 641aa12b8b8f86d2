"""``FailureEvent`` (counterpart of
``mpi_model_tpu/resilience/supervisor.py:72``; the port keeps its own copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FailureEvent:
    """One detected failure and what the recovery layer did about it. The
    port's ensemble scheduler emits one per quarantined scenario and per
    expired ticket."""

    #: step the failed run would have reached
    step: int
    #: "exception" | "nonfinite" | "conservation" | "timeout" (a dispatch
    #: overran its deadline) | "expired" (a queued ticket's deadline passed
    #: before dispatch)
    kind: str
    detail: str
    #: step rolled back to (0 for the scheduler: a scenario restarts whole)
    rolled_back_to: int
    #: attempts made (1 = first)
    attempt: int
    wall_time_s: float
    #: "transient" (retried) or "deterministic" (the same fault recurred:
    #: for the scheduler, a scenario whose solo retry failed too)
    classification: str = "transient"
    #: backoff slept before the retry this event triggered (0 = none)
    backoff_s: float = 0.0
    #: the scheduler ticket this event resolved
    ticket: Optional[int] = None
    #: the serving member that emitted this event; None outside serving
    service_id: Optional[str] = None
