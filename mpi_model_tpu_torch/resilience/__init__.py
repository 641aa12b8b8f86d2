"""Resilience: ``FailureEvent``, what the ensemble scheduler emits for each
quarantined or expired scenario, and ``inject``, the deterministic fault
plans whose serving seams the ensemble path fires. The supervisor and the
executor, checkpoint, fleet, wire and tiering seams are not ported yet
(ROADMAP.md, Queue 1)."""

from . import inject
from .events import FailureEvent

__all__ = ["FailureEvent", "inject"]
