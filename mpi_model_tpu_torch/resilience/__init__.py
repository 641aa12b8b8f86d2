"""Resilience records: ``FailureEvent``, what the ensemble scheduler emits
for each quarantined or expired scenario. The supervisor and the fault
injection of the JAX package are not ported yet (ROADMAP.md, Queue 1 item
4)."""

from .events import FailureEvent

__all__ = ["FailureEvent"]
