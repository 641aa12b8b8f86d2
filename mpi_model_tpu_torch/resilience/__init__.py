"""Resilience: failure detection and recovery (``supervisor``:
``check_health``, ``supervised_run``), ``FailureEvent``, and ``inject``, the
deterministic fault plans whose seams the executors, the halo exchange, the
checkpoint writers and the serving path fire. The fleet, wire and tiering
seams are not wired yet (ROADMAP.md, Queue 1).

The supervisor's names are exported lazily (PEP 562): ``supervisor``
imports ``models.model``, which imports ``inject`` from this package, so an
eager import here would form a cycle while the package initializes."""

from __future__ import annotations

import importlib

from . import inject
from .events import FailureEvent

_SUPERVISOR_SYMBOLS = (
    "HealthError",
    "SimulationFailure",
    "SupervisedResult",
    "check_health",
    "supervised_run",
)

__all__ = ["FailureEvent", "inject", "supervisor", *_SUPERVISOR_SYMBOLS]


def __getattr__(name: str):
    if name in _SUPERVISOR_SYMBOLS:
        return getattr(importlib.import_module(".supervisor", __name__),
                       name)
    if name == "supervisor":
        return importlib.import_module(".supervisor", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
