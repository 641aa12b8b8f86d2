"""Resilience: failure detection and recovery (``supervisor``:
``check_health``, ``supervised_run``), ``FailureEvent``, and ``inject``, the
deterministic fault plans whose seams the executors, the halo exchange, the
checkpoint writers, the serving path, the journal and the wire fire;
``lockdep``, the lock-order witness the serving locks are made through; and
``protocolcheck``, the witness of live journal streams. The fleet's member
and tiering seams are not wired yet (ROADMAP.md, Queue 1).

The supervisor's names are exported lazily (PEP 562): ``supervisor``
imports ``models.model``, which imports ``inject`` from this package, so an
eager import here would form a cycle while the package initializes.
``lockdep`` and ``protocolcheck`` are loaded on first use too."""

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

__all__ = ["FailureEvent", "inject", "lockdep", "protocolcheck",
           "supervisor", *_SUPERVISOR_SYMBOLS]


def __getattr__(name: str):
    if name in _SUPERVISOR_SYMBOLS:
        return getattr(importlib.import_module(".supervisor", __name__),
                       name)
    if name in ("lockdep", "protocolcheck", "supervisor"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
