"""Ensemble engine: many independent scenarios stepped together, behind a
bucketed scheduler (counterpart of ``mpi_model_tpu/ensemble/``).

- ``batch``     — ``EnsembleSpace`` (``[B, H, W]`` channels), the batched
                  parametric step, per-scenario conservation,
                  ``EnsembleExecutor`` (impl ``xla`` | ``pipeline`` (K5) |
                  ``active`` | ``active_fused``), ``run_ensemble`` and its
                  launch/complete halves;
- ``scheduler`` — the scenario queue (pad to bucket, max-wait/max-batch
                  flushes, runner-cache counters, solo retry and quarantine,
                  deadlines; a kernel's error reaches its tickets, with no
                  degradation ladder);
- ``service``   — the synchronous ``EnsembleService``.

The async service, ``run_soak``, the mesh-sharded ensemble, the fleet,
journal, wire and tiering layers are not ported yet (ROADMAP.md).
"""

from .batch import (EnsembleConservationError, EnsembleExecutor,
                    EnsembleInFlight, EnsembleSpace, complete_ensemble,
                    launch_ensemble, run_ensemble, structure_key)
from .scheduler import (DEFAULT_BUCKETS, DispatchTimeout, EnsembleScheduler,
                        TicketExpired, buckets_for)
from .service import EnsembleService

__all__ = [
    "DEFAULT_BUCKETS",
    "DispatchTimeout",
    "EnsembleConservationError",
    "EnsembleExecutor",
    "EnsembleInFlight",
    "EnsembleScheduler",
    "EnsembleService",
    "EnsembleSpace",
    "TicketExpired",
    "buckets_for",
    "complete_ensemble",
    "launch_ensemble",
    "run_ensemble",
    "structure_key",
]
