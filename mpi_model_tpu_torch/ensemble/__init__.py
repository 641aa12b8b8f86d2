"""Ensemble engine: many independent scenarios stepped together, behind a
bucketed scheduler (counterpart of ``mpi_model_tpu/ensemble/``).

- ``batch``     — ``EnsembleSpace`` (``[B, H, W]`` channels), the batched
                  parametric step, per-scenario conservation,
                  ``EnsembleExecutor`` (impl ``xla`` | ``pipeline`` (K5) |
                  ``active`` | ``active_fused``), ``run_ensemble`` and its
                  launch/complete halves;
- ``scheduler`` — the scenario queue (pad to bucket, max-wait/max-batch
                  flushes, runner-cache counters, solo retry and quarantine,
                  deadlines, migration of a queued ticket to another
                  scheduler, the degradation ladder ``pipeline`` → ``xla``,
                  ``active_fused`` → ``active`` → ``xla``);
- ``service``   — the synchronous ``EnsembleService``, the always-on
                  ``AsyncEnsembleService`` (a pump thread launching batch i
                  before finishing batch i-1, bounded admission with
                  ``ServiceOverloaded``, windowed and donated dispatch) and
                  ``run_soak``, open-loop arrivals against a service;
- ``lifecycle`` — the declared ticket-lifecycle machines (``FLEET``,
                  ``TIERING``) and the record-kind constants;
- ``journal``   — the append-only CRC'd ticket journal (TJ1), its replay and
                  audit (``python -m mpi_model_tpu_torch.ensemble.journal
                  <dir>``);
- ``wire``      — the TW1 frame codec, ``FrameConn`` and the HMAC handshake
                  over TCP.

The mesh-sharded ensemble, the fleet's runtime (members, the supervisor)
and tiering are not ported yet (ROADMAP.md).
"""

from .batch import (EnsembleConservationError, EnsembleExecutor,
                    EnsembleInFlight, EnsembleSpace, complete_ensemble,
                    launch_ensemble, run_ensemble, structure_key)
from .journal import TicketJournal
from .scheduler import (DEFAULT_BUCKETS, DispatchTimeout, EnsembleScheduler,
                        TicketExpired, TicketNotMigratable, buckets_for)
from .service import (AsyncEnsembleService, EnsembleService,
                      ServiceOverloaded, run_soak)
from .wire import FrameConn, RemoteError, WireClosed, WireError, WireTimeout

__all__ = [
    "AsyncEnsembleService",
    "DEFAULT_BUCKETS",
    "DispatchTimeout",
    "EnsembleConservationError",
    "EnsembleExecutor",
    "EnsembleInFlight",
    "EnsembleScheduler",
    "EnsembleService",
    "EnsembleSpace",
    "FrameConn",
    "RemoteError",
    "ServiceOverloaded",
    "TicketExpired",
    "TicketJournal",
    "TicketNotMigratable",
    "WireClosed",
    "WireError",
    "WireTimeout",
    "buckets_for",
    "complete_ensemble",
    "launch_ensemble",
    "run_ensemble",
    "run_soak",
    "structure_key",
]
