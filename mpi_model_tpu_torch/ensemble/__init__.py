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
                  over TCP;
- ``tiering``   — scenario hibernate/wake paging through the delta stream:
                  ``ScenarioTiering``, ``HibernationError``,
                  ``scenario_nbytes``;
- ``member_proc`` — a member behind the wire: ``MemberServer``,
                  ``ProcessMemberClient``, ``spawn_process_member`` (a child
                  over a unix socket or authenticated TCP),
                  ``spawn_loopback_member`` and the child's ``main``;
- ``fleet``     — ``FleetSupervisor`` (N members behind one service surface:
                  structure-affine routing, autoscaling, fencing and respawn,
                  crash-restart recovery from the journal, the supervisor
                  lease and epoch, scenario tiering), ``StandbySupervisor``.

The mesh-sharded ensemble is not ported yet (ROADMAP.md).
"""

from .batch import (EnsembleConservationError, EnsembleExecutor,
                    EnsembleInFlight, EnsembleSpace, complete_ensemble,
                    launch_ensemble, run_ensemble, structure_key)
from .fleet import (AutoscalePolicy, FleetSupervisor, MemberFailure,
                    StandbySupervisor, lease_path, read_lease)
from .journal import TicketJournal
from .scheduler import (DEFAULT_BUCKETS, DispatchTimeout, EnsembleScheduler,
                        TicketExpired, TicketNotMigratable, buckets_for)
from .service import (AsyncEnsembleService, EnsembleService,
                      ServiceOverloaded, run_soak)
from .tiering import HibernationError, ScenarioTiering, scenario_nbytes
from .wire import FrameConn, RemoteError, WireClosed, WireError, WireTimeout

__all__ = [
    "AsyncEnsembleService",
    "AutoscalePolicy",
    "DEFAULT_BUCKETS",
    "DispatchTimeout",
    "EnsembleConservationError",
    "EnsembleExecutor",
    "EnsembleInFlight",
    "EnsembleScheduler",
    "EnsembleService",
    "EnsembleSpace",
    "FleetSupervisor",
    "FrameConn",
    "HibernationError",
    "MemberFailure",
    "RemoteError",
    "ScenarioTiering",
    "ServiceOverloaded",
    "StandbySupervisor",
    "TicketExpired",
    "TicketJournal",
    "TicketNotMigratable",
    "WireClosed",
    "WireError",
    "WireTimeout",
    "buckets_for",
    "complete_ensemble",
    "launch_ensemble",
    "lease_path",
    "read_lease",
    "run_ensemble",
    "run_soak",
    "scenario_nbytes",
    "structure_key",
]
