"""Fleet members behind the wire (counterpart of
``mpi_model_tpu/ensemble/member_proc.py``).

- :class:`MemberServer`: the worker side, one ``AsyncEnsembleService``
  behind a :class:`~.wire.FrameConn`, answering the whole request
  vocabulary (``wire.REQUEST_KINDS``: submit, poll, migrate, queued, pump,
  drain, dispatch_log, heartbeat, shutdown; a member's stats ride the
  heartbeat's telemetry cut). Scenario state and
  model recipes cross as the payloads the ticket journal writes (TJ1's
  codec: every array CRC-checked, bf16 as its raw bytes named
  "bfloat16"). A request stamped with a supervisor epoch ratchets the
  member's high-water mark; a frame from an older epoch gets a typed
  ``StaleEpochError`` reply (the member-side half of the journal's fence).
- :func:`main`: the spawned process's entry point (``python -m
  mpi_model_tpu_torch.ensemble.member_proc --connect <sock> --config
  <json>``). It builds its model from the journal recipe and its service
  from the JSON config, on the config's device (the card unless it names
  the CPU; a child asked for the card that finds none fails through
  ``resolve_device`` before it connects, and the spawn fails loudly),
  creates its CUDA context and loads the kernels of its impl from the
  build directory (``compile_cache`` in the config, ``"auto"`` by default:
  the package's ``_build/``, which the parent filled), and only then dials
  back, so neither holds its GIL past its first heartbeat. The child is a fresh interpreter
  (``subprocess.Popen`` of ``sys.executable``), never a ``fork`` of a
  parent that holds a CUDA context; the environment the spawner lays over
  it (``member_env``: ``CUDA_VISIBLE_DEVICES`` pins its card) is read when
  it first touches CUDA. Several children may share one card, each with
  its own context.
- :class:`ProcessMemberClient`: the supervisor side. It duck-types the
  member surface the fleet drives (``submit``, ``poll``, ``pump_once``,
  ``stop``, ``abandon``, ``stats``, ``is_alive``, ``has_work_due`` and a
  ``scheduler`` proxy), so routing, autoscaling, drain-before-retire,
  fencing and recovery run unchanged. Liveness is heartbeat freshness on
  the injectable clock: each beat ships back one telemetry cut (counters,
  ladder state, the member process's kernel launch counts and kernel
  builds, its device set, its completed spans), and a member whose last good beat is older than
  ``heartbeat_deadline_s`` is fenced.
- :func:`spawn_process_member` (a real child over a unix socket, or with
  ``transport="tcp"`` over an authenticated TCP socket: the spawner listens
  on ``host:<ephemeral>``, a fresh ``secrets.token_hex(32)`` reaches the
  child in its environment only, under ``wire.SECRET_ENV``, and the
  accepted connection must pass the TWA1 HMAC handshake before the first
  frame; a failed handshake kills the child and raises) and
  :func:`spawn_loopback_member` (a real ``MemberServer`` on a thread over a
  ``socketpair``: the same codec, framing, chaos seams and client path
  with no subprocess).

Every RPC carries a deadline; a torn frame, a CRC failure, EOF or a missed
deadline raises the wire's typed errors, and the fleet counts it as a
member fault (fence, respawn, recover), never as a ticket's outcome. The
``proc_kill`` seam (a real ``SIGKILL`` of a child; the loopback hard-stops
its serve thread) and ``heartbeat_loss`` fire on the client, at the
``wire`` site.

A received state lands on the member's ``device`` (the server's, or the
client's for results), as ``resolve_device`` names it: the card unless the
caller asks for the CPU.

A ``mesh`` member kwarg crosses the wire as its ``[batch, space]``
extents, and the child builds the mesh over its own devices (its config's
device: the visible cards, or the CPU at every position).
"""

from __future__ import annotations

import json
import os
import signal
import socket as _socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import torch

from ..core.cellular_space import CellularSpace, resolve_device
from ..obs import jsonable as _jsonable
from ..resilience import inject
from ..utils.tracing import TraceContext, get_tracer
from .journal import model_from_meta, model_meta, space_payload
from .scheduler import (EnsembleScheduler, TicketExpired,
                        TicketNotMigratable)
from .service import AsyncEnsembleService, ServiceOverloaded
from .wire import (SECRET_ENV, TRACE_META_KEY, FrameConn, HandshakeError,
                   RemoteError, WireError, client_handshake, serve_handshake,
                   tcp_dial, tcp_listener)

__all__ = [
    "MemberServer",
    "ProcessMemberClient",
    "resolve_deadlines",
    "spawn_process_member",
    "spawn_loopback_member",
    "main",
]

#: member kwargs that may cross the process boundary (the JAX package's
#: set: plain data; ``clock`` is dropped, since a child runs wall time, and
#: ``compute_dtype`` crosses as its name)
SPAWNABLE_KWARGS = frozenset((
    "steps", "impl", "substeps", "buckets", "max_wait_s", "max_batch",
    "compute_dtype", "check_conservation", "tolerance", "rtol", "retry",
    "dispatch_deadline_s", "degrade_after", "retry_budget", "windows",
    "donate", "max_queue", "deadline_s", "poll_interval_s",
    "compile_cache", "mesh",
))

#: how long the spawner waits for the child to import torch, build its
#: service, load its kernels and connect back (the JAX package's bound; a
#: child that exits first fails the spawn at once)
SPAWN_CONNECT_TIMEOUT_S = 180.0

#: the kernel libraries a member of each impl launches, loaded before the
#: child dials back (``ops._build`` names)
IMPL_KERNELS = {"pipeline": ("pipeline_stencil",),
                "active_fused": ("fused_active",)}


def _space_from_payload(meta: dict, arrays: Optional[dict],
                        device) -> CellularSpace:
    if arrays is None:
        raise WireError("scenario payload carries no state arrays")
    vals = {k: a.to(device) for k, a in arrays.items()}
    return CellularSpace(vals, meta["dim_x"], meta["dim_y"])


def _report_meta(report) -> dict:
    return {
        "comm_size": report.comm_size, "rank_id": report.rank_id,
        "steps": report.steps,
        "initial_total": _jsonable(dict(report.initial_total)),
        "final_total": _jsonable(dict(report.final_total)),
        "wall_time_s": float(report.wall_time_s),
        "backend_report": _jsonable(report.backend_report),
        "impl": report.impl,
    }


def _report_from_meta(m: dict):
    from ..models.model import Report

    return Report(
        comm_size=m.get("comm_size", 1), rank_id=m.get("rank_id", 0),
        steps=m.get("steps", 0),
        initial_total=m.get("initial_total", {}),
        final_total=m.get("final_total", {}), last_execute=[],
        wall_time_s=m.get("wall_time_s", 0.0),
        backend_report=m.get("backend_report"), impl=m.get("impl"))


_BACKEND_DEVICES: Optional[dict] = None


def _backend_devices() -> dict:
    """This process's visible device set, as torch sees it: what the
    ``member_env`` pin (``CUDA_VISIBLE_DEVICES``) is checked against. The
    platform is ``"gpu"`` when a card is visible, else ``"cpu"``. Computed
    once: a process's device set is fixed once CUDA is initialised."""
    global _BACKEND_DEVICES
    if _BACKEND_DEVICES is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _BACKEND_DEVICES = {
            "platform": "gpu" if n else "cpu",
            "device_count": n if n else 1,
            "devices": ([torch.cuda.get_device_name(i) for i in range(n)]
                        if n else ["cpu"]),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        }
    return _BACKEND_DEVICES


def _rss_bytes() -> Optional[int]:
    """Resident set size of this process: ``/proc`` on Linux, the
    ``getrusage`` peak as the fallback."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError, ValueError):
            return None


def _kernel_launches() -> dict:
    from ..models.model import kernel_launches

    return kernel_launches()


def _kernel_builds() -> dict:
    """This process's kernel libraries: seconds to build or load each, and
    whether it came from the build directory (``cached``) or ran nvcc."""
    from ..ops import _build

    return {k: {"seconds": v["seconds"], "cached": v["cached"]}
            for k, v in _build.build_info.items()}


#: the raw counter fields telemetry carries (the fleet's absorb and
#: progress-signature set plus ``shed``; ``snapshot()`` derives the rest)
TELEMETRY_COUNTERS = ("dispatches", "scenarios", "lanes", "cache_hits",
                      "solo_retries", "recovered_failures", "quarantined",
                      "impl_faults", "expired", "loop_faults", "shed",
                      "busy_s", "inflight_s")


# -- the worker side ----------------------------------------------------------

class MemberServer:
    """One member service behind one wire connection: a strict request →
    reply loop on the serve thread. The service pumps itself
    (``pump="thread"``) or is pumped over the wire (``pump="rpc"``, the
    deterministic mode of manual fleets).

    A ``member_kill`` fault raised inside a pumped iteration marks the pump
    dead (the reply says so, and the client raises it for the fleet) while
    the server keeps answering poll and stats: a dead pump thread is not a
    dead process. A wire failure on the serve connection ends the loop.
    Received states land on ``device`` (the card unless it names another).
    """

    def __init__(self, service: AsyncEnsembleService, conn: FrameConn,
                 pump: str = "thread", ship_spans: bool = True,
                 device=None):
        if pump not in ("thread", "rpc"):
            raise ValueError(f"unknown pump mode {pump!r}")
        self.service = service
        self.conn = conn
        self.pump = pump
        self.device = resolve_device(device)
        #: ship completed-span deltas on heartbeats; the loopback turns it
        #: off (its spans are already in the supervisor's tracer)
        self.ship_spans = bool(ship_spans)
        # a leaf lock: the flags below are poked by the loopback kill path
        # from another thread; nothing is acquired under it
        self._lock = threading.Lock()
        self._pump_dead = False
        self._stopping = False
        #: highest supervisor epoch seen on any request frame
        self._epoch = 0
        #: True only when the supervisor's shutdown RPC ended serving
        self.clean_shutdown = False
        #: telemetry stats cache: (state signature) -> jsonable stats, so an
        #: idle member's heartbeats skip the reservoir sort and re-encode
        self._stats_key = None
        self._stats_cached: dict = {}
        #: span-delta cursor: each beat ships the spans since the last one
        self._span_cursor = 0

    def hard_stop(self) -> None:
        """The loopback stand-in for ``SIGKILL``: the serve connection
        closes under the loop (in-flight and later RPCs fail with the
        wire's typed errors) and the member's pump is abandoned, as a
        killed child loses every thread."""
        with self._lock:
            self._stopping = True
        self.conn.close()
        self.service.abandon()

    def serve_forever(self) -> None:
        # the connection always closes on the way out, so a peer blocked
        # on it sees EOF at once
        try:
            while True:
                try:
                    kind, meta, arrays = self.conn.recv(deadline_s=None)
                except WireError:
                    return
                try:
                    done = self._handle(kind, meta, arrays)
                except WireError:
                    return
                if done:
                    return
        finally:
            self.conn.close()

    #: reply-send bound: a supervisor that stopped reading fences this
    #: member instead of wedging the loop on a full socket buffer
    REPLY_DEADLINE_S = 60.0

    def _reply(self, kind: str, meta: Optional[dict] = None,
               arrays: Optional[dict] = None) -> None:
        self.conn.send(kind, meta, arrays,
                       deadline_s=self.REPLY_DEADLINE_S)

    def _handle(self, kind: str, meta: dict, arrays) -> bool:
        frame_epoch = meta.get("epoch")
        if frame_epoch is not None:
            with self._lock:
                if frame_epoch < self._epoch:
                    stale = self._epoch
                else:
                    stale = None
                    self._epoch = frame_epoch
            if stale is not None:
                self._reply("err", {
                    "error": "StaleEpochError",
                    "detail": f"frame epoch {frame_epoch} < member's "
                              f"fenced epoch {stale} (a newer "
                              "supervisor owns this member)"})
                return False
        try:
            if kind == "submit":
                return self._handle_submit(meta, arrays)
            if kind == "poll":
                return self._handle_poll(meta)
            if kind == "migrate":
                return self._handle_migrate(meta)
            if kind == "queued":
                self._reply("ok", {
                    "tickets": self.service.scheduler.queued_tickets()})
                return False
            if kind == "pump":
                return self._handle_pump(meta)
            if kind == "drain":
                try:
                    self.service.stop()
                except inject.MemberKilled:
                    with self._lock:
                        self._pump_dead = True
                self._reply("ok", {})
                return False
            if kind == "dispatch_log":
                self._reply("ok", {"entries": _jsonable(
                    list(self.service.scheduler.dispatch_log))})
                return False
            if kind == "heartbeat":
                self._reply("ok", {"telemetry": self._telemetry()})
                return False
            if kind == "shutdown":
                if meta.get("mode") == "abandon":
                    self.service.abandon()
                else:
                    self.service.stop()
                with self._lock:
                    self.clean_shutdown = True
                self._reply("ok", {})
                return True
            self._reply("err", {"error": "ValueError",
                                "detail": f"unknown RPC {kind!r}"})
            return False
        # analysis: ignore[broad-except] — the RPC supervisor: any handler
        # failure must become a typed err reply the supervisor reconstructs,
        # never a dead serve loop
        # the RPC supervisor: a handler's failure becomes a typed "err"
        # reply, never a dead serve loop (a broken reply connection raises
        # out of the send itself and ends serving)
        except Exception as e:
            self._reply("err", self._err_meta(e))
            return False

    @staticmethod
    def _err_meta(e: Exception) -> dict:
        return {"error": getattr(e, "remote_type", type(e).__name__),
                "detail": str(e)}

    def _handle_submit(self, meta: dict, arrays) -> bool:
        space = _space_from_payload(meta, arrays, self.device)
        model = model_from_meta(meta.get("model"), self.service.model)
        steps = meta.get("steps")
        # the frame's trace context parents this member's dispatch spans
        # under the fleet's submit span
        ctx = TraceContext.from_meta(meta.get(TRACE_META_KEY))
        if meta.get("bypass"):
            # the fleet's re-admission and migration: a scheduler-level
            # submit with no admission bound (an admitted ticket is never
            # shed by its rescue)
            sched = self.service.scheduler
            with get_tracer().attach(ctx):
                ticket = sched.submit(space, model, steps)
            if meta.get("migrated"):
                with sched._lock:
                    sched.migrated_in += 1
            self._reply("ok", {"ticket": ticket})
            return False
        try:
            with get_tracer().attach(ctx):
                ticket = self.service.submit(space, model=model,
                                             steps=steps)
        except ServiceOverloaded as e:
            self._reply("overloaded", {
                "detail": str(e), "queue_depth": e.queue_depth,
                "retry_after_s": e.retry_after_s})
            return False
        self._reply("ok", {"ticket": ticket})
        return False

    def _handle_poll(self, meta: dict) -> bool:
        try:
            res = self.service.poll(meta["ticket"])
        except KeyError as e:
            self._reply("err", {"error": "KeyError", "detail": str(e)})
            return False
        # analysis: ignore[broad-except] — the harvest seam crosses the wire
        # here: every per-ticket resolution error must become a typed reply the
        # supervisor journals, never a dead serve loop
        # the harvest seam crosses the wire here: every per-ticket
        # resolution error becomes a typed reply the supervisor journals
        except Exception as e:
            body = self._err_meta(e)
            if isinstance(e, TicketExpired):
                body["expired"] = True
            t = getattr(e, "ticket", None)
            if t is not None:
                body["ticket"] = t
            self._reply("err", body)
            return False
        if res is None:
            self._reply("pending", {})
            return False
        space, report = res
        s_meta, s_arrays = space_payload(space)
        s_meta["report"] = _report_meta(report)
        self._reply("ok", s_meta, s_arrays)
        return False

    def _handle_migrate(self, meta: dict) -> bool:
        sched = self.service.scheduler
        try:
            space, model, steps = sched.extract_ticket(meta["ticket"])
        except (TicketNotMigratable, KeyError) as e:
            self._reply("err", self._err_meta(e))
            return False
        recipe = model_meta(model)
        if recipe is None:  # pragma: no cover - every model here came as one
            sched.submit(space, model, steps)
            self._reply("err", {
                "error": "TicketNotMigratable",
                "detail": "scenario model has no wire recipe"})
            return False
        with sched._lock:
            sched.dispatch_log.append({
                "migrated_ticket": meta["ticket"], "to_ticket": "remote",
                "steps": steps})
        s_meta, s_arrays = space_payload(space)
        s_meta.update({"steps": steps, "model": recipe})
        self._reply("ok", s_meta, s_arrays)
        return False

    def _handle_pump(self, meta: dict) -> bool:
        if self.pump == "thread":
            self._reply("ok", {"did": False})
            return False
        with self._lock:
            dead = self._pump_dead
        if dead:
            self._reply("ok", {"did": False, "killed": True})
            return False
        try:
            did = self.service.pump_once(force=bool(meta.get("force")))
        except inject.MemberKilled:
            # the pump died; this serve loop lives on (poll and stats still
            # answer), and the fleet fences on the client's re-raise
            with self._lock:
                self._pump_dead = True
            self._reply("ok", {"did": True, "killed": True})
            return False
        # analysis: ignore[broad-except] — the manual-mode pump supervisor
        # (mirrors AsyncEnsembleService._loop across the wire): a pump fault is
        # counted member-side and survived
        # the manual-mode pump supervisor (AsyncEnsembleService._loop's,
        # across the wire): a pump fault is counted and survived
        except Exception:
            self.service.scheduler.counter.bump("loop_faults")
            self._reply("ok", {"did": True})
            return False
        self._reply("ok", {"did": bool(did)})
        return False

    def _telemetry(self) -> dict:
        svc = self.service
        sched = svc.scheduler
        with self._lock:
            pump_dead = self._pump_dead
        alive = (svc.is_alive() if self.pump == "thread"
                 else not pump_dead)
        c = sched.counter
        counters = {k: getattr(c, k) for k in TELEMETRY_COUNTERS}
        pending = sched.pending_count()
        gated = sched.intake_gated
        degraded = sched.degraded_from
        # the full stats cut is recomputed only when the cheap state
        # signature moved
        key = (tuple(sorted(counters.items())), pending, gated,
               degraded, alive)
        with self._lock:
            if key != self._stats_key:
                self._stats_cached = _jsonable(svc.stats())
                self._stats_key = key
            stats = self._stats_cached
            cursor = self._span_cursor
        # completed-span deltas ride the same cut, outside the stats cache
        # (new spans need not move the signature, and a cached cut must
        # never ship a delta twice)
        spans: list = []
        if self.ship_spans:
            new_cursor, spans = get_tracer().spans_since(cursor)
            spans = _jsonable(spans)
            with self._lock:
                self._span_cursor = new_cursor
        return {
            "pending": pending,
            "due": svc.has_work_due(),
            "alive": alive,
            "intake_gated": gated,
            "degraded_from": degraded,
            "impl": sched.executor.impl,
            "counters": counters,
            "kernel_launches": _kernel_launches(),
            "kernel_builds": _kernel_builds(),
            "rss_bytes": _rss_bytes(),
            "backend": _backend_devices(),
            "device": str(self.device),
            "pid": os.getpid(),
            "stats": stats,
            "spans": spans,
        }


# -- the supervisor side ------------------------------------------------------

class _RemoteCounter:
    """Attribute view over the member's last-heartbeat counters, plus a
    local overlay for the counts the fleet attributes to a member from its
    own side (supervised pump faults in manual mode)."""

    def __init__(self, client: "ProcessMemberClient"):
        self._client = client
        self._extra: dict = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._client._lock:
            self._extra[name] = self._extra.get(name, 0) + int(n)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        c = self._client
        with c._lock:
            counters = c._telemetry.get("counters", {})
            extra = self._extra.get(name, 0)
        if name in counters:
            return counters[name] + extra
        if name in TELEMETRY_COUNTERS or extra:
            return extra
        raise AttributeError(name)


class _RemoteExecutor:
    def __init__(self, client: "ProcessMemberClient"):
        self._client = client

    @property
    def impl(self) -> Optional[str]:
        with self._client._lock:
            return self._client._telemetry.get("impl")


class _RemoteScheduler:
    """The scheduler surface the fleet touches, over the wire: the cheap
    reads (depth, ladder state, counters) come from the cached heartbeat
    telemetry (one member-consistent cut a supervision tick), the mutating
    calls (queued, migrate, submit) are RPCs."""

    DEGRADE_TO = EnsembleScheduler.DEGRADE_TO

    def __init__(self, client: "ProcessMemberClient"):
        self._client = client
        self.counter = _RemoteCounter(client)
        self.executor = _RemoteExecutor(client)

    def pending_count(self) -> int:
        with self._client._lock:
            return int(self._client._telemetry.get("pending", 0))

    @property
    def intake_gated(self) -> bool:
        with self._client._lock:
            return bool(self._client._telemetry.get("intake_gated", False))

    @property
    def degraded_from(self) -> Optional[str]:
        with self._client._lock:
            return self._client._telemetry.get("degraded_from")

    @property
    def dispatch_log(self) -> list:
        _, meta, _ = self._client._rpc("dispatch_log")
        return meta.get("entries", [])

    def queued_tickets(self) -> list:
        kind, meta, _ = self._client._rpc("queued")
        return list(meta.get("tickets", []))

    def migrate_ticket(self, ticket: int, target: "_RemoteScheduler"
                       ) -> int:
        """Live migration over the wire: the source member drains the queued
        scenario through ``EnsembleScheduler.extract_ticket``, the payload
        crosses CRC-checked twice (source → supervisor → target), and the
        target resubmits it scheduler-level."""
        kind, meta, arrays = self._client._rpc("migrate",
                                               {"ticket": ticket})
        if kind == "err":
            _raise_remote(meta)
        return target.submit_payload(
            # analysis: ignore[rpc-asymmetry] — the migrate reply meta IS a
            # space payload: dim_x/dim_y are stamped by the payload codec
            # (journal.space_payload), a vocabulary the server-side literal
            # scan cannot see
            {"dim_x": meta["dim_x"], "dim_y": meta["dim_y"],
             "steps": meta["steps"], "model": meta["model"],
             "migrated": True},
            arrays)

    def submit(self, space: CellularSpace, model, steps: int) -> int:
        """The fleet's re-admission path (no admission bound, as the
        in-process scheduler-level submit)."""
        meta, arrays = self._client._scenario_payload(space, model, steps)
        return self.submit_payload(meta, arrays)

    def submit_payload(self, meta: dict, arrays) -> int:
        body = dict(meta)
        body["bypass"] = True
        kind, r_meta, _ = self._client._rpc("submit", body, arrays)
        if kind == "err":
            _raise_remote(r_meta)
        return int(r_meta["ticket"])


def _raise_remote(meta: dict) -> None:
    """A member-side error on the supervisor side: the ticket-policy types
    the fleet dispatches on come back as themselves; anything else is a
    :class:`~.wire.RemoteError` whose ``remote_type`` keeps the original
    class name for the journal and the ledger."""
    et = meta.get("error", "RuntimeError")
    detail = meta.get("detail", "")
    if et == "KeyError":
        raise KeyError(detail)
    if et == "TicketExpired" or meta.get("expired"):
        e: Exception = TicketExpired(detail)
    elif et == "TicketNotMigratable":
        e = TicketNotMigratable(detail)
    else:
        e = RemoteError(et, detail)
    if "ticket" in meta:
        e.ticket = meta["ticket"]
    raise e


class ProcessMemberClient:
    """The supervisor's handle on one member behind the wire (module
    docstring). Every transport use is serialized under one internal lock,
    a leaf: nothing else is acquired under it (a plain ``threading.RLock``,
    unseen by the lockdep witness, as in the JAX package). Every RPC checks
    the ``proc_kill`` seam and counts against the ``wire`` site's index.
    Results land on ``device`` (the card unless it names another)."""

    def __init__(self, conn: FrameConn, service_id: str, *,
                 clock: Callable[[], float] = time.monotonic,
                 heartbeat_deadline_s: float = 2.0,
                 rpc_deadline_s: float = 30.0,
                 proc: Optional[subprocess.Popen] = None,
                 server: Optional[MemberServer] = None,
                 server_thread: Optional[threading.Thread] = None,
                 spawn_dir: Optional[str] = None,
                 device=None):
        self.service_id = service_id
        self.model = None  # the member holds the template
        self.device = resolve_device(device)
        self._conn = conn
        self._clock = clock
        self._hb_deadline = float(heartbeat_deadline_s)
        self._rpc_deadline = float(rpc_deadline_s)
        self._proc = proc
        self._server = server
        self._server_thread = server_thread
        self._spawn_dir = spawn_dir
        self._lock = threading.RLock()
        self._telemetry: dict = {}
        self._last_beat = clock()
        self._killed = False
        #: the supervisor epoch stamped into every request frame when set
        #: (the fleet arms it from its journal epoch)
        self.epoch: Optional[int] = None
        #: wall seconds of the TCP spawn's handshake (None on the other
        #: transports)
        self.handshake_s: Optional[float] = None
        self.scheduler = _RemoteScheduler(self)
        # the first beat fills the telemetry before the first tick
        self.heartbeat()

    # -- transport -----------------------------------------------------------

    def _rpc(self, kind: str, meta: Optional[dict] = None, arrays=None,
             deadline_s: Optional[float] = None
             ) -> tuple[str, dict, Optional[dict]]:
        st = inject.active()
        if st is not None:
            f = st.member_fault(self.service_id, ("proc_kill",),
                                site="wire", count=True)
            if f is not None:
                self.kill()
        with self._lock:
            deadline = (self._rpc_deadline if deadline_s is None
                        else deadline_s)
            if self.epoch is not None:
                meta = dict(meta or {})
                meta.setdefault("epoch", self.epoch)
            self._conn.send(kind, meta, arrays, deadline_s=deadline)
            return self._conn.recv(deadline_s=deadline)

    @property
    def wire_bytes_in(self) -> int:
        return self._conn.bytes_in

    @property
    def wire_bytes_out(self) -> int:
        return self._conn.bytes_out

    # -- the member surface (duck-typed AsyncEnsembleService) ----------------

    def _scenario_payload(self, space: CellularSpace, model,
                          steps: Optional[int]) -> tuple[dict, dict]:
        meta, arrays = space_payload(space)
        # the caller's trace context crosses in the frame meta
        ctx = get_tracer().current()
        if ctx is not None:
            meta[TRACE_META_KEY] = ctx.to_meta()
        if model is not None:
            recipe = model_meta(model)
            if recipe is None:
                raise ValueError(
                    "this scenario's model has no wire recipe "
                    "(non-scalar flow fields): a process-transport "
                    "fleet can only serve models model_meta() can "
                    "serialize")
            meta["model"] = recipe
        if steps is not None:
            meta["steps"] = int(steps)
        return meta, arrays

    def submit(self, space: CellularSpace, *, model=None,
               steps: Optional[int] = None) -> int:
        meta, arrays = self._scenario_payload(space, model, steps)
        kind, r_meta, _ = self._rpc("submit", meta, arrays)
        if kind == "overloaded":
            raise ServiceOverloaded(
                r_meta.get("detail", "member admission shed"),
                queue_depth=r_meta.get("queue_depth", 0),
                retry_after_s=r_meta.get("retry_after_s", 0.0))
        if kind == "err":
            _raise_remote(r_meta)
        return int(r_meta["ticket"])

    def poll(self, ticket: int):
        kind, meta, arrays = self._rpc("poll", {"ticket": ticket})
        if kind == "pending":
            return None
        if kind == "err":
            _raise_remote(meta)
        space = _space_from_payload(meta, arrays, self.device)
        return space, _report_from_meta(meta.get("report", {}))

    def pump_once(self, force: bool = False) -> bool:
        kind, meta, _ = self._rpc("pump", {"force": bool(force)})
        if meta.get("killed"):
            raise inject.MemberKilled(
                f"member {self.service_id} pump died across the wire")
        return bool(meta.get("did"))

    def heartbeat(self) -> bool:
        """One liveness beat: the telemetry cut comes back and the clock is
        stamped. False (a miss) on any wire failure or an armed
        ``heartbeat_loss``; ``is_alive`` ages the stamp against the
        heartbeat deadline."""
        st = inject.active()
        if st is not None:
            f = st.member_fault(self.service_id, ("proc_kill",),
                                site="wire", count=True)
            if f is not None:
                self.kill()
            if st.member_fault(self.service_id, ("heartbeat_loss",),
                               site="wire") is not None:
                return False
        try:
            with self._lock:
                beat_meta = ({} if self.epoch is None
                             else {"epoch": self.epoch})
                self._conn.send("heartbeat", beat_meta,
                                deadline_s=self._rpc_deadline)
                kind, meta, _ = self._conn.recv(
                    deadline_s=self._rpc_deadline)
        except WireError:
            return False
        if kind != "ok":
            return False
        telemetry = meta.get("telemetry", {})
        with self._lock:
            self._telemetry = telemetry
            self._last_beat = self._clock()
        # the member's completed spans join the supervisor's tracer
        # (ingest skips this process's own spans: a loopback member's)
        spans = telemetry.get("spans")
        if spans:
            get_tracer().ingest(spans, label=self.service_id)
        return True

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        """Seconds since the last good beat, at ``now`` (default: the
        clock's present)."""
        with self._lock:
            return (self._clock() if now is None else now) - self._last_beat

    def is_alive(self, now: Optional[float] = None) -> bool:
        """Heartbeat freshness on the injectable clock, read at ``now``
        (default: the clock's present), and the last telemetry's own
        pump-alive flag."""
        with self._lock:
            if self._killed:
                return False
            fresh = self.heartbeat_age(now) <= self._hb_deadline
            return fresh and bool(self._telemetry.get("alive", True))

    def has_work_due(self) -> bool:
        with self._lock:
            return bool(self._telemetry.get("due", False))

    def telemetry(self) -> dict:
        """The member's last-heartbeat telemetry cut (no RPC):
        ``["backend"]`` is the child's own device set,
        ``["kernel_launches"]`` its process's kernel launch counts."""
        with self._lock:
            return dict(self._telemetry)

    def stats(self) -> dict:
        """The member's last-heartbeat stats cut plus the client-side wire
        observability; no RPC, so the fleet's ``stats()`` never blocks on a
        wire under its lock."""
        with self._lock:
            out = dict(self._telemetry.get("stats", {}))
            out.update({
                "transport": "process",
                "rss_bytes": self._telemetry.get("rss_bytes"),
                "member_pid": self._telemetry.get("pid"),
                "backend": self._telemetry.get("backend"),
                "kernel_launches": self._telemetry.get("kernel_launches"),
                "kernel_builds": self._telemetry.get("kernel_builds"),
                "heartbeat_age_s": self._clock() - self._last_beat,
                "wire_bytes_in": self._conn.bytes_in,
                "wire_bytes_out": self._conn.bytes_out,
            })
            return out

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        """Drain the member but keep the connection: the fleet's final tick
        still harvests over it. ``close()`` is the teardown."""
        try:
            self._rpc("drain", {}, deadline_s=600.0)
        except WireError:
            pass  # a member that died mid-stop is the fence's

    def abandon(self) -> None:
        """Exit now, the fencing path: a best-effort abandon RPC, then the
        connection closes and a child is SIGKILLed."""
        try:
            self._rpc("shutdown", {"mode": "abandon"}, deadline_s=2.0)
        except WireError:
            pass
        self.kill()

    def close(self) -> None:
        """Orderly teardown after the final harvest: the shutdown RPC, the
        connection closed, the child reaped (killed past its grace)."""
        try:
            self._rpc("shutdown", {"mode": "drain"}, deadline_s=60.0)
        except WireError:
            pass
        with self._lock:
            self._conn.close()
        self._reap(graceful=True)

    def kill(self) -> None:
        """A real ``kill -9`` of a child (the ``proc_kill`` seam and the
        fencing teardown); the loopback hard-stops its serve thread."""
        with self._lock:
            self._killed = True
            self._conn.close()
        if self._server is not None:
            self._server.hard_stop()
        self._reap(graceful=False)

    def _reap(self, graceful: bool) -> None:
        if self._proc is not None:
            try:
                if graceful:
                    self._proc.wait(timeout=30.0)
                else:
                    self._proc.kill()
                    self._proc.wait(timeout=30.0)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    self._proc.kill()
                    self._proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        if self._server_thread is not None:
            self._server_thread.join(timeout=30.0)
        with self._lock:
            spawn_dir, self._spawn_dir = self._spawn_dir, None
        if spawn_dir is not None:
            import shutil

            shutil.rmtree(spawn_dir, ignore_errors=True)


# -- spawners -----------------------------------------------------------------

def _encode_member_kwargs(member_kwargs: dict) -> dict:
    """The JSON member config that crosses exec: ``clock`` is dropped,
    ``compute_dtype`` crosses as its name, anything outside
    :data:`SPAWNABLE_KWARGS` is refused (a knob that silently failed to
    cross would make the child another service than the one configured)."""
    out = {}
    for k, v in member_kwargs.items():
        if k == "clock":
            continue
        if k not in SPAWNABLE_KWARGS:
            raise ValueError(
                f"member kwarg {k!r} cannot cross the process boundary "
                f"(spawnable: {sorted(SPAWNABLE_KWARGS)})")
        if k == "compute_dtype" and v is not None:
            v = str(v).removeprefix("torch.")
        elif k == "buckets":
            v = [int(b) for b in v]
        elif k == "mesh" and v is not None:
            # a mesh crosses as its (batch, space) extents: the child
            # rebuilds it over its own devices; device handles never cross
            if isinstance(v, int):
                v = [int(v), 1]
            elif hasattr(v, "batch") and hasattr(v, "space"):
                v = [int(v.batch), int(v.space)]
            else:
                b, s = v
                v = [int(b), int(s)]
        out[k] = v
    json.dumps(out)  # fail at spawn, not in the child's stderr
    return out


def _decode_member_kwargs(cfg: dict) -> dict:
    out = dict(cfg)
    if out.get("buckets") is not None:
        out["buckets"] = tuple(out["buckets"])
    if out.get("mesh") is not None:
        out["mesh"] = tuple(out["mesh"])
    return out


def resolve_deadlines(transport: str,
                      heartbeat_deadline_s: Optional[float],
                      rpc_deadline_s: Optional[float]
                      ) -> tuple[float, float]:
    """The per-transport deadline defaults: ``None`` is the transport's,
    2 s and 30 s on the local transports (unix socket, loopback, in-proc),
    ``wire.TCP_*`` on tcp; an explicit float wins."""
    from .wire import TCP_HEARTBEAT_DEADLINE_S, TCP_RPC_DEADLINE_S

    if heartbeat_deadline_s is None:
        heartbeat_deadline_s = (TCP_HEARTBEAT_DEADLINE_S
                                if transport == "tcp" else 2.0)
    if rpc_deadline_s is None:
        rpc_deadline_s = (TCP_RPC_DEADLINE_S if transport == "tcp"
                          else 30.0)
    return float(heartbeat_deadline_s), float(rpc_deadline_s)


def _accept_child(listener, proc: subprocess.Popen, service_id: str,
                  timeout_s: float) -> _socket.socket:
    """Wait for the child to connect back, up to ``timeout_s``; a child that
    exits first (a failed config, no card) fails the spawn at once, naming
    its exit code."""
    # analysis: ignore[naked-timer] — spawn deadline arithmetic (the connect-
    # back wall bound), not a measurement
    t_end = time.monotonic() + timeout_s
    while True:
        listener.settimeout(0.25)
        try:
            sock, _ = listener.accept()
            return sock
        except _socket.timeout:
            pass
        rc = proc.poll()
        if rc is not None:
            raise WireError(
                f"member {service_id} exited with code {rc} before it "
                "connected (its stderr names the cause)")
        # analysis: ignore[naked-timer] — the same spawn deadline's expiry
        # check
        if time.monotonic() >= t_end:
            proc.kill()
            proc.wait(timeout=10.0)
            raise WireError(
                f"member {service_id} did not connect within "
                f"{timeout_s}s of spawn")


def spawn_process_member(model, *, service_id: str, member_kwargs: dict,
                         clock: Callable[[], float] = time.monotonic,
                         transport: str = "unix",
                         host: str = "127.0.0.1",
                         heartbeat_deadline_s: Optional[float] = None,
                         rpc_deadline_s: Optional[float] = None,
                         member_env: Optional[dict] = None,
                         pump_mode: str = "thread",
                         python: Optional[str] = None,
                         device=None) -> ProcessMemberClient:
    """Spawn one member process and return its client.

    The child inherits this process's environment with ``member_env`` laid
    over it before exec (``CUDA_VISIBLE_DEVICES`` pins its card; the child
    reads it when it first touches CUDA). ``device`` is where the member
    serves (the card unless it names the CPU; a CUDA device crosses as its
    type, so the child serves on the first card its pin lets it see) and
    where the client places results. The child's build directory is
    ``member_kwargs["compile_cache"]`` (``"auto"`` by default: the
    package's ``_build/``, so it loads what this process built).

    ``transport="tcp"``: the spawner listens on ``host:<ephemeral>``, a
    fresh per-member secret crosses in the child's environment
    (``wire.SECRET_ENV``, never on the command line), and the accepted
    connection must pass the HMAC handshake before the first frame is
    parsed; a child that fails it is killed and the spawn raises
    ``HandshakeError``. The deadlines default per transport
    (:func:`resolve_deadlines`)."""
    if transport not in ("unix", "tcp"):
        raise ValueError(f"unknown member transport {transport!r} "
                         "(expected 'unix' or 'tcp')")
    dev = resolve_device(device)
    heartbeat_deadline_s, rpc_deadline_s = resolve_deadlines(
        transport, heartbeat_deadline_s, rpc_deadline_s)
    recipe = model_meta(model)
    if recipe is None:
        raise ValueError(
            "process-transport members need a wire recipe for the "
            "template model (model_meta returned None: non-scalar "
            "flow fields cannot cross a process boundary)")
    cfg = {
        "service_id": service_id,
        "model": recipe,
        "member_kwargs": _encode_member_kwargs(member_kwargs),
        "pump": pump_mode,
        "device": dev.type,
    }
    spawn_dir = tempfile.mkdtemp(prefix=f"mm-member-{service_id}-")
    cfg_path = os.path.join(spawn_dir, "config.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    secret = None
    if transport == "tcp":
        import secrets

        secret = secrets.token_hex(32)
        listener = tcp_listener(host, 0)
        addr = "%s:%d" % listener.getsockname()[:2]
    else:
        addr = os.path.join(spawn_dir, "sock")
        listener = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        listener.bind(addr)
        listener.listen(1)
    handshake_s = None
    try:
        env = dict(os.environ)
        env.update(member_env or {})
        if secret is not None:
            env[SECRET_ENV] = secret
        # the child imports this checkout's package, wherever it was
        # started from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        proc = subprocess.Popen(
            [python or sys.executable,
             # runpy warns that the package's own import already loaded
             # this module: harmless here, and noise in every child
             "-W", "ignore::RuntimeWarning:runpy", "-m",
             "mpi_model_tpu_torch.ensemble.member_proc",
             "--connect", addr, "--config", cfg_path],
            env=env)
        try:
            sock = _accept_child(listener, proc, service_id,
                                 SPAWN_CONNECT_TIMEOUT_S)
            if secret is not None:
                # analysis: ignore[naked-timer] — the handshake's wall
                # seconds are reported on the client (handshake_s) as one
                # number per spawn, not a serving-path timing
                # authenticate before any frame: a wrong-secret or wedged
                # peer is closed here and the spawn fails loudly
                t0 = time.perf_counter()
                try:
                    serve_handshake(sock, secret, chaos_id=service_id)
                except HandshakeError:
                    proc.kill()
                    proc.wait(timeout=10.0)
                    raise
                # analysis: ignore[naked-timer] — closes the handshake_s
                # measurement above
                handshake_s = time.perf_counter() - t0
        except WireError:
            import shutil

            shutil.rmtree(spawn_dir, ignore_errors=True)
            raise
    finally:
        listener.close()
    client = ProcessMemberClient(
        FrameConn(sock, chaos_id=service_id), service_id, clock=clock,
        heartbeat_deadline_s=heartbeat_deadline_s,
        rpc_deadline_s=rpc_deadline_s, proc=proc, spawn_dir=spawn_dir,
        device=dev)
    client.handshake_s = handshake_s
    return client


def spawn_loopback_member(model, *, service_id: str, member_kwargs: dict,
                          clock: Callable[[], float] = time.monotonic,
                          heartbeat_deadline_s: float = 2.0,
                          rpc_deadline_s: float = 30.0,
                          member_env: Optional[dict] = None,
                          pump_mode: str = "rpc",
                          device=None) -> ProcessMemberClient:
    """The in-memory transport: a real :class:`MemberServer` on a thread
    over a real ``socketpair``, with the codec, framing, chaos seams and
    client path of a child and no subprocess. The template model still
    crosses as its recipe (a model the process transport could not carry
    fails here too); the clock and the armed fault plan are shared with
    the member service. Server and client both place states on ``device``
    (the card unless it names another)."""
    dev = resolve_device(device)
    recipe = model_meta(model)
    if recipe is None:
        raise ValueError(
            "process-transport members need a wire recipe for the "
            "template model (model_meta returned None)")
    member_model = model_from_meta(recipe)
    kwargs = dict(member_kwargs)
    kwargs.setdefault("clock", clock)
    if kwargs.get("mesh") is not None:
        # the mesh crosses as a child's does: its extents, resolved over
        # the member's device
        from .mesh import resolve_ensemble_mesh

        extents = _encode_member_kwargs({"mesh": kwargs["mesh"]})["mesh"]
        kwargs["mesh"] = resolve_ensemble_mesh(tuple(extents), device=dev)
    c_sock, s_sock = _socket.socketpair()
    service = AsyncEnsembleService(
        member_model, start=(pump_mode == "thread"),
        service_id=service_id, **kwargs)
    # ship_spans=False: the loopback shares the supervisor's tracer
    server = MemberServer(service, FrameConn(s_sock), pump=pump_mode,
                          ship_spans=False, device=dev)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name=f"member-serve-{service_id}")
    t.start()
    return ProcessMemberClient(
        FrameConn(c_sock, chaos_id=service_id), service_id, clock=clock,
        heartbeat_deadline_s=heartbeat_deadline_s,
        rpc_deadline_s=rpc_deadline_s, server=server, server_thread=t,
        device=dev)


# -- the spawned process's entry point ----------------------------------------

def _dial_supervisor(addr: str) -> _socket.socket:
    """Connect back to the spawner: a ``host:port`` address (a numeric port
    after the last colon) dials TCP and runs the client half of the HMAC
    handshake with the secret the spawner put in this process's environment
    (``wire.SECRET_ENV``); anything else is a unix socket path."""
    host, sep, port = addr.rpartition(":")
    if sep and host and port.isdigit():
        secret = os.environ.get(SECRET_ENV)
        if not secret:
            raise HandshakeError(
                f"tcp connect to {addr} needs the shared secret in "
                f"${SECRET_ENV} (the spawner sets it; it never rides the "
                "command line)")
        sock = tcp_dial(addr)
        client_handshake(sock, secret)
        return sock
    sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    sock.connect(addr)
    return sock


def _warm_device(impl: Optional[str], device: torch.device) -> None:
    """Before the child dials back: create its CUDA context on ``device``
    and load (from the build directory) the kernels a member of ``impl``
    launches, so neither holds the serve thread past its first
    heartbeat."""
    if device.type != "cuda":
        return
    from ..ops import _build

    torch.zeros(1, device=device)
    for name in IMPL_KERNELS.get(impl or "xla", ()):
        _build.load(name)


def main(argv: Optional[list] = None) -> int:
    """``python -m mpi_model_tpu_torch.ensemble.member_proc --connect
    <sock> --config <json>``: build the member service from its config and
    serve the supervisor until shutdown. ``--connect`` is a unix socket
    path or a ``host:port`` TCP address (then the secret must be in
    ``$MMTPU_WIRE_SECRET``). Exit codes: 0 a clean shutdown, 2 a bad config
    (or no card where the config asks for one), 1 the wire lost before
    shutdown or refused at the handshake."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mpi_model_tpu_torch.ensemble.member_proc")
    p.add_argument("--connect", required=True,
                   help="unix socket path or host:port TCP address the "
                        "supervisor listens on")
    p.add_argument("--config", required=True,
                   help="member config JSON path (service_id, model "
                        "recipe, member_kwargs, pump mode, device)")
    args = p.parse_args(argv)
    try:
        with open(args.config) as fh:
            cfg = json.load(fh)
        device = resolve_device(cfg.get("device"))
        model = model_from_meta(cfg["model"])
        kwargs = _decode_member_kwargs(cfg.get("member_kwargs", {}))
        if kwargs.get("mesh") is not None:
            from .mesh import resolve_ensemble_mesh

            kwargs["mesh"] = resolve_ensemble_mesh(kwargs["mesh"],
                                                   device=device)
        pump = cfg.get("pump", "thread")
        service = AsyncEnsembleService(
            model, start=(pump == "thread"),
            service_id=cfg.get("service_id"), **kwargs)
        _warm_device(kwargs.get("impl"), device)
    except (OSError, ValueError, KeyError, TypeError, RuntimeError) as e:
        print(f"member config failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    try:
        sock = _dial_supervisor(args.connect)
    except (WireError, OSError) as e:
        print(f"member connect failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    server = MemberServer(service, FrameConn(sock), pump=pump,
                          device=device)
    # the fleet's protocol is the shutdown RPC; anything harder is SIGKILL
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (OSError, ValueError):  # pragma: no cover - non-main thread
        pass
    server.serve_forever()
    return 0 if server.clean_shutdown else 1


if __name__ == "__main__":
    raise SystemExit(main())
