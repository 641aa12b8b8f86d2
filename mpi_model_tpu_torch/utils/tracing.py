"""Structured tracing (counterpart of ``mpi_model_tpu/utils/tracing.py``;
the port keeps its own copy of that stdlib-only module and imports nothing
of the JAX package).

- ``Tracer.span(name)``: nested, thread-safe wall-clock spans with one span
  stack per thread;
- trace contexts: every span carries a ``trace_id``/``span_id``/
  ``parent_id``; nesting parents through a per-thread context stack,
  ``span(parent=ctx)`` parents explicitly (a dispatch span under its
  ticket's submit span, whatever the pump thread has open), and
  ``attach(ctx)`` adopts a context that crossed a thread or process
  boundary as a two-key dict (``TraceContext.to_meta``/``from_meta``);
- ``summary()``: per-name count, total, mean, max, p50 and p99 (through
  ``metrics.LatencyReservoir``), with a ``__tracer__`` entry carrying
  ``dropped`` and ``recorded``;
- ``export_chrome()``: the Chrome trace-event format (``X`` events in µs,
  ``process_name`` metadata, a top-level ``dropped``);
- ``export_stream()``: a JSONL sink, one ``Span.to_dict`` line a span as it
  completes, flushed every ``_STREAM_FLUSH_EVERY`` spans;
- ``spans_since()``/``ingest()``: completed-span deltas as plain dicts,
  wall-clock anchored, and their absorption by another process's tracer;
- ``device_trace()``: a ``torch.profiler`` trace (CPU and, with a card,
  CUDA activity) over a block, under a host span of the same name, written
  as a Chrome trace into ``logdir``;
- a process-wide default tracer (``get_tracer``/``set_tracer``/
  ``trace_span``) that the port's own phases report into:
  ``Model.execute`` (``model.execute`` ⊃ ``executor.run``, then
  ``model.report``), the sharded executor's builds, the ensemble
  dispatch (``ensemble.assemble``/``launch``/``fetch``) and the supervisor
  (``supervise.chunk``, ``supervise.failure``).

Span ids, span dicts, Chrome events and JSONL lines have the JAX package's
field names and shapes, so spans of either package merge into one
timeline. A span times the host: over an asynchronous CUDA launch it
measures the enqueue, and no span synchronizes the card. Recording one span
is two ``perf_counter`` calls, two ids (no system call: the pid part is
read once a process), a tuple pushed and a ``Span`` appended under the
ring's lock; ``Tracer(enabled=False)`` records nothing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
import warnings
from typing import Any, ContextManager, Iterator, Optional

__all__ = [
    "Span",
    "TraceContext",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "trace_span",
]

#: process-unique span-id source: ids are ``<pid:x>-<n:x>``, so two
#: processes never collide
_ids = itertools.count(1)
#: ``<pid:x>-``, read once a process (a fork's child reads its own): a
#: span's ids cost no system call
_id_prefix = f"{os.getpid():x}-"


def _reset_id_prefix() -> None:
    global _id_prefix
    _id_prefix = f"{os.getpid():x}-"


os.register_at_fork(after_in_child=_reset_id_prefix)


def _new_id() -> str:
    return _id_prefix + format(next(_ids), "x")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One position in a trace: its trace and the span that is the current
    parent. Crosses thread and process boundaries as a two-key dict."""

    trace_id: str
    span_id: str

    def to_meta(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_meta(cls, meta: Optional[dict]) -> Optional["TraceContext"]:
        """None-safe decode: meta without both ids gives None (spans then
        root locally), never an error."""
        if not isinstance(meta, dict):
            return None
        t, s = meta.get("trace_id"), meta.get("span_id")
        if not (isinstance(t, str) and isinstance(s, str)):
            return None
        return cls(t, s)


@dataclasses.dataclass(slots=True)
class Span:
    """One completed span. ``start_s`` is ``perf_counter``-based (relative
    to other spans of the same tracer); ``start_wall_s`` is its wall-clock
    anchor (epoch seconds), which orders spans of different processes."""

    name: str
    start_s: float
    duration_s: float
    thread: int
    depth: int
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None
    start_wall_s: Optional[float] = None
    #: the recording process (ingested spans keep theirs)
    pid: int = 0
    #: monotone per-tracer append index (the ``spans_since`` cursor)
    seq: int = 0

    def to_dict(self) -> dict:
        """The wire and export projection (a plain JSON-able dict)."""
        return {
            "name": self.name, "start_s": self.start_s,
            "duration_s": self.duration_s, "thread": self.thread,
            "depth": self.depth, "meta": dict(self.meta),
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_wall_s": self.start_wall_s, "pid": self.pid,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(
            name=d.get("name", "?"), start_s=float(d.get("start_s", 0.0)),
            duration_s=float(d.get("duration_s", 0.0)),
            thread=int(d.get("thread", 0)), depth=int(d.get("depth", 0)),
            meta=dict(d.get("meta") or {}), trace_id=d.get("trace_id"),
            span_id=d.get("span_id"), parent_id=d.get("parent_id"),
            start_wall_s=d.get("start_wall_s"),
            pid=int(d.get("pid", 0)))


class Tracer:
    """Thread-safe span recorder with per-thread nesting and trace
    contexts. The buffer is a ring of at most ``max_spans`` spans (oldest
    dropped first, counted in ``dropped``)."""

    #: flush the streaming sink every N spans: a kill loses at most this
    #: many buffered spans, and recording pays no syscall per span
    _STREAM_FLUSH_EVERY = 32

    def __init__(self, enabled: bool = True, max_spans: int = 20_000):
        self.enabled = enabled
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=int(max_spans))
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pid = os.getpid()
        #: start_wall_s = start_s + _wall_off (one pair of clock reads here)
        self._wall_off = time.time() - time.perf_counter()
        self._seq = 0
        #: pid → label for export_chrome's process_name records
        self._process_labels: dict[int, str] = {}
        self._stream = None
        self._stream_path: Optional[str] = None
        self._stream_pending = 0

    # -- trace context -------------------------------------------------------

    def _state(self) -> "_ThreadState":
        try:
            return self._local.state
        except AttributeError:
            # analysis: ignore[unguarded-shared-mutation] — threading.local
            # storage: each thread mutates only its own state slot
            st = self._local.state = _ThreadState()
            return st

    def current(self) -> Optional[TraceContext]:
        """The calling thread's innermost open context (a span in progress
        or an attached parent), or None."""
        ctx = self._state().ctx
        return TraceContext(*ctx[-1]) if ctx else None

    @contextlib.contextmanager
    def attach(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Adopt ``ctx`` (from another thread or process) as the calling
        thread's current parent for the block; None is a no-op."""
        if ctx is None:
            yield
            return
        stack = self._state().ctx
        stack.append((ctx.trace_id, ctx.span_id))
        try:
            yield
        finally:
            stack.pop()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, parent: Optional[TraceContext] = None,
             **meta: Any) -> ContextManager[dict]:
        """Record one span around the block; the block gets the mutable
        meta dict, so values learned inside it land on the span. ``parent``
        overrides the thread's current context."""
        if not self.enabled:
            return _Unrecorded(meta)
        return _OpenSpan(self, name, parent, meta)

    def instant(self, name: str, **meta: Any) -> None:
        """Record a zero-duration marker, parented like a nested span."""
        if not self.enabled:
            return
        st = self._state()
        trace_id, parent_id = st.ctx[-1] if st.ctx else (_new_id(), None)
        t0 = time.perf_counter()
        self._append(Span(name, t0, 0.0, threading.get_ident(), st.depth,
                          dict(meta), trace_id, _new_id(), parent_id,
                          t0 + self._wall_off, self._pid))

    def _append(self, s: Span) -> None:
        with self._lock:
            self._seq += 1
            s.seq = self._seq
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)
            if self._stream is not None:
                self._stream_write_locked(s)

    def _stream_write_locked(self, s: Span) -> None:
        try:
            # analysis: ignore[blocking-under-lock] — a buffered ~200-byte
            # write into the FILE buffer (no syscall except at the bounded
            # flush below); serializing it under the tracer lock keeps the
            # JSONL lines whole
            # default=repr: recording a span never raises at the call site;
            # the write under the lock keeps concurrent lines whole
            self._stream.write(json.dumps(s.to_dict(), default=repr) + "\n")
            self._stream_pending += 1
            if self._stream_pending >= self._STREAM_FLUSH_EVERY:
                # analysis: ignore[blocking-under-lock] — the bounded flush
                # cadence: one syscall per _STREAM_FLUSH_EVERY spans, the
                # documented data-at-risk/latency trade
                self._stream.flush()
                self._stream_pending = 0
        except (OSError, ValueError) as e:
            # a dead sink (full disk, closed file) detaches, loudly, once;
            # the ring keeps recording
            try:
                self._stream.close()
            except OSError:
                pass
            self._stream = None
            self._stream_path = None
            warnings.warn(f"span stream sink failed and was detached: {e}",
                          RuntimeWarning)

    # -- cross-process shipping ----------------------------------------------

    def spans_since(self, cursor: int) -> tuple[int, list[dict]]:
        """``(new_cursor, span dicts)`` appended after ``cursor``. Spans that
        left the ring before being shipped are gone (``dropped``)."""
        out: list[Span] = []
        with self._lock:
            cur = self._seq
            for s in reversed(self._spans):
                if s.seq <= cursor:
                    break
                out.append(s)
        return cur, [s.to_dict() for s in reversed(out)]

    def ingest(self, span_dicts: list, label: Optional[str] = None) -> int:
        """Absorb span dicts recorded by another process; returns how many.
        Spans stamped with this process's pid are skipped (a shared tracer
        must not see its own spans twice). ``label`` names the sender in
        ``export_chrome``'s process records."""
        n = 0
        pids: set = set()
        for d in span_dicts or ():
            s = Span.from_dict(d)
            if s.pid == self._pid:
                continue
            pids.add(s.pid)
            self._append(s)
            n += 1
        if label is not None and pids:
            with self._lock:
                for p in pids:
                    self._process_labels[p] = label
        return n

    def label_process(self, label: str, pid: Optional[int] = None) -> None:
        """Name a pid in Chrome exports (``process_name`` metadata)."""
        with self._lock:
            self._process_labels[self._pid if pid is None else pid] = label

    # -- inspection ----------------------------------------------------------

    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def summary(self) -> dict[str, dict[str, float]]:
        """Per-name aggregates: count, total_s, mean_s, max_s, p50_s, p99_s;
        the reserved ``__tracer__`` entry carries ``dropped`` and
        ``recorded``."""
        from .metrics import LatencyReservoir

        out: dict[str, dict[str, float]] = {}
        durs: dict[str, list[float]] = {}
        spans = self.spans
        for s in spans:
            agg = out.setdefault(
                s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.duration_s
            agg["max_s"] = max(agg["max_s"], s.duration_s)
            durs.setdefault(s.name, []).append(s.duration_s)
        for name, agg in out.items():
            agg["mean_s"] = agg["total_s"] / agg["count"]
            d = sorted(durs[name])
            agg["p50_s"] = LatencyReservoir.percentile_of(d, 0.50)
            agg["p99_s"] = LatencyReservoir.percentile_of(d, 0.99)
        out["__tracer__"] = {"dropped": self.dropped,
                             "recorded": len(spans)}
        return out

    # -- export --------------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Spans as Chrome ``X`` events (µs, wall-clock anchored where the
        span has its anchor), then one ``process_name`` record a pid."""
        events = []
        with self._lock:
            labels = dict(self._process_labels)
        pids = set()
        for s in self.spans:
            ts = s.start_wall_s if s.start_wall_s is not None else s.start_s
            pids.add(s.pid)
            args = dict(s.meta)
            if s.trace_id is not None:
                args.update({"trace_id": s.trace_id, "span_id": s.span_id,
                             "parent_id": s.parent_id})
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": ts * 1e6,
                "dur": s.duration_s * 1e6,
                "pid": s.pid or 1,
                "tid": s.thread,
                "args": args,
            })
        for pid in sorted(pids):
            name = labels.get(pid)
            if name is None:
                name = "fleet" if pid == self._pid else f"pid-{pid}"
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid or 1, "args": {"name": name}})
        return events

    def export_stream(self, path: str) -> str:
        """Attach the JSONL sink at ``path`` (append mode; a torn last line
        of an earlier writer is closed first). Every span completed from
        now on is one ``Span.to_dict`` line; ``close_stream`` flushes and
        detaches. A later call replaces the sink."""
        f = open(path, "a")
        try:
            with open(path, "rb") as rf:
                rf.seek(0, os.SEEK_END)
                if rf.tell() > 0:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        f.write("\n")
        except OSError:  # pragma: no cover - best effort
            pass
        with self._lock:
            old, self._stream = self._stream, f
            self._stream_path = path
            self._stream_pending = 0
        if old is not None:
            try:
                old.flush()
                old.close()
            except OSError:  # pragma: no cover - best effort
                pass
        return path

    def close_stream(self) -> Optional[str]:
        """Flush and detach the sink; its path, or None without one."""
        with self._lock:
            f, self._stream = self._stream, None
            path, self._stream_path = self._stream_path, None
            self._stream_pending = 0
        if f is None:
            return None
        try:
            f.flush()
            f.close()
        except OSError:  # pragma: no cover - best effort
            pass
        return path

    def export_chrome(self, path: str) -> str:
        """Write the trace as a Chrome/Perfetto JSON file, with the ring's
        ``dropped`` count at top level."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms",
                       "dropped": self.dropped}, f)
        return path

    # -- device profiling ----------------------------------------------------

    @contextlib.contextmanager
    def device_trace(self, logdir: str, name: str = "device_trace"
                     ) -> Iterator[None]:
        """A ``torch.profiler`` trace over the block (CPU activity, and CUDA
        activity when a card is present), under a host span of the same
        name; the trace is written into ``logdir`` as
        ``<name>.pt.trace.json`` (Chrome format) when the block ends. The
        profile keeps its events across the profiler's cycles
        (``acc_events=True``): without it, a process that profiled before
        lost the block's kernels (0 of 8 K1 kernels, ``chip_smoke.py``'s
        long process on an H100)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with self.span(name, logdir=logdir):
            with profile(activities=acts, acc_events=True) as prof:
                yield
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(logdir, f"{name}.pt.trace.json"))


class _ThreadState:
    """One thread's open spans: its nesting depth and its context stack of
    ``(trace_id, span_id)`` pairs."""

    __slots__ = ("depth", "ctx")

    def __init__(self):
        self.depth = 0
        self.ctx: list = []


class _OpenSpan:
    """``Tracer.span``'s context manager: ids and the clock on entry, the
    completed ``Span`` into the ring on exit (an exception included; it
    propagates). A class, not a generator: a span sits between a device
    sync and the next launch, so its host cost is on the run's critical
    path."""

    __slots__ = ("tracer", "name", "parent", "meta", "state", "depth",
                 "ids", "t0")

    def __init__(self, tracer: Tracer, name: str,
                 parent: Optional[TraceContext], meta: dict):
        self.tracer, self.name, self.parent, self.meta = (tracer, name,
                                                          parent, meta)

    def __enter__(self) -> dict:
        st = self.state = self.tracer._state()
        self.depth = st.depth
        st.depth += 1
        p = self.parent
        if p is not None:
            trace_id, parent_id = p.trace_id, p.span_id
        elif st.ctx:
            trace_id, parent_id = st.ctx[-1]
        else:
            trace_id, parent_id = _new_id(), None
        span_id = _new_id()
        self.ids = (trace_id, span_id, parent_id)
        st.ctx.append((trace_id, span_id))
        self.t0 = time.perf_counter()
        return self.meta

    def __exit__(self, *exc) -> bool:
        t0 = self.t0
        dt = time.perf_counter() - t0
        st = self.state
        st.ctx.pop()
        st.depth = self.depth
        tr = self.tracer
        trace_id, span_id, parent_id = self.ids
        tr._append(Span(self.name, t0, dt, threading.get_ident(),
                        self.depth, dict(self.meta), trace_id, span_id,
                        parent_id, t0 + tr._wall_off, tr._pid))
        return False


class _Unrecorded:
    """A disabled tracer's span: the block gets its meta, nothing is
    recorded."""

    __slots__ = ("meta",)

    def __init__(self, meta: dict):
        self.meta = meta

    def __enter__(self) -> dict:
        return self.meta

    def __exit__(self, *exc) -> bool:
        return False


# -- process-wide default tracer -----------------------------------------------

_default = Tracer(enabled=True)
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (a disabled one, a fresh one in a
    test); returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, tracer
    return prev


def trace_span(name: str, **meta: Any):
    """``get_tracer().span(...)`` resolved at call time, so a tracer
    swapped in mid-process is honoured."""
    return get_tracer().span(name, **meta)
