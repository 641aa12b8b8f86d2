"""Flight recorder: a bounded ring of recent ticket-lifecycle events per
service (counterpart of ``mpi_model_tpu/obs/flight.py``; the port keeps its
own copy of that stdlib-only module).

Every lifecycle seam the port has (submit, served, failed, quarantined,
expired, shed) drops one small event into its service's ring, and a failure
worth a ``FailureEvent`` (a quarantine) dumps the ring beside it: kept in
``dumps``, and written as JSON under ``dump_dir`` when the recorder has one
(the CLI's ``--status PATH`` installs one dumping under
``PATH.flight.d/``). Recording is one dict, one deque append and one leaf
lock, with no I/O; rings, the dump list and dump files are bounded. The
process-wide default (``get_recorder``/``set_recorder``) is what the
serving stack records into.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "set_recorder",
]

#: events kept per service ring
DEFAULT_CAPACITY = 256
#: in-memory dumps kept (oldest discarded)
DEFAULT_MAX_DUMPS = 32


class FlightRecorder:
    """Bounded per-service rings of lifecycle events, and failure dumps.
    Thread-safe behind one leaf lock (nothing is acquired under it: the
    serving stack records from under its own locks)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_dumps: int = DEFAULT_MAX_DUMPS,
                 dump_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {}
        #: the most recent dumps, newest last: {reason, service_id, ticket,
        #: t_wall, events, path}
        self.dumps: collections.deque = collections.deque(
            maxlen=int(max_dumps))
        self.dump_dir = dump_dir
        self._dump_seq = 0

    def record(self, kind: str, *, service_id: Optional[str] = None,
               ticket: Optional[int] = None, **detail) -> None:
        """One event into ``service_id``'s ring (None: the ``"fleet"``
        ring), stamped with ``t_wall`` so dumps order against spans."""
        ev = {"t_wall": time.time(), "kind": kind,
              "service_id": service_id, "ticket": ticket}
        if detail:
            ev.update(detail)
        key = service_id or "fleet"
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = collections.deque(maxlen=self.capacity)
                self._rings[key] = ring
            ring.append(ev)

    def snapshot(self, service_id: Optional[str] = None) -> list:
        """A ring's events (every ring merged by time when ``service_id``
        is None), newest last."""
        with self._lock:
            if service_id is not None:
                return list(self._rings.get(service_id, ()))
            merged: list = []
            for ring in self._rings.values():
                merged.extend(ring)
        merged.sort(key=lambda e: e["t_wall"])
        return merged

    def dump_ledger(self) -> list:
        """The dump records, copied under the lock."""
        with self._lock:
            return list(self.dumps)

    def dump(self, reason: str, *, service_id: Optional[str] = None,
             ticket: Optional[int] = None) -> dict:
        """Cut the recent history out now: the service's ring plus the
        fleet ring, kept in ``dumps`` and written under ``dump_dir`` when
        set (a failed write leaves ``path`` None: a dump runs on a path that
        is already failing). Returns the dump record."""
        events = self.snapshot(service_id)
        if service_id is not None:
            events = sorted(events + self.snapshot("fleet"),
                            key=lambda e: e["t_wall"])
        rec = {"reason": reason, "service_id": service_id,
               "ticket": ticket, "t_wall": time.time(),
               "events": events, "path": None}
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        if self.dump_dir is not None:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(self.dump_dir,
                                    f"flight-{seq:04d}-{reason}.json")
                with open(path, "w") as fh:
                    json.dump(rec, fh)
                rec["path"] = path
            except OSError:
                rec["path"] = None
        with self._lock:
            self.dumps.append(rec)
        return rec


_default = FlightRecorder()
_default_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    return _default


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-wide recorder; returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, recorder
    return prev
