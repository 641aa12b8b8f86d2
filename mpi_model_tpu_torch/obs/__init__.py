"""The telemetry plane (counterpart of ``mpi_model_tpu/obs/__init__.py``,
with the same schema, so either package's tools read the other's
documents).

- :func:`fleet_snapshot`: one versioned JSON document
  (``schema: "mpi-model-tpu.obs/1"``) of a service's serving stats, the
  tracer's per-stage rollups with its ``dropped`` count, and the flight
  recorder's dump ledger;
- :func:`validate_snapshot`: the schema gate, naming the first missing or
  malformed field;
- :func:`write_snapshot`: the document to a file, atomically (tmp and
  rename), as ``run_soak(snapshot_path=...)`` writes it on an interval;
- :func:`prometheus_text`: the Prometheus text exposition of a stats cut
  (``mpi_model_tpu_<name>``, members labelled ``service_id``);
- :func:`serve_status`: a live scrape endpoint on ``127.0.0.1`` (stdlib
  HTTP on a daemon thread): ``GET /metrics`` the Prometheus text, ``GET /``
  the snapshot, each computed per request;
- :func:`timeline`: the post-mortem timeline of one ticket, joining the
  fleet journal, the tiering journal and span files, with explicit
  uncertainty records (``obs/postmortem.py``);
- :mod:`obs.flight`: the flight recorder.

``python -m mpi_model_tpu_torch.obs`` is the operator command line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .flight import FlightRecorder, get_recorder, set_recorder

__all__ = [
    "SCHEMA",
    "FlightRecorder",
    "fleet_snapshot",
    "get_recorder",
    "jsonable",
    "prometheus_text",
    "serve_status",
    "set_recorder",
    "timeline",
    "validate_snapshot",
    "write_snapshot",
]

#: the telemetry-plane schema id (the JAX package's)
SCHEMA = "mpi-model-tpu.obs/1"

#: top-level fields every snapshot carries
_REQUIRED = ("schema", "generated_unix_s", "stats", "tracer",
             "flight_recorder")
#: stats fields every serving snapshot carries
_REQUIRED_STATS = ("dispatches", "scenarios", "busy_s", "inflight_s",
                   "shed", "expired", "quarantined", "loop_faults",
                   "latency_n", "latency_p50_s", "latency_p99_s")


def fleet_snapshot(service=None, *, stats: Optional[dict] = None,
                   tracer=None, recorder=None) -> dict:
    """The telemetry plane as one versioned JSON document. ``service`` is
    anything with ``stats()`` (an ``AsyncEnsembleService``, an
    ``EnsembleService``); ``stats=`` passes a cut the caller already holds
    instead. The tracer adds its per-stage rollups and ``dropped``; the
    flight recorder its dump ledger (reasons and paths; the rings live in
    the dump files)."""
    from ..utils.tracing import get_tracer

    if stats is None:
        if service is None:
            raise ValueError(
                "fleet_snapshot needs a service (anything with .stats()) "
                "or an explicit stats= cut")
        stats = service.stats()
    tr = tracer if tracer is not None else get_tracer()
    rec = recorder if recorder is not None else get_recorder()
    dump_ledger = rec.dump_ledger()
    summary = tr.summary()
    meta = summary.pop("__tracer__", {"dropped": tr.dropped,
                                      "recorded": len(tr.spans)})
    return {
        "schema": SCHEMA,
        "generated_unix_s": time.time(),
        "pid": os.getpid(),
        "stats": jsonable(stats),
        "tracer": {
            "dropped": meta.get("dropped", 0),
            "recorded": meta.get("recorded", 0),
            "stages": jsonable(summary),
        },
        "flight_recorder": {
            "dumps": len(dump_ledger),
            "dump_reasons": sorted({d["reason"] for d in dump_ledger}),
            "dump_paths": [d["path"] for d in dump_ledger
                           if d.get("path")],
        },
    }


def validate_snapshot(doc: dict) -> None:
    """Raise ``ValueError`` naming the first missing or malformed field of
    an ``mpi-model-tpu.obs/1`` document."""
    if not isinstance(doc, dict):
        raise ValueError(f"snapshot is {type(doc).__name__}, not a dict")
    for k in _REQUIRED:
        if k not in doc:
            raise ValueError(f"snapshot missing required field {k!r}")
    if doc["schema"] != SCHEMA:
        raise ValueError(
            f"snapshot schema {doc['schema']!r} != expected {SCHEMA!r}")
    stats = doc["stats"]
    if not isinstance(stats, dict):
        raise ValueError("snapshot stats is not a dict")
    for k in _REQUIRED_STATS:
        if k not in stats:
            raise ValueError(f"snapshot stats missing field {k!r}")
    tr = doc["tracer"]
    if not isinstance(tr, dict) or "dropped" not in tr \
            or "stages" not in tr:
        raise ValueError(
            "snapshot tracer block must carry dropped + stages — a "
            "truncated trace must be explicit in the artifact")
    json.dumps(doc)  # the plane is a JSON document


def write_snapshot(path: str, service=None, **kw) -> dict:
    """The snapshot to ``path`` atomically (tmp and rename: a reader never
    sees a torn document). Returns the document."""
    doc = fleet_snapshot(service, **kw)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return doc


# -- Prometheus-style exposition -------------------------------------------------

def _prom_name(key: str) -> str:
    return "mpi_model_tpu_" + key.replace("-", "_")


def _prom_lines(stats: dict, label: str = "") -> list:
    out = []
    for k in sorted(stats):
        v = stats[k]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out.append((k, label, float(v)))
    return out


def prometheus_text(stats: dict) -> str:
    """Prometheus text exposition of a stats cut: every numeric field as
    ``mpi_model_tpu_<name>``, members of a ``services`` list labelled by
    ``service_id``; ``ThroughputCounter.COUNTERS`` (and the dispatch-time
    sums) typed ``counter``, everything else ``gauge``."""
    from ..utils.metrics import ThroughputCounter

    counterish = set(ThroughputCounter.COUNTERS) | {
        "busy_s", "inflight_s", "compile_cache_hits"}
    samples = _prom_lines(stats)
    for m in stats.get("services") or ():
        sid = m.get("service_id")
        if sid is None:
            continue
        samples.extend(_prom_lines(
            {k: v for k, v in m.items() if k != "service_id"},
            label=f'{{service_id="{sid}"}}'))
    by_name: dict = {}
    for k, label, v in samples:
        by_name.setdefault(k, []).append((label, v))
    lines = []
    for k in sorted(by_name):
        kind = "counter" if k in counterish else "gauge"
        name = _prom_name(k)
        lines.append(f"# TYPE {name} {kind}")
        for label, v in by_name[k]:
            lines.append(f"{name}{label} {v}")
    return "\n".join(lines) + "\n"


def serve_status(port: int, snapshot_fn, host: str = "127.0.0.1"):
    """A live scrape endpoint: a stdlib ``ThreadingHTTPServer`` on a daemon
    thread answering ``GET /metrics`` (``prometheus_text`` of
    ``snapshot_fn()["stats"]``) and ``GET /`` or ``/snapshot`` (the
    document), ``snapshot_fn`` called per request; a failing one answers
    500 naming the error. ``port=0`` binds an ephemeral port
    (``server.server_address[1]``). A port that cannot be bound raises
    ``OSError``. Stop it with ``.shutdown()`` then ``.server_close()``."""
    import http.server
    import threading

    class _Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path not in ("/", "/snapshot", "/metrics"):
                self._send(404, "text/plain; charset=utf-8",
                           b"unknown path (try / or /metrics)\n")
                return
            try:
                doc = snapshot_fn()
                if path == "/metrics":
                    body = prometheus_text(doc.get("stats", {})).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
            # analysis: ignore[broad-except] — scrape isolation: a failing
            # snapshot_fn (a stopped fleet, a torn file) must answer 500, not
            # kill the serving thread
            # the scrape boundary: a failing snapshot answers 500 and the
            # serving thread lives on
            except Exception as e:
                self._send(500, "text/plain; charset=utf-8",
                           f"snapshot failed: {e!r}\n".encode())
                return
            self._send(200, ctype, body)

        def log_message(self, *a):  # scrapes are not operator events
            pass

    server = http.server.ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="obs-status-server")
    t.start()
    return server


def jsonable(x):
    """The telemetry JSON projection: numpy scalars and arrays become
    numbers and lists, tuples lists, anything else its repr (telemetry
    never fails to serialize)."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    import numpy as np

    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return repr(x)


def timeline(ticket: int, **kw):
    """The post-mortem timeline of ``ticket``
    (``postmortem.reconstruct(ticket, journal_dir=, vault_dir=, spans=)``;
    ``obs/postmortem.py`` has the join's rules)."""
    from .postmortem import reconstruct

    return reconstruct(ticket, **kw)
