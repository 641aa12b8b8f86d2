"""Post-mortem timeline reconstruction (counterpart of
``mpi_model_tpu/obs/postmortem.py``; the same events for the same files and
spans).

:func:`reconstruct` joins, for one ticket, into one ordered timeline:

- **the fleet journal** (``ensemble.journal``, ``tickets.journal``): its
  submit, served, quarantined, expired, readmit, migrate and wake records,
  in verified-record order (each stamped ``t_wall``);
- **the tiering journal** (``<vault>/`` + ``lifecycle.TIERING.
  journal_name``): hibernate, hibernated, wake, requeue and reclaim;
- **spans**: ``Tracer.spans``, span dicts, a Chrome trace
  (``export_chrome``) or a JSONL stream (``export_stream``), matched by the
  ticket's ``trace_id`` (from its submit record) or, with no journaled
  trace, by the ticket in a dispatch span's ``tickets`` meta;
- **explicit uncertainty**: a ticket submitted and never resolved gets an
  ``uncertainty`` event saying where it was last known to be, and a ticket
  with no verified submit gets one too. A timeline never has a silent hole.

``Timeline.complete``: a submit and exactly one terminal record.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from ..ensemble.lifecycle import FLEET, SUBMIT, TIERING

__all__ = ["Timeline", "TimelineEvent", "reconstruct", "spans_from_chrome",
           "spans_from_jsonl"]


@dataclasses.dataclass
class TimelineEvent:
    """One timeline entry. ``t_wall`` is None for records with no wall
    stamp, which keep their source order."""

    t_wall: Optional[float]
    source: str  # "journal" | "tiering" | "span" | "reconstruction"
    kind: str
    detail: str
    service_id: Optional[str] = None
    #: source-local ordering key (journal record index / span start)
    order: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Timeline:
    """One ticket's reconstructed lifecycle."""

    ticket: int
    events: list
    #: a submit seen and exactly one terminal record seen
    complete: bool
    #: the explicit uncertainty records (also in ``events``)
    gaps: list
    #: the trace id the ticket's spans were matched by (None when the submit
    #: record carried no trace context)
    trace_id: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "ticket": self.ticket,
            "complete": self.complete,
            "trace_id": self.trace_id,
            "events": [e.to_dict() for e in self.events],
            "gaps": [e.to_dict() for e in self.gaps],
        }


def spans_from_chrome(path: str) -> list:
    """Span dicts out of an ``export_chrome`` file."""
    with open(path) as fh:
        doc = json.load(fh)
    out = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        out.append({
            "name": e.get("name"),
            "start_wall_s": e.get("ts", 0.0) / 1e6,
            "duration_s": e.get("dur", 0.0) / 1e6,
            "pid": e.get("pid"), "thread": e.get("tid"),
            "meta": {k: v for k, v in args.items()
                     if k not in ("trace_id", "span_id", "parent_id")},
            "trace_id": args.get("trace_id"),
            "span_id": args.get("span_id"),
            "parent_id": args.get("parent_id"),
        })
    return out


def spans_from_jsonl(path: str) -> list:
    """Span dicts out of an ``export_stream`` JSONL file; a torn last line
    (a writer killed mid-append) is skipped."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue  # the torn tail of a killed writer
            if isinstance(d, dict):
                out.append(d)
    return out


def _span_dicts(spans) -> list:
    """``Tracer.spans`` (Span objects), dicts, or a span file path (a
    Chrome trace, or a ``.jsonl`` stream) as plain span dicts."""
    if spans is None:
        return []
    if isinstance(spans, str):
        if spans.endswith(".jsonl"):
            return spans_from_jsonl(spans)
        return spans_from_chrome(spans)
    return [s if isinstance(s, dict) else s.to_dict() for s in spans]


#: read cache keyed by the file's stat signature: the timelines of many
#: tickets over the same journals scan each file once
_READ_CACHE: dict = {}
_READ_CACHE_MAX = 4


def _read_records_cached(path: str):
    from ..ensemble.journal import read_records

    st = os.stat(path)
    sig = (st.st_mtime_ns, st.st_size)
    hit = _READ_CACHE.get(path)
    if hit is not None and hit[0] == sig:
        return hit[1], hit[2]
    records, torn = read_records(path)
    while len(_READ_CACHE) >= _READ_CACHE_MAX:
        _READ_CACHE.pop(next(iter(_READ_CACHE)))
    _READ_CACHE[path] = (sig, records, torn)
    return records, torn


def _journal_events(ticket: int, path: str, source: str) -> tuple:
    """(events, submit meta, terminal kinds) of ``ticket`` in one TJ1
    file."""
    events: list = []
    submit_meta: Optional[dict] = None
    terminals: list = []
    if not os.path.exists(path):
        return events, submit_meta, terminals
    records, torn = _read_records_cached(path)
    for rec in records:
        if rec.meta.get("ticket") != ticket:
            continue
        sid = rec.meta.get("service_id")
        bits = []
        for k in ("seq", "source", "from", "to", "reason", "error",
                  "detail", "steps"):
            v = rec.meta.get(k)
            if v is not None:
                bits.append(f"{k}={v}")
        events.append(TimelineEvent(
            t_wall=rec.meta.get("t_wall"), source=source, kind=rec.kind,
            detail="; ".join(bits), service_id=sid, order=rec.index))
        if rec.kind == SUBMIT and submit_meta is None:
            submit_meta = rec.meta
        if FLEET.is_terminal(rec.kind):
            terminals.append(rec.kind)
    if torn:
        events.append(TimelineEvent(
            t_wall=None, source=source, kind="journal-torn-tail",
            detail=f"{path} had an unverifiable suffix — events after "
                   "the verified prefix are unknown",
            order=len(records) + 0.5))
    return events, submit_meta, terminals


def reconstruct(ticket: int, *, journal_dir: Optional[str] = None,
                vault_dir: Optional[str] = None,
                spans=None) -> Timeline:
    """Join every given source into one ordered timeline of ``ticket``
    (the module docstring has the rules)."""
    from ..ensemble.journal import journal_path

    events: list = []
    gaps: list = []
    submit_meta = None
    terminals: list = []
    if journal_dir is not None:
        ev, submit_meta, terminals = _journal_events(
            ticket, journal_path(journal_dir), "journal")
        events.extend(ev)
    if vault_dir is not None:
        ev, _, _ = _journal_events(
            ticket, os.path.join(vault_dir, TIERING.journal_name),
            "tiering")
        events.extend(ev)

    # spans: by the submit record's trace id, else by ticket membership
    trace_id = None
    if submit_meta is not None:
        tmeta = submit_meta.get("trace")
        if isinstance(tmeta, dict):
            trace_id = tmeta.get("trace_id")
    for d in _span_dicts(spans):
        meta = d.get("meta") or {}
        tid = d.get("trace_id")
        if trace_id is not None:
            # the journaled trace id decides: a dispatch span's tickets are
            # one scheduler's ids, not the journal's
            match = (tid == trace_id
                     or trace_id in (meta.get("trace_ids") or ()))
        else:
            # no journaled trace: ticket membership, right for a single
            # scheduler's namespace
            match = (ticket in (meta.get("tickets") or ())
                     or meta.get("ticket") == ticket)
        if not match:
            continue
        t0 = d.get("start_wall_s")
        events.append(TimelineEvent(
            t_wall=t0, source="span", kind=d.get("name", "span"),
            detail=f"{d.get('duration_s', 0.0):.6f}s "
                   f"pid={d.get('pid')}",
            service_id=meta.get("service_id"),
            order=t0 if t0 is not None else 0.0))

    # explicit uncertainty: submitted and never resolved, with the last
    # attribution record's member
    if submit_meta is not None and not terminals:
        last_sid = submit_meta.get("service_id")
        for e in events:
            if (e.source == "journal"
                    and e.kind in FLEET.attribution_kinds()):
                last_sid = e.service_id or last_sid
        where = (f"on {last_sid}" if last_sid else "unattributed")
        gap = TimelineEvent(
            t_wall=None, source="reconstruction", kind="uncertainty",
            detail=f"submitted but never resolved in the journal — in "
                   f"flight {where} at end of journal (process killed "
                   "before a terminal record, or the journal's tail "
                   "was lost)",
            service_id=last_sid, order=float("inf"))
        events.append(gap)
        gaps.append(gap)
    if submit_meta is None and (journal_dir is not None or events):
        gap = TimelineEvent(
            t_wall=None, source="reconstruction", kind="uncertainty",
            detail="no verified submit record for this ticket — the "
                   "journal predates it, lost its tail, or the ticket "
                   "id is from another fleet",
            order=float("-inf"))
        events.append(gap)
        gaps.append(gap)
    if any(e.t_wall is None and e.source in ("journal", "tiering")
           for e in events):
        note = TimelineEvent(
            t_wall=None, source="reconstruction", kind="ordering-note",
            detail="some records carry no t_wall stamp (a journal "
                   "written before records were stamped) — their order "
                   "is record-index order, not clock order",
            order=float("-inf"))
        events.append(note)

    # merge: stamped events by wall time, then the unstamped in their
    # source-local order
    stamped = sorted((e for e in events if e.t_wall is not None),
                     key=lambda e: (e.t_wall, e.order))
    unstamped = sorted((e for e in events if e.t_wall is None),
                       key=lambda e: e.order)
    return Timeline(
        ticket=ticket,
        events=stamped + unstamped,
        complete=(submit_meta is not None and len(terminals) == 1),
        gaps=gaps,
        trace_id=trace_id)
