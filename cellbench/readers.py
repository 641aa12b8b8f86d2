"""The arithmetic the per-layer readers (``metrics/<name>.py``) share.
Each takes the run's record (``harness.Context.record``) and returns a
number, or None when the record has nothing to read: the harness then
leaves the metric out of the line. No share is ever made up as 0."""

from __future__ import annotations

import statistics


def self_ms(record: dict, parent: str, child: str):
    """Mean ms a ``parent`` span spends outside its ``child`` spans, over
    the window's spans outside the traced part."""
    spans = record.get("spans") or []
    kids: dict = {}
    for s in spans:
        if s.name == child and s.parent_id is not None:
            kids[s.parent_id] = kids.get(s.parent_id, 0.0) + s.duration_s
    own = [s.duration_s - kids.get(s.span_id, 0.0)
           for s in spans if s.name == parent]
    return 1e3 * statistics.fmean(own) if own else None


def spans_ms_per(record: dict, names: tuple, per: str):
    """Summed ms of the spans named ``names`` per span named ``per``."""
    spans = record.get("spans") or []
    n = sum(1 for s in spans if s.name == per)
    if not n:
        return None
    return 1e3 * sum(s.duration_s for s in spans if s.name in names) / n


def idle_share(record: dict):
    tl = record.get("timeline")
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def roofline_share(record: dict):
    """The roofline time of the traced part's work over the device's busy
    time in it."""
    tl, work = record.get("timeline"), record.get("work_roofline_s")
    if tl is None or not work or tl.busy_s <= 0:
        return None
    return 100.0 * work / tl.busy_s


def step_mfu(record: dict):
    """The roofline time of the traced part's work over its length."""
    tl, work = record.get("timeline"), record.get("work_roofline_s")
    if tl is None or not work or tl.window_s <= 0:
        return None
    return 100.0 * work / tl.window_s


def _lanes(snap: dict) -> int:
    """Dispatched lanes so far: the counter's snapshot gives the scenarios
    and their share of the lanes."""
    occ = snap.get("batch_occupancy")
    return round(snap["scenarios"] / occ) if occ else 0


def batch_occupancy(record: dict):
    """Real lanes over dispatched lanes, in the window's dispatches."""
    st = record.get("stats")
    if not st:
        return None
    s0, s1 = st
    lanes = _lanes(s1) - _lanes(s0)
    if lanes <= 0:
        return None
    return 100.0 * (s1["scenarios"] - s0["scenarios"]) / lanes

