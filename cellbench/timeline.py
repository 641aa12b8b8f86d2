"""The traced part of a ``--trace 1`` window: a ``torch.profiler`` trace of
the device, and the host spans laid on the same clock.

``Profile.start()``/``stop()`` bracket a steady part of the window; each
leaves an anchor (a ``record_function`` at a known ``perf_counter``), so
the profiler's microseconds map onto the clock the program's spans use.
``Timeline`` holds what was read: every device operation (kernels, copies,
sets) clipped to the anchors, its busy time (the union of their intervals)
and its idle gaps.
"""

from __future__ import annotations

import time
from typing import Optional


class Profile:
    """A profiler started and stopped inside the window."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.perf: dict = {}

    def _anchor(self, label: str) -> None:
        rf = self.torch.profiler.record_function
        with rf("cellbench.warm"):
            pass
        self.perf[label] = time.perf_counter()
        with rf(label):
            pass

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # acc_events: a process that profiled before keeps this profile's
        # events (the warm-up below is such a profile)
        return profile(activities=acts, acc_events=True)

    def warm(self) -> None:
        """Profile a moment once in set-up: the profiler's first start
        (CUPTI's set-up, seconds long) then falls outside the window."""
        prof = self._profile()
        prof.start()
        x = self.torch.ones(1024, device="cuda"
                            if self.torch.cuda.is_available() else "cpu")
        float(x.sum())
        prof.stop()
        prof.events()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self._anchor("cellbench.start")

    @property
    def started(self) -> bool:
        return self.prof is not None

    def stop(self) -> None:
        self._anchor("cellbench.stop")
        self.prof.stop()

    def read(self) -> Optional["Timeline"]:
        """The device timeline between the anchors; None when the trace
        has no anchors."""
        ops, marks = [], {}
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type.name == "CUDA":
                if tr.end > tr.start:
                    ops.append((e.name, tr.start, tr.end))
            elif e.name in self.perf:
                marks[e.name] = tr.start
        if "cellbench.start" not in marks or "cellbench.stop" not in marks:
            return None
        offset = marks["cellbench.start"] - self.perf["cellbench.start"] * 1e6
        return Timeline(ops, marks["cellbench.start"],
                        marks["cellbench.stop"], offset)


class Timeline:
    """Device operations in ``[t0, t1]`` (profiler microseconds);
    ``offset_us`` maps ``perf_counter`` seconds onto them:
    ``us = s * 1e6 + offset_us``."""

    def __init__(self, ops: list, t0: float, t1: float, offset_us: float):
        self.t0, self.t1, self.offset_us = float(t0), float(t1), offset_us
        self.ops = [(n, max(s, t0), min(e, t1)) for n, s, e in ops
                    if e > t0 and s < t1]
        merged: list = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy = merged

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def perf_window(self) -> tuple:
        """The traced part in ``perf_counter`` seconds."""
        return ((self.t0 - self.offset_us) / 1e6,
                (self.t1 - self.offset_us) / 1e6)

    def gaps(self) -> list:
        """``(start_us, length_us)`` of every stretch with no device
        operation, the ends of the window included."""
        out, cur = [], self.t0
        for s, e in self.busy:
            if s > cur:
                out.append((cur, s - cur))
            cur = max(cur, e)
        if self.t1 > cur:
            out.append((cur, self.t1 - cur))
        return out

    def top_ops(self, n: int = 10) -> list:
        """``[name, seconds]`` of the ``n`` device operations that took
        most time in the window, summed by name."""
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def top_gaps(self, spans: list, n: int = 10) -> list:
        """``[label, seconds]`` of the ``n`` longest idle gaps, each
        labelled by the innermost host span open where it starts (``no
        span`` when none is)."""
        rows = []
        for start, length in sorted(self.gaps(), key=lambda g: -g[1])[:n]:
            at = (start - self.offset_us) / 1e6
            best = None
            for sp in spans:
                if sp.start_s <= at < sp.start_s + sp.duration_s and (
                        best is None or sp.start_s > best.start_s):
                    best = sp
            rows.append([best.name if best is not None else "no span",
                         length / 1e6])
        return rows
