"""One run of one cell, below the command line: ``execute`` loads the
cell's files, makes its inputs, hands them to the cell's traffic kind (set
up, warm up, measure, check) and returns what ``run.py`` prints.

It does not look for a card: ``run.py`` does, and the tests call
``execute`` on the CPU at small sizes with the timed path broken
underneath.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Optional

from . import registry, work
from .check import Checks
from .timeline import Profile

#: where a ``--trace 1`` run profiles, as shares of ``--seconds``: the
#: traced part starts at ``PROFILE_AT`` and lasts ``PROFILE_SHARE``, at
#: most ``PROFILE_MAX_S``
PROFILE_AT = 0.3
PROFILE_SHARE = 0.3
PROFILE_MAX_S = 2.0


class Window:
    """The measured window: its clock, and the traced part of a ``--trace
    1`` run (started and stopped by ``tick`` between units of work)."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.seconds = float(ctx.seconds)
        self.profile = Profile(ctx.torch) if ctx.trace else None
        self.p_from = PROFILE_AT * self.seconds
        self.p_len = min(PROFILE_MAX_S, PROFILE_SHARE * self.seconds)
        self.p_to = None
        self.stopped = False
        self.t0 = None
        self.t_end = None

    def begin(self) -> float:
        self.ctx.sync()
        gc.callbacks.append(self._gc)
        self.t0 = self.ctx.window_t0 = time.perf_counter()
        return self.t0

    def _gc(self, phase: str, info: dict) -> None:
        """The window's collections by the interpreter's garbage
        collector, timed (``notes``: a pause holds every thread)."""
        if phase == "start":
            self._gc_t = time.perf_counter()
            return
        n = self.ctx.notes
        ms = 1e3 * (time.perf_counter() - self._gc_t)
        n["gc_pauses"] = n.get("gc_pauses", 0) + 1
        n["gc_total_ms"] = n.get("gc_total_ms", 0.0) + ms
        n["gc_max_ms"] = max(n.get("gc_max_ms", 0.0), ms)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def over(self) -> bool:
        return self.elapsed() >= self.seconds

    @property
    def profiling(self) -> bool:
        return (self.profile is not None and self.profile.started
                and not self.stopped)

    def tick(self) -> None:
        if self.profile is None or self.stopped:
            return
        e = self.elapsed()
        if not self.profile.started and e >= self.p_from:
            self.profile.start()
            # the traced part's length counts from when the profiler runs
            self.p_to = self.elapsed() + self.p_len
        elif self.profile.started and e >= self.p_to:
            self.profile.stop()
            self.stopped = True

    def end(self) -> float:
        self.t_end = time.perf_counter()
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        if self.profiling:
            self.profile.stop()
            self.stopped = True
        return self.t_end


class Context:
    """Everything a traffic kind needs for one run."""

    def __init__(self, *, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device: str, control: str,
                 build_dir: Optional[str]):
        import torch

        import mpi_model_tpu_torch as mt
        from mpi_model_tpu_torch.utils import compile_cache, tracing

        self.torch, self.mt = torch, mt
        self.cell, self.config = cell, config
        self.params = dict(cell["params"])
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device = torch.device(device)
        #: the card's published peaks (``peaks.json``); None off the card
        self.peak = (work.peak(torch.cuda.get_device_name(self.device))
                     if self.device.type == "cuda" else None)
        self.control = control
        self.compute_dtype = (torch.bfloat16 if control == "program_bf16"
                              else None)
        self.build_dir = build_dir
        if build_dir is not None:
            compile_cache.configure_compile_cache(build_dir)
        if self.trace:
            # the per-layer readers read the program's spans: a tracer of
            # the program's own default size, on whatever the default
            # says. A ``--trace 0`` run leaves the program's tracer as the
            # program sets it: what it keeps is the program's cost
            tracing.set_tracer(tracing.Tracer(enabled=True))
            Profile(torch).warm()
        self.tracer = tracing.get_tracer()
        self.checks = Checks(cell["limits"])
        self.attempted = 0
        self.failed = 0
        #: end-to-end readings by metric name (``host_clock``)
        self.e2e: dict = {}
        #: what the per-layer readers read (``metrics/<name>.py``)
        self.record: dict = {"cell": cell, "config": config}
        #: ``perf_counter`` at the window's start (set-up ends there)
        self.window_t0 = None
        self.memory_peak_bytes = 0
        self.timeline = None
        self.notes: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def window(self) -> Window:
        return Window(self)

    def read_peak(self) -> None:
        """The process's device peak, read before the reference runs."""
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def close_window(self, w: Window) -> None:
        """Read the traced part and the spans of the window, leaving the
        traced part's out of the spans (the profiler's own host cost)."""
        spans = [s for s in self.tracer.spans
                 if s.start_s >= w.t0 and s.start_s + s.duration_s <= w.t_end]
        self.record["window_s"] = w.t_end - w.t0
        if w.profile is not None and w.profile.started:
            tl = w.profile.read()
            self.timeline = tl
            if tl is not None:
                p0, p1 = tl.perf_window()
                self.record["timeline"] = tl
                self.record["timeline_spans"] = [
                    s for s in spans
                    if s.start_s < p1 and s.start_s + s.duration_s > p0]
                spans = [s for s in spans if s.start_s + s.duration_s <= p0
                         or s.start_s >= p1]
        self.record["spans"] = spans
        self.record["dropped_spans"] = self.tracer.dropped


def execute(cell_name: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", control: str = "none",
            overrides: Optional[dict] = None,
            build_dir: Optional[str] = None,
            root: Path = registry.ROOT) -> Context:
    """One run of ``cell_name``; returns its ``Context`` with the readings,
    the checks and the record the per-layer readers read. ``overrides``
    replaces cell parameters (the tests' small sizes)."""
    cell = registry.cell(cell_name, root)
    if overrides:
        cell = {**cell, "params": {**cell["params"], **overrides}}
    config = registry.config(cell["config"], root)
    ctx = Context(cell=cell, config=config, seed=seed, seconds=seconds,
                  trace=trace, device=device, control=control,
                  build_dir=build_dir)
    registry.traffic(cell["kind"], root).run(ctx)
    return ctx
