"""Timing helpers and serving counters (counterpart of
``mpi_model_tpu/utils/metrics.py``; the port keeps its own copy and
imports nothing of the JAX package).

- The marginal timing helpers, under the JAX package's names and
  signatures: a step's cost is ``(t(s2) - t(s1)) / (s2 - s1)`` between two
  run lengths, so a call's fixed cost cancels. The JAX package's scan of
  ``s`` steps is here a loop of ``s`` calls of ``step`` on a fresh clone of
  the values made outside the timed region (the clone is what ``donate``
  means here: the loop may consume it); completion is forced by
  synchronizing the devices of the values the loop returns, so no
  asynchronous launch is ever timed. ``marginal_step_time``,
  ``marginal_step_trials``, ``interleaved_ab`` (steps), and
  ``marginal_runner_time``, ``marginal_runner_trials`` (a runner that
  blocks until its work is done); ``median_spread`` and
  ``positive_spread`` give the JAX package's dicts.
- ``LatencyReservoir``: a bounded, self-locked reservoir of latency samples
  with nearest-rank p50/p99.
- ``ThroughputCounter``: monotonic serving counters and the derived
  metrics ``snapshot()`` publishes (``scenarios_per_s``,
  ``batch_occupancy``, ``compile_cache_hit_rate``, latency percentiles),
  with the JAX package's key names.

``ThroughputCounter``'s lock is made through ``resilience.lockdep`` under
the JAX package's key (``"ThroughputCounter._lock"``): a plain
``threading.Lock`` while the witness is disarmed. The reservoir's leaf lock
is a plain lock, as in the JAX package.
"""

from __future__ import annotations

import collections
import statistics
import threading
import time
from typing import Callable, Optional

import torch

from ..resilience import lockdep

Values = dict


def _tree_map(fn, tree):
    """``fn`` on every tensor of a dict/list/tuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _block(tree) -> None:
    """Wait until the work behind every card tensor of ``tree`` is done
    (one synchronize a device)."""
    devices = set()
    _tree_map(lambda t: devices.add(t.device), tree)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _fresh(values: Values, donate: bool):
    """The run's input: a clone of ``values`` when the loop may consume
    it (``donate``), else ``values`` itself."""
    return _tree_map(torch.clone, values) if donate else values


def _loop_runner(step: Callable, steps: int) -> Callable:
    """``run(values)``: ``steps`` calls of ``step``, then a wait for the
    result (the JAX package's scan and its fetched reduction)."""
    def run(values):
        for _ in range(steps):
            values = step(values)
        _block(values)
        return values
    return run


def _timed(run: Callable, values: Values, donate: bool) -> float:
    """Wall seconds of one ``run`` on a fresh input, the input's copy made
    and finished before the clock starts."""
    fresh = _fresh(values, donate)
    _block(fresh)
    t0 = time.perf_counter()
    run(fresh)
    return time.perf_counter() - t0


def _scan_runners(step: Callable, values: Values, lengths: tuple,
                  donate: bool = True) -> dict:
    """One warmed runner a run length (builds and lazy caches fill here,
    never inside a timed region): length → ``run(values)``."""
    runners = {}
    for steps in lengths:
        run = _loop_runner(step, steps)
        run(_fresh(values, donate))
        runners[steps] = run
    return runners


def marginal_step_time(step: Callable, values: Values, s1: int = 50,
                       s2: int = 250, reps: int = 2,
                       donate: bool = True) -> float:
    """Seconds per step of ``step`` (a Values→Values function), measured
    marginally between run lengths ``s1`` and ``s2`` on fresh clones of
    ``values`` (``donate``), best of ``reps``, each length warmed once."""
    runners = _scan_runners(step, values, (s1, s2), donate)
    times = {steps: min(_timed(runners[steps], values, donate)
                        for _ in range(reps)) for steps in (s1, s2)}
    return (times[s2] - times[s1]) / (s2 - s1)


def _marginal_sample(runners: dict, values: Values, s1: int, s2: int,
                     donate: bool = True) -> float:
    """One marginal per-step estimate from warmed runners, both lengths
    timed back to back so drift of the card's state hits both arms."""
    ts = {steps: _timed(runners[steps], values, donate)
          for steps in (s1, s2)}
    return (ts[s2] - ts[s1]) / (s2 - s1)


def marginal_step_trials(step: Callable, values: Values, s1: int = 10,
                         s2: int = 60, trials: int = 5,
                         donate: bool = True) -> list[float]:
    """``trials`` independent marginal per-step estimates (seconds), the
    two run lengths timed back to back within each trial after one
    warm-up each; callers take the median and report the spread."""
    runners = _scan_runners(step, values, (s1, s2), donate)
    return [_marginal_sample(runners, values, s1, s2, donate)
            for _ in range(trials)]


def marginal_runner_trials(make_output: Callable[[int], object],
                           s1: int = 10, s2: int = 40,
                           trials: int = 3) -> list[float]:
    """``trials`` marginal per-step estimates for an arbitrary runner
    (``make_output(num_steps)`` must block until the work is done), the two
    lengths back to back within a trial. Call ``make_output(s1)`` once
    first if warm-up must not reach trial 1: every call made here is
    timed."""
    out: list[float] = []
    for _ in range(trials):
        ts = {}
        for steps in (s1, s2):
            t0 = time.perf_counter()
            make_output(steps)
            ts[steps] = time.perf_counter() - t0
        out.append((ts[s2] - ts[s1]) / (s2 - s1))
    return out


def marginal_runner_time(make_output: Callable[[int], object],
                         s1: int = 10, s2: int = 50,
                         reps: int = 2) -> float:
    """Marginal per-step seconds for an arbitrary runner: calls
    ``make_output(num_steps)`` (which must block until the work is done;
    it may be a subprocess run) at two step counts, each warmed once, best
    of ``reps``."""
    times = {}
    for steps in (s1, s2):
        make_output(steps)  # warm-up: builds, caches, page-in
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            make_output(steps)
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    return (times[s2] - times[s1]) / (s2 - s1)


def interleaved_ab(steps: dict, values: Values, *, s1: int = 5,
                   s2: int = 25, reps: int = 4,
                   spread: bool = False) -> dict:
    """Interleaved A/B medians: every arm's two runners are built and
    warmed first, then each round takes one marginal sample per arm, the
    arms in turn, so drift hits every arm of a round together. ``steps``
    maps arm name → step function; returns arm name → median seconds per
    step, or with ``spread=True`` arm name → ``median_spread`` of its
    samples."""
    runners = {name: _scan_runners(step, values, (s1, s2))
               for name, step in steps.items()}
    times: dict = {name: [] for name in steps}
    for _ in range(reps):
        for name in steps:
            times[name].append(
                _marginal_sample(runners[name], values, s1, s2))
    if spread:
        return {name: median_spread(ts) for name, ts in times.items()}
    return {name: statistics.median(ts) for name, ts in times.items()}


def positive_spread(samples: list[float], scale: float) -> dict:
    """``{lo, hi}`` of ``scale / t`` over the positive samples (a noisy
    marginal estimate can be zero or negative, and carries no spread); None
    fields when none is positive."""
    pos = [s for s in samples if s > 0]
    return {"lo": scale / max(pos) if pos else None,
            "hi": scale / min(pos) if pos else None}


def median_spread(samples: list[float]) -> dict:
    """``{value: median, spread_lo: min, spread_hi: max}`` of the
    samples."""
    return {"value": statistics.median(samples),
            "spread_lo": min(samples), "spread_hi": max(samples)}

#: latency samples kept for the percentile fields: bounded, so a long-lived
#: service reports the p50/p99 of its recent traffic
LATENCY_RESERVOIR = 65536


class LatencyReservoir:
    """The most recent ``maxlen`` latency samples behind their own leaf lock
    (nothing is acquired under it)."""

    def __init__(self, maxlen: int = LATENCY_RESERVOIR):
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(
            maxlen=int(maxlen))

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    @staticmethod
    def percentile_of(sorted_samples: list, q: float):
        """Nearest-rank percentile over an already-sorted list (None when
        empty)."""
        if not sorted_samples:
            return None
        i = min(int(round(q * (len(sorted_samples) - 1))),
                len(sorted_samples) - 1)
        return sorted_samples[i]

    def snapshot(self, prefix: str = "latency") -> dict:
        """One consistent cut: ``{<prefix>_n, <prefix>_p50_s,
        <prefix>_p99_s}``."""
        with self._lock:
            samples = sorted(self._samples)
        return {
            f"{prefix}_n": len(samples),
            f"{prefix}_p50_s": self.percentile_of(samples, 0.50),
            f"{prefix}_p99_s": self.percentile_of(samples, 0.99),
        }


class ThroughputCounter:
    """Monotonic serving counters: scenarios served, dispatches, dispatched
    lanes (bucket padding included), busy wall seconds, runner-cache hits,
    and the self-healing ledger (solo retries, recovered failures,
    quarantines, impl faults, expiries).

    Thread-safe: every mutation goes through ``record_dispatch``,
    ``record_latency`` or ``bump``, each under the one internal lock, and
    ``snapshot()`` is taken under the same lock, so it is one consistent cut.

    ``snapshot()`` derives ``scenarios_per_s`` (scenarios / busy seconds,
    the dispatch wall only, so queueing time is not billed as compute),
    ``batch_occupancy`` (real lanes / dispatched lanes),
    ``compile_cache_hit_rate`` (dispatches that reused a built runner) and
    the queue-latency and wake-latency percentiles, with the JAX package's
    keys.
    """

    #: the integer counters ``bump`` accepts: a misspelt name fails loudly
    COUNTERS = ("dispatches", "scenarios", "lanes", "cache_hits",
                "solo_retries", "recovered_failures", "quarantined",
                "impl_faults", "shed", "expired", "loop_faults",
                "member_faults", "readmitted", "scale_ups", "scale_downs",
                "respawns", "heartbeats", "heartbeat_misses",
                "wire_errors", "hibernations", "rehibernations",
                "wakes", "wake_faults", "supervisor_kills",
                "stale_epoch_rejections")

    def __init__(self):
        self._lock = lockdep.lock("ThroughputCounter._lock")
        for name in self.COUNTERS:
            setattr(self, name, 0)
        self.busy_s = 0.0
        #: launch-to-complete span per dispatch, summed (the time a dispatch
        #: was outstanding); equal to busy_s on the synchronous path
        self.inflight_s = 0.0
        self._latencies = LatencyReservoir()
        #: each wake's wall seconds materializing its scenario (the tiering
        #: vault's chain restore, or its journal fallback)
        self._wake_latencies = LatencyReservoir()

    def record_dispatch(self, scenarios: int, bucket: int, wall_s: float,
                        cache_hit: bool,
                        inflight_s: Optional[float] = None) -> None:
        with self._lock:
            self.dispatches += 1
            self.scenarios += int(scenarios)
            self.lanes += int(bucket)
            self.busy_s += float(wall_s)
            self.inflight_s += float(wall_s if inflight_s is None
                                     else inflight_s)
            if cache_hit:
                self.cache_hits += 1

    def bump(self, name: str, n: int = 1) -> None:
        """Increment one named counter under the lock."""
        if name not in self.COUNTERS:
            raise ValueError(
                f"unknown counter {name!r} (expected one of "
                f"{self.COUNTERS})")
        with self._lock:
            setattr(self, name, getattr(self, name) + int(n))

    def busy_per_scenario(self) -> Optional[float]:
        """Busy seconds per served scenario (None before any serve): an O(1)
        read for admission's retry-after estimate, which must not pay
        ``snapshot()``'s reservoir sort."""
        with self._lock:
            return self.busy_s / self.scenarios if self.scenarios else None

    def record_latency(self, seconds: float) -> None:
        """One served scenario's submit-to-served latency (scheduler
        clock)."""
        self._latencies.record(seconds)

    def record_wake_latency(self, seconds: float) -> None:
        """One wake's wall seconds (wall even under a fake scheduler
        clock), feeding ``wake_latency_p50_s``/``wake_latency_p99_s``."""
        self._wake_latencies.record(seconds)

    def snapshot(self) -> dict:
        # the reservoirs hold their own leaf locks: read them first
        lat = self._latencies.snapshot("latency")
        wlat = self._wake_latencies.snapshot("wake_latency")
        with self._lock:
            out = {
                "dispatches": self.dispatches,
                "scenarios": self.scenarios,
                "scenarios_per_s": (self.scenarios / self.busy_s
                                    if self.busy_s > 0 else None),
                "batch_occupancy": (self.scenarios / self.lanes
                                    if self.lanes else None),
                "compile_cache_hits": self.cache_hits,
                "compile_cache_hit_rate": (self.cache_hits / self.dispatches
                                           if self.dispatches else None),
                "busy_s": self.busy_s,
                "inflight_s": self.inflight_s,
            }
            out.update({name: getattr(self, name)
                        for name in self.COUNTERS[4:]})
        out.update(lat)
        out.update(wlat)
        return out
