"""Serving counters of the ensemble scheduler (counterpart of
``mpi_model_tpu/utils/metrics.py:199-460``; the port keeps its own copy and
imports nothing of the JAX package).

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
import threading
from typing import Optional

from ..resilience import lockdep

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
