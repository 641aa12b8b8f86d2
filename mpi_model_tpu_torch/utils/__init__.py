"""Utilities: the serving counters (``metrics``)."""

from .metrics import LatencyReservoir, ThroughputCounter

__all__ = ["LatencyReservoir", "ThroughputCounter"]
