"""Utilities: the timing helpers and serving counters (``metrics``),
tracing (``tracing``), the roofline read from the card (``roofline``) and
the kernel build cache (``compile_cache``)."""

from .compile_cache import configure_compile_cache, configured_dir
from .metrics import (LatencyReservoir, ThroughputCounter, interleaved_ab,
                      marginal_runner_time, marginal_runner_trials,
                      marginal_step_time, marginal_step_trials,
                      median_spread, positive_spread)
from .roofline import chip_peaks, stencil_roofline
from .tracing import Span, Tracer, get_tracer, set_tracer, trace_span

__all__ = [
    "LatencyReservoir",
    "ThroughputCounter",
    "configure_compile_cache",
    "configured_dir",
    "marginal_step_time",
    "marginal_step_trials",
    "median_spread",
    "positive_spread",
    "marginal_runner_time",
    "marginal_runner_trials",
    "interleaved_ab",
    "chip_peaks",
    "stencil_roofline",
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "trace_span",
]
