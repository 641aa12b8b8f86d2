"""Utilities: the serving counters (``metrics``), tracing (``tracing``),
the roofline read from the card (``roofline``) and the kernel build cache
(``compile_cache``). The JAX package's measurement helpers in its
``utils/metrics.py`` (``marginal_step_time``, ``interleaved_ab``, ...) come
with the port's benchmark."""

from .compile_cache import configure_compile_cache, configured_dir
from .metrics import LatencyReservoir, ThroughputCounter
from .roofline import chip_peaks, stencil_roofline
from .tracing import Span, Tracer, get_tracer, set_tracer, trace_span

__all__ = [
    "LatencyReservoir",
    "ThroughputCounter",
    "configure_compile_cache",
    "configured_dir",
    "chip_peaks",
    "stencil_roofline",
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "trace_span",
]
