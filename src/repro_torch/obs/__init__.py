"""Observability: request-lifecycle tracing + metrics registry.

``repro_torch.obs`` imports nothing from the rest of the package, so any layer
(serve, tune, benchmarks) can depend on it without cycles.
"""
from repro_torch.obs.metrics import (QUANTA_BUCKETS, TIME_BUCKETS, Counter, Gauge,
                               Histogram, Registry)
from repro_torch.obs.trace import (ENGINE_TRACK, LIFECYCLE, NULL_TRACER,
                             REQ_TRACK_BASE, SCHED_TRACK, TERMINAL_STATES,
                             TraceRecorder)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "TIME_BUCKETS", "QUANTA_BUCKETS",
    "TraceRecorder", "NULL_TRACER",
    "ENGINE_TRACK", "SCHED_TRACK", "REQ_TRACK_BASE",
    "LIFECYCLE", "TERMINAL_STATES",
]
