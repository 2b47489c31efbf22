"""Observability subsystem: flight-recorder tracing + unified metrics
(DESIGN.md §12).

``Observability`` bundles the two halves the serving stack shares:

  * ``metrics`` — a ``MetricsRegistry`` that is ALWAYS active (counters
    and fixed-bucket histograms are cheap enough for the hot path) and is
    the single source the stats surfaces read from: the engine's
    ``step_stats()``/``kv_stats()``, the middleware's ``ResourceMonitor``
    snapshot and the overload autopilot, so they can never disagree.
  * ``recorder`` — a ``FlightRecorder`` ring-buffer event log, gated OFF
    by default by ``TraceConfig`` (budget when on: <= 2% of a step's
    wall time).

One ``Observability`` per serving stack: build it once and pass it to the
engine and ``AgentRM`` (the middleware auto-adopts its backend's engine
``obs`` when none is given, so the fused stack shares one clock, one ring
and one registry by default).
"""
from repro_torch.obs.metrics import (LATENCY_BUCKETS_S, Counter, Gauge, Histogram,
                               MetricsRegistry, log_buckets)
from repro_torch.obs.trace import FlightRecorder, TraceConfig, validate_chrome

__all__ = ["Observability", "TraceConfig", "FlightRecorder",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "log_buckets", "LATENCY_BUCKETS_S", "validate_chrome"]


class Observability:
    """Shared tracing + metrics context for one serving stack."""

    def __init__(self, trace: TraceConfig = None,
                 metrics: MetricsRegistry = None):
        self.trace_config = trace or TraceConfig()
        self.recorder = FlightRecorder(self.trace_config)
        self.metrics = metrics or MetricsRegistry()

    @property
    def tracing(self) -> bool:
        return self.recorder.enabled
