"""repro_torch.obs -- metrics and round-lifecycle spans for the FLaaS
server:

* :mod:`repro_torch.obs.metrics` -- the process :class:`MetricsRegistry`
  (counters / gauges / fixed-bucket histograms, lock-safe, a cheap no-op
  when disabled, ``reset()`` / ``scoped()`` for tests);
* :mod:`repro_torch.obs.trace` -- span-based round-lifecycle tracing
  (``submit -> buffer -> flush/replay -> fold -> publish -> serve``) whose
  timers synchronise the card only at span boundaries.
"""
from .metrics import (LATENCY_BUCKETS, REGISTRY, STALENESS_BUCKETS,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, metrics_enabled, set_enabled)
from .trace import EVENT_LOG, ROUND_STAGES, EventLog, Span, span

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "REGISTRY",
    "get_registry", "set_enabled", "metrics_enabled",
    "LATENCY_BUCKETS", "STALENESS_BUCKETS",
    "span", "Span", "EventLog", "EVENT_LOG", "ROUND_STAGES",
]
