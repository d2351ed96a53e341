"""repro_torch.obs -- metrics, round-lifecycle spans, health and export for
the FLaaS server:

* :mod:`repro_torch.obs.metrics` -- the process :class:`MetricsRegistry`
  (counters / gauges / fixed-bucket histograms, lock-safe, a cheap no-op
  when disabled, ``reset()`` / ``scoped()`` for tests);
* :mod:`repro_torch.obs.trace` -- span-based round-lifecycle tracing
  (``submit -> buffer -> flush/replay -> fold -> publish -> serve``) whose
  timers synchronise the card only at span boundaries;
* :mod:`repro_torch.obs.export` -- Prometheus text format, JSON-lines,
  and the in-memory :meth:`MetricsRegistry.snapshot`;
* :mod:`repro_torch.obs.health` -- :class:`ServiceHealth`, the one-call
  operator view over the async aggregation service and the serving
  store;
* :mod:`repro_torch.obs.timing` -- the shared benchmark timing helpers.
"""
from .metrics import (LATENCY_BUCKETS, REGISTRY, STALENESS_BUCKETS,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, metrics_enabled, set_enabled)
from .trace import EVENT_LOG, ROUND_STAGES, EventLog, Span, span
from .export import parse_prometheus, to_prometheus, write_jsonl_snapshot
from .health import ServiceHealth
from .timing import bench_payload, block, time_fn

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "REGISTRY",
    "get_registry", "set_enabled", "metrics_enabled",
    "LATENCY_BUCKETS", "STALENESS_BUCKETS",
    "span", "Span", "EventLog", "EVENT_LOG", "ROUND_STAGES",
    "to_prometheus", "parse_prometheus", "write_jsonl_snapshot",
    "ServiceHealth",
    "block", "time_fn", "bench_payload",
]
