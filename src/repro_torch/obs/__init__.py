"""repro_torch.obs -- metrics, round-lifecycle spans, health and export for
the FLaaS server:

* :mod:`repro_torch.obs.metrics` -- the process :class:`MetricsRegistry`
  (counters / gauges / fixed-bucket histograms, lock-safe, a cheap no-op
  when disabled, ``reset()`` / ``scoped()`` for tests);
* :mod:`repro_torch.obs.trace` -- span-based round-lifecycle tracing
  (``submit -> buffer -> flush/replay -> fold -> publish -> serve``) whose
  timers synchronise the card only at span boundaries, and the program's
  trace recorder :data:`TRACE` (below);
* :mod:`repro_torch.obs.export` -- Prometheus text format, JSON-lines,
  and the in-memory :meth:`MetricsRegistry.snapshot`;
* :mod:`repro_torch.obs.health` -- :class:`ServiceHealth`, the one-call
  operator view over the async aggregation service and the serving
  store.

**Tracing, for an operator.**  The program names its own work on the
profiler's timeline and records it in :data:`TRACE`, which is off until
asked for: run the program under ``torch.profiler.profile(...)`` (the
recording steps of a schedule; not its warm-up) or call
``set_tracing(True)``.  Each span enters ``record_function
("repro_torch.<name>")`` and leaves a record ``{"name", "id", "parent",
"thread", "start_ns", "end_ns", "device_s"}`` with its start and end on
``time.time_ns()``, the clock the profiler's events are on (kineto's
``trace_start_ns()`` plus an event's start); ``device_s`` comes from a
CUDA event pair where the span marks device work.  Counters:
``read_back`` (every host read of a device value, by site: ``validate``,
``codec``, ``plan.spec``, ``strategy``, ``span.block``; a count and the
host seconds waited) and ``plan_cache`` (``hit``, ``miss``).  The
recorder holds the latest session (a new one starts when tracing turns
on again); read it with ``trace_session()``, or write it out with
``TRACE.write_jsonl(path)``.  Off, each site costs one check.  Nothing
traced reaches a :class:`MetricsRegistry`, ``ServiceHealth`` or the
Prometheus and JSON-lines exports.
"""
from .metrics import (LATENCY_BUCKETS, REGISTRY, STALENESS_BUCKETS,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, metrics_enabled, set_enabled)
from .trace import (EVENT_LOG, ROUND_STAGES, TRACE, EventLog, Span, count,
                    read_back, set_tracing, span, trace_session, trace_span,
                    tracing)
from .export import parse_prometheus, to_prometheus, write_jsonl_snapshot
from .health import ServiceHealth

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "REGISTRY",
    "get_registry", "set_enabled", "metrics_enabled",
    "LATENCY_BUCKETS", "STALENESS_BUCKETS",
    "span", "Span", "EventLog", "EVENT_LOG", "ROUND_STAGES",
    "TRACE", "tracing", "set_tracing", "trace_span", "trace_session",
    "read_back", "count",
    "to_prometheus", "parse_prometheus", "write_jsonl_snapshot",
    "ServiceHealth",
]
