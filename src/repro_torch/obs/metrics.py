"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The FLaaS server is a long-lived process; its operational signals (the
async service's intake, rejections, staleness, folds and spans) live in
one place:

* a :class:`MetricsRegistry` holds named instruments; modules create them
  once at import / construction time and cache the handle -- the hot path
  is one ``enabled`` check, one lock, one float add;
* instruments are **Prometheus-shaped**: monotone :class:`Counter`,
  settable :class:`Gauge`, and :class:`Histogram` with *fixed* bucket
  upper edges (``observe`` is O(log buckets), percentiles read back off
  the edges) -- no unbounded per-sample storage, safe for a server that
  never restarts;
* labels follow the Prometheus child model: ``metric.labels(reason=...)``
  returns a cached child; callers on hot paths hold the child, not the
  parent;
* everything is lock-safe (one ``threading.Lock`` per instrument family)
  and **cheap when disabled**: :func:`set_enabled` (or
  ``MetricsRegistry(enabled=False)``) turns every record call into a
  single attribute read and return;
* tests get :meth:`MetricsRegistry.reset` (zero every value, keep the
  instruments -- cached handles stay valid) and
  :meth:`MetricsRegistry.scoped` (save values, zero, restore on exit --
  concurrent-safe snapshots of a shared process registry).

Span timing lives in :mod:`repro_torch.obs.trace`.  See
``docs/observability.md`` for the metric catalog and the overhead
guarantees.
"""
from __future__ import annotations

import bisect
import contextlib
import math
import re
import threading
from typing import Iterable, Mapping, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram edges for latency-in-seconds instruments: ~100us to
#: 30s, geometric -- wide enough for a CPU fold and a kernel launch on a
#: card alike; the overflow (+Inf) bucket is implicit.
LATENCY_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0)

#: default edges for staleness (server versions or wall seconds behind):
#: fine near fresh, coarse in the straggler tail.
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _label_key(labelnames: Sequence[str], labels: Mapping) -> tuple:
    try:
        return tuple(str(labels[n]) for n in labelnames)
    except KeyError:
        missing = [n for n in labelnames if n not in labels]
        raise ValueError(
            f"missing label(s) {missing}; declared labelnames "
            f"{list(labelnames)}") from None


class _Instrument:
    """Base: one named instrument family with optional labels.

    A family with ``labelnames=()`` has exactly one child (itself, label
    key ``()``); labelled families create children on first
    :meth:`labels` call and cache them forever (label cardinality is
    bounded by construction: reasons, codecs, kernel entry names).
    """

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str = "", labelnames: Sequence[str] = ()):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # reentrant: family-level state walks (reset/scoped) hold the
        # lock while touching children, which lock their own updates
        self._lock = threading.RLock()
        self._children: dict[tuple, "_Child"] = {}
        if not self.labelnames:
            self._default = self._make_child(())
            self._children[()] = self._default
        else:
            self._default = None

    # -- child management ------------------------------------------------
    def _make_child(self, key: tuple) -> "_Child":
        raise NotImplementedError

    def labels(self, **labels) -> "_Child":
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child(key))
        return child

    # -- introspection ---------------------------------------------------
    def samples(self) -> dict:
        """``{label_key_string: value-ish}`` for every live child."""
        with self._lock:
            items = list(self._children.items())
        return {",".join(f"{n}={v}" for n, v in zip(self.labelnames, key)):
                child._sample() for key, child in items}

    def _state(self):
        with self._lock:
            return {k: c._get_state() for k, c in self._children.items()}

    def _restore(self, state) -> None:
        with self._lock:
            for k, c in self._children.items():
                c._set_state(state.get(k))

    def _reset(self) -> None:
        with self._lock:
            for c in self._children.values():
                c._set_state(None)


class _Child:
    """One (instrument, label values) time series."""

    def __init__(self, family: _Instrument, key: tuple):
        self._family = family
        self._key = key
        self._lock = family._lock

    @property
    def _enabled(self) -> bool:
        return self._family._registry.enabled

    def _sample(self):
        raise NotImplementedError

    def _get_state(self):
        raise NotImplementedError

    def _set_state(self, state) -> None:
        """``None`` means zero."""
        raise NotImplementedError


class _CounterChild(_Child):
    def __init__(self, family, key):
        super().__init__(family, key)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        if amount < 0:
            raise ValueError(f"counters are monotone; inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _sample(self):
        return self._value

    def _get_state(self):
        return self._value

    def _set_state(self, state):
        self._value = 0.0 if state is None else state


class Counter(_Instrument):
    """Monotone counter family.  ``counter.inc()`` on the unlabelled
    default child; ``counter.labels(reason="x").inc()`` on a labelled
    one."""

    kind = "counter"

    def _make_child(self, key):
        return _CounterChild(self, key)

    def inc(self, amount: float = 1.0) -> None:
        if self._default is None:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; use "
                ".labels(...)")
        self._default.inc(amount)

    @property
    def value(self) -> float:
        if self._default is None:
            raise ValueError(f"{self.name} is labelled; read .samples()")
        return self._default.value


class _GaugeChild(_Child):
    def __init__(self, family, key):
        super().__init__(family, key)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _sample(self):
        return self._value

    def _get_state(self):
        return self._value

    def _set_state(self, state):
        self._value = 0.0 if state is None else state


class Gauge(_Instrument):
    """Point-in-time value family (buffer depth, page occupancy, store
    version)."""

    kind = "gauge"

    def _make_child(self, key):
        return _GaugeChild(self, key)

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    @property
    def value(self) -> float:
        return self._default.value


class _HistogramChild(_Child):
    def __init__(self, family, key):
        super().__init__(family, key)
        n = len(family.buckets)
        self._counts = [0] * (n + 1)        # + overflow (+Inf) bucket
        self._sum = 0.0
        self._count = 0
        self._max = None

    def observe(self, value: float) -> None:
        if not self._enabled:
            return
        value = float(value)
        # bucket semantics are Prometheus ``le``: value v lands in the
        # first bucket whose upper edge e satisfies v <= e
        i = bisect.bisect_left(self._family.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float | None:
        """Bucket-resolution quantile: the upper edge of the bucket in
        which the q-quantile observation falls (the overflow bucket
        reports the max observed value).  ``None`` with no observations.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self._count
            if total == 0:
                return None
            target = q * total
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target and c:
                    if i < len(self._family.buckets):
                        return float(self._family.buckets[i])
                    return float(self._max)
            return float(self._max)

    def _sample(self):
        with self._lock:
            return {
                "buckets": [[float(e), int(c)] for e, c in
                            zip(self._family.buckets, self._counts)],
                "overflow": int(self._counts[-1]),
                "sum": self._sum, "count": self._count,
                "max": self._max,
            }

    def _get_state(self):
        with self._lock:
            return (list(self._counts), self._sum, self._count, self._max)

    def _set_state(self, state):
        with self._lock:
            if state is None:
                self._counts = [0] * len(self._counts)
                self._sum, self._count, self._max = 0.0, 0, None
            else:
                self._counts, self._sum, self._count, self._max = \
                    list(state[0]), state[1], state[2], state[3]


class Histogram(_Instrument):
    """Fixed-bucket histogram family.  ``buckets`` are the finite upper
    edges (strictly increasing); an overflow (+Inf) bucket is implicit.
    """

    kind = "histogram"

    def __init__(self, registry, name, help="", labelnames=(),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        buckets = tuple(float(b) for b in buckets)
        if not buckets:
            raise ValueError("histogram needs at least one bucket edge")
        if any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            raise ValueError(
                f"bucket edges must be strictly increasing: {buckets}")
        if any(math.isnan(b) or math.isinf(b) for b in buckets):
            raise ValueError(f"bucket edges must be finite: {buckets}")
        self.buckets = buckets
        super().__init__(registry, name, help, labelnames)

    def _make_child(self, key):
        return _HistogramChild(self, key)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    @property
    def count(self) -> int:
        return self._default.count

    @property
    def sum(self) -> float:
        return self._default.sum

    def percentile(self, q: float) -> float | None:
        return self._default.percentile(q)


class MetricsRegistry:
    """Named instruments, get-or-create, process-lifetime.

    ``counter`` / ``gauge`` / ``histogram`` return the existing
    instrument when the name is already registered (re-registration with
    a conflicting kind, labelnames, or buckets raises -- a name means one
    thing).  Instruments are cheap to look up but callers on hot paths
    should cache the handle (and the labelled child) once.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict[str, _Instrument] = {}

    # -- construction ----------------------------------------------------
    def _register(self, cls, name, help, labelnames, **kw) -> _Instrument:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad metric name {name!r}: must match {_NAME_RE.pattern}")
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if not isinstance(got, cls):
                    raise ValueError(
                        f"{name} already registered as {got.kind}")
                if got.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"{name} already registered with labels "
                        f"{got.labelnames}, not {tuple(labelnames)}")
                if kw.get("buckets") is not None and \
                        tuple(kw["buckets"]) != got.buckets:
                    raise ValueError(
                        f"{name} already registered with buckets "
                        f"{got.buckets}")
                return got
            inst = (cls(self, name, help, labelnames, **{
                k: v for k, v in kw.items() if v is not None})
                if cls is Histogram
                else cls(self, name, help, labelnames))
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] | None = None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    # -- introspection ---------------------------------------------------
    def get(self, name: str) -> _Instrument | None:
        return self._metrics.get(name)

    def collect(self) -> Iterable[_Instrument]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """One consistent, JSON-serializable view of every instrument:
        ``{"counters": {name: {label_key: v}}, "gauges": ...,
        "histograms": {name: {label_key: {buckets, sum, count, max}}}}``.
        Safe under concurrent writers: each child is read under its
        family lock.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in self.collect():
            out[inst.kind + "s"][inst.name] = inst.samples()
        return out

    # -- lifecycle (tests) -----------------------------------------------
    def reset(self) -> None:
        """Zero every value; instruments and cached children survive."""
        for inst in self.collect():
            inst._reset()

    @contextlib.contextmanager
    def scoped(self):
        """Save all values, zero them, restore on exit -- an isolated
        measurement window over a shared registry.  Cached instrument
        handles keep working inside and after the scope."""
        saved = [(inst, inst._state()) for inst in self.collect()]
        was_enabled = self.enabled
        for inst, _ in saved:
            inst._reset()
        self.enabled = True
        try:
            yield self
        finally:
            self.enabled = was_enabled
            for inst, state in saved:
                inst._restore(state)


#: the process-default registry every repro_torch module instruments against;
#: pass an explicit registry to services that need isolation.
REGISTRY = MetricsRegistry(enabled=True)


def get_registry() -> MetricsRegistry:
    return REGISTRY


def set_enabled(enabled: bool) -> bool:
    """Flip metric recording on the default registry; returns the
    previous state.  Disabled recording is a single attribute check per
    call -- the documented overhead guarantee (``docs/observability.md``)
    is gated in CI against this switch."""
    prev = REGISTRY.enabled
    REGISTRY.enabled = bool(enabled)
    return prev


def metrics_enabled() -> bool:
    return REGISTRY.enabled


__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "REGISTRY", "get_registry", "set_enabled", "metrics_enabled",
           "LATENCY_BUCKETS", "STALENESS_BUCKETS"]
