"""Span-based round-lifecycle tracing with device-aware timers, and the
program's trace recorder on the profiler's clock.

The aggregation service's round lifecycle is::

    submit -> buffer -> flush/replay -> fold -> publish -> serve

Each stage is wrapped in a :func:`span`: a context manager that measures
wall time into the ``obs_span_seconds{stage=...}`` histogram and
(optionally) appends a JSON-serialisable event to an :class:`EventLog`.

Two rules:

* **Synchronise only at span boundaries.**  CUDA launches are
  asynchronous; a naive timer measures the enqueue, not the work.  A span
  caller hands the stage's *result* to :meth:`Span.block` (or passes
  ``block_on=``) and the span synchronises each CUDA device that holds one
  of its tensor leaves exactly once, at the boundary; CPU tensors need
  nothing.
* **Never record inside a compiled region.**  While
  ``torch.compiler.is_compiling()`` is true a span is a complete no-op --
  no timing call, nothing captured into the graph.

**Tracing.**  Beside the registry's histograms, the program traces where
its work happens: the service's intake (``fl.validate``), the strategy's
plan (``plan``, ``plan.build``) and stacking (``strategy.stack``), the
grouped aggregation and ``ssd_scan`` launches (``kernel.grouped_launch``,
``kernel.ssd_scan``), a training step's phases (``train.step`` with
``train.forward``, ``train.backward``, ``train.optimizer``), every host
read of a device value (the ``read_back`` counter, by site) and the plan
cache's lookups (the ``plan_cache`` counter, ``hit`` and ``miss``).

* **On and off.**  Tracing is on while a ``torch.profiler`` session
  records (``torch.autograd._profiler_enabled()``; a schedule's warm-up
  step does not record) or while :func:`set_tracing` has switched it on;
  never inside a compiled region.  Off, a span, count or read-back site
  costs the one :func:`tracing` check and nothing else: no
  ``record_function``, no clock read, no CUDA event.
* **What a span does while tracing.**  It enters
  ``torch.profiler.record_function("repro_torch.<name>")``, so the
  profiler's host timeline and device trace carry the program's names,
  and appends one record to :data:`TRACE`: ``{"event": "span", "name",
  "id", "parent" (the id of the span open around it on its thread, or
  None), "thread", "start_ns", "end_ns", "device_s"}``.  Start and end
  are ``time.time_ns()``, the profiler's clock (kineto's
  ``trace_start_ns()`` plus an event's start, in microseconds).  A span
  that marks device work (``device=``) records its device time: a CUDA
  event pair on the device's current stream, resolved only when the
  recorder is read; on the CPU its host duration.  Others leave
  ``device_s`` None.  The four registry spans keep their histograms and
  blocks as before; new spans and counters never touch a
  ``MetricsRegistry``.
* **Sessions.**  :data:`TRACE` holds the latest tracing session only: the
  first site that finds tracing on after one that found it off clears its
  ring and counters.  Its ring is bounded; a record that falls off is
  counted in ``dropped``.
* **Reading and writing it out.**  :func:`trace_session` returns
  ``{"spans": [...], "counters": {name: {site: [n, seconds]}},
  "dropped": n}`` with every device time resolved;
  ``TRACE.write_jsonl(path)`` appends the same as JSON lines (each span
  record, then one ``{"event": "counter", ...}`` line a site), and
  ``TRACE.attach_jsonl(path)`` streams each record as its span closes,
  before its device time is resolved.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Any

import torch

from repro_torch.tree import tree_leaves

from .metrics import LATENCY_BUCKETS, get_registry

#: the canonical round-lifecycle stages (free-form stage names are
#: allowed; these are the ones the service emits)
ROUND_STAGES = ("submit", "buffer", "flush", "replay", "fold", "publish",
                "serve")


def _trace_clean() -> bool:
    """True when no compiler is tracing this frame (spans may run)."""
    return not torch.compiler.is_compiling()


def tracing() -> bool:
    """True while the program traces: a ``torch.profiler`` session records
    or :func:`set_tracing` switched it on, outside a compiled region.  The
    first call that finds it on after one that found it off starts a new
    session of :data:`TRACE`."""
    if torch.compiler.is_compiling():
        return False
    rec = TRACE
    if rec.forced or torch.autograd._profiler_enabled():
        if not rec.live:
            rec.new_session()
        return True
    rec.live = False
    return False


def set_tracing(on: bool) -> None:
    """The operator's switch: trace with no profiler running (``on``), or
    only while one records (the default)."""
    TRACE.forced = bool(on)


def count(name: str, site: str, seconds: float = 0.0) -> None:
    """While tracing, one more ``name`` at ``site`` in :data:`TRACE`'s
    counters, with ``seconds`` of host time."""
    if tracing():
        TRACE.count(name, site, seconds)


def read_back(site: str, read, x: torch.Tensor):
    """``read(x)``: a host read of ``x``'s value (``bool``, ``int``, a copy
    to the host), for a device tensor one synchronisation with the card.
    While tracing, one ``read_back`` at ``site`` with the seconds the host
    waited."""
    if not tracing():
        return read(x)
    t0 = time.perf_counter()
    out = read(x)
    TRACE.count("read_back", site, time.perf_counter() - t0)
    return out


def _synchronize(tree: Any) -> None:
    """Wait once for every CUDA device that holds a tensor leaf of
    ``tree``; CPU tensors (and non-tensors) need no wait.  While tracing,
    each wait is a ``read_back`` at ``span.block``."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        if tracing():
            t0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            TRACE.count("read_back", "span.block", time.perf_counter() - t0)
        else:
            torch.cuda.synchronize(dev)


def _write(fh, event: dict) -> None:
    fh.write(json.dumps(event) + "\n")


class EventLog:
    """Bounded in-memory event ring with an optional JSON-lines sink.

    ``log(event)`` appends a dict; with :meth:`attach_jsonl` every event
    is also written as one JSON line.  An event that pushes the oldest off
    a full ring is counted in :attr:`dropped`.  As the trace recorder
    (:data:`TRACE`) it also keeps named counters by site, the CUDA event
    pairs of its span records until they are read, and the tracing
    switch and session state.  Thread-safe.
    """

    def __init__(self, maxlen: int = 4096):
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._sink = None
        self._sink_path = None
        self._counters: dict = {}
        self._pending: list = []
        self.dropped = 0
        #: :func:`set_tracing`'s switch; whether the last check found
        #: tracing on (a session is open)
        self.forced = False
        self.live = False

    def attach_jsonl(self, path) -> None:
        """Start appending every event as a JSON line to ``path``."""
        with self._lock:
            if self._sink is not None:
                self._sink.close()
            self._sink = open(path, "a")
            self._sink_path = path

    def detach(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
            self._sink = None
            self._sink_path = None

    def log(self, event: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)
            if self._sink is not None:
                _write(self._sink, event)
                self._sink.flush()

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counters = {}
            self._pending = []
            self.dropped = 0

    def new_session(self) -> None:
        """Forget the last session and open a new one."""
        self.clear()
        self.live = True

    def count(self, name: str, site: str, seconds: float = 0.0) -> None:
        with self._lock:
            c = self._counters.setdefault(name, {}).setdefault(site,
                                                                [0, 0.0])
            c[0] += 1
            c[1] += seconds

    def counters(self) -> dict:
        """``{name: {site: [count, seconds]}}``, a copy."""
        with self._lock:
            return {n: {s: list(v) for s, v in sites.items()}
                    for n, sites in self._counters.items()}

    def pend(self, record: dict, start, end) -> None:
        """Resolve ``record["device_s"]`` from CUDA events ``start`` and
        ``end`` when the log is next read."""
        with self._lock:
            self._pending.append((record, start, end))

    def session(self) -> dict:
        """The session: span records with their device times resolved (a
        wait for each pending end event), counters and ``dropped``."""
        with self._lock:
            pending, self._pending = self._pending, []
        for record, start, end in pending:
            end.synchronize()
            record["device_s"] = start.elapsed_time(end) * 1e-3
        return {"spans": self.events(), "counters": self.counters(),
                "dropped": self.dropped}

    def write_jsonl(self, path) -> None:
        """Append :meth:`session` to ``path`` as JSON lines: each span
        record, then ``{"event": "counter", "name", "site", "n",
        "seconds"}`` a site, then ``{"event": "dropped", "n"}``."""
        s = self.session()
        with open(path, "a") as fh:
            for record in s["spans"]:
                _write(fh, record)
            for name, sites in s["counters"].items():
                for site, (n, sec) in sites.items():
                    _write(fh, {"event": "counter", "name": name,
                                "site": site, "n": n, "seconds": sec})
            _write(fh, {"event": "dropped", "n": s["dropped"]})


#: process-default event log; spans write here when ``log=True``
EVENT_LOG = EventLog()

#: the trace recorder: the latest tracing session's span records and
#: counters (separate from :data:`EVENT_LOG`)
TRACE = EventLog(maxlen=1 << 16)

_IDS = itertools.count(1)
_OPEN = threading.local()          # each thread's stack of open span ids


def trace_session() -> dict:
    """:data:`TRACE`'s latest session (see :meth:`EventLog.session`)."""
    return TRACE.session()


class _Record:
    """One span's trace while tracing: its ``record_function``, its record
    and, on a CUDA device, its event pair."""

    __slots__ = ("record", "_rf", "_stream", "_start", "_cpu")

    def __init__(self, name: str, device):
        stack = getattr(_OPEN, "ids", None)
        if stack is None:
            stack = _OPEN.ids = []
        rid = next(_IDS)
        self.record = {"event": "span", "name": name, "id": rid,
                       "parent": stack[-1] if stack else None,
                       "thread": threading.get_ident(), "start_ns": 0,
                       "end_ns": 0, "device_s": None}
        stack.append(rid)
        dev = device.device if isinstance(device, torch.Tensor) else device
        self._cpu = dev is not None and torch.device(dev).type != "cuda"
        self._stream = (torch.cuda.current_stream(dev)
                        if dev is not None and not self._cpu else None)
        self._rf = torch.profiler.record_function("repro_torch." + name)
        self.record["start_ns"] = time.time_ns()
        self._rf.__enter__()
        if self._stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)

    def close(self, exc_type, exc, tb) -> None:
        rec = self.record
        end = None
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
        self._rf.__exit__(exc_type, exc, tb)
        rec["end_ns"] = time.time_ns()
        _OPEN.ids.pop()
        if self._cpu:
            rec["device_s"] = (rec["end_ns"] - rec["start_ns"]) * 1e-9
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        TRACE.log(rec)
        if end is not None:
            TRACE.pend(rec, self._start, end)


class Span:
    """One timed stage.  Use via :func:`span` (a registry stage) or
    :func:`trace_span` (a traced region alone)."""

    __slots__ = ("stage", "meta", "_t0", "_active", "_registry", "_log",
                 "duration_s", "_device", "_trace")

    def __init__(self, stage: str, registry, log, meta, device=None):
        self.stage = stage
        self.meta = meta
        self._registry = registry
        self._log = log
        self._active = False
        self._t0 = 0.0
        self._device = device
        self._trace = None
        self.duration_s = None

    def block(self, tree: Any) -> Any:
        """Wait for ``tree``'s tensor leaves (the stage's result) so the
        span measures the work, not the enqueue; returns ``tree``.  One
        synchronisation per CUDA device; a no-op on an inactive span
        (disabled metrics, or inside a compiled region)."""
        if self._active:
            _synchronize(tree)
        return tree

    def __enter__(self) -> "Span":
        if tracing():
            self._trace = _Record(self.stage, self._device)
        reg = self._registry
        self._active = (reg is not None and reg.enabled
                        and _trace_clean())
        if self._active:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._active:
            self.duration_s = time.perf_counter() - self._t0
            _span_hist(self._registry).labels(stage=self.stage).observe(
                self.duration_s)
            if self._log:
                event = {"event": "span", "stage": self.stage,
                         "duration_s": self.duration_s,
                         "t_end": time.time()}
                if exc_type is not None:
                    event["error"] = exc_type.__name__
                if self.meta:
                    event.update(self.meta)
                EVENT_LOG.log(event)
        if self._trace is not None:
            self._trace.close(exc_type, exc, tb)
            self._trace = None


def _span_hist(registry):
    return registry.histogram(
        "obs_span_seconds", "wall seconds per lifecycle stage",
        labelnames=("stage",), buckets=LATENCY_BUCKETS)


def span(stage: str, *, registry=None, block_on: Any = None,
         log: bool = False, **meta) -> Span:
    """A timed lifecycle stage::

        with span("fold") as sp:
            out = strategy.aggregate(...)
            sp.block(out.adapters)     # synchronise at the boundary

    ``block_on`` synchronises on a tree at *entry* (isolating this stage
    from still-running predecessors).  ``log=True`` also appends the span
    to :data:`EVENT_LOG` (and its JSON-lines sink, when attached).  Extra
    keyword arguments ride along as event metadata.  When metrics are
    disabled -- or a compiler is tracing -- the span is a no-op.  While
    tracing, it is also traced as ``repro_torch.<stage>``.
    """
    sp = Span(stage, registry or get_registry(), log, meta)
    if block_on is not None and sp._registry.enabled and _trace_clean():
        _synchronize(block_on)
    return sp


_OFF = contextlib.nullcontext()


def trace_span(name: str, *, device=None):
    """A traced region (``repro_torch.<name>`` and one record in
    :data:`TRACE`) while tracing, else a shared no-op context.
    ``device`` (a ``torch.device`` or a tensor on it) marks device work:
    the record then holds the region's device time."""
    if not tracing():
        return _OFF
    return Span(name, None, False, None, device=device)


__all__ = ["span", "Span", "EventLog", "EVENT_LOG", "ROUND_STAGES",
           "TRACE", "tracing", "set_tracing", "trace_span", "trace_session",
           "read_back", "count"]
