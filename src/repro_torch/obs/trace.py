"""Span-based round-lifecycle tracing with device-aware timers.

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
"""
from __future__ import annotations

import collections
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


def _synchronize(tree: Any) -> None:
    """Wait once for every CUDA device that holds a tensor leaf of
    ``tree``; CPU tensors (and non-tensors) need no wait."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class EventLog:
    """Bounded in-memory event ring with an optional JSON-lines sink.

    ``log(event)`` appends a dict; with :meth:`attach_jsonl` every event
    is also written as one JSON line.  Thread-safe.
    """

    def __init__(self, maxlen: int = 4096):
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._sink = None
        self._sink_path = None

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
            self._events.append(event)
            if self._sink is not None:
                self._sink.write(json.dumps(event) + "\n")
                self._sink.flush()

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: process-default event log; spans write here when ``log=True``
EVENT_LOG = EventLog()


class Span:
    """One timed stage.  Use via :func:`span`."""

    __slots__ = ("stage", "meta", "_t0", "_active", "_registry", "_log",
                 "duration_s")

    def __init__(self, stage: str, registry, log, meta):
        self.stage = stage
        self.meta = meta
        self._registry = registry
        self._log = log
        self._active = False
        self._t0 = 0.0
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
        reg = self._registry
        self._active = reg.enabled and _trace_clean()
        if self._active:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._active:
            return
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
    disabled -- or a compiler is tracing -- the span is a no-op.
    """
    sp = Span(stage, registry or get_registry(), log, meta)
    if block_on is not None and sp._registry.enabled and _trace_clean():
        _synchronize(block_on)
    return sp


__all__ = ["span", "Span", "EventLog", "EVENT_LOG", "ROUND_STAGES"]
