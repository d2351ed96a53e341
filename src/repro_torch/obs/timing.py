"""Shared benchmark timing utilities (device-aware, registry-integrated).

* :func:`block` -- wait for a tree's tensor leaves: one synchronisation per
  CUDA device holding a leaf, nothing for CPU tensors (kernel launches are
  asynchronous, so a host clock without it measures the enqueue);
* :func:`time_fn` -- warm up once, then time ``iters`` calls and reduce
  with ``min`` (default; a co-scheduled process inflates single samples,
  so the minimum is the real cost) or ``mean``;
* :func:`bench_payload` -- the standard machine-readable payload: bench
  name, the device it ran on, the environment header
  (:func:`repro_torch.kernels.runtime.bench_env`) and a full
  metrics-registry :meth:`~repro_torch.obs.MetricsRegistry.snapshot`.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from .metrics import MetricsRegistry, get_registry
from .trace import _synchronize


def block(tree: Any) -> Any:
    """Wait until every tensor leaf of ``tree`` is computed; returns
    ``tree``."""
    _synchronize(tree)
    return tree


def time_fn(fn: Callable[[], Any], iters: int = 3,
            reduce: str = "min") -> float:
    """Seconds per call of ``fn`` (which must return a tree of tensors --
    every leaf is waited for).  The first call warms up (builds kernels,
    fills caches) and is not timed.  ``reduce="min"`` (timeit-style,
    default) or ``"mean"``.
    """
    if reduce not in ("min", "mean"):
        raise ValueError(f"reduce must be min|mean, got {reduce!r}")
    block(fn())
    times = []
    for _ in range(max(int(iters), 1)):
        t0 = time.perf_counter()
        block(fn())
        times.append(time.perf_counter() - t0)
    return min(times) if reduce == "min" else sum(times) / len(times)


def bench_payload(bench: str, *, smoke: bool, case: dict, results: Any,
                  registry: MetricsRegistry | None = None,
                  **extra) -> dict:
    """The standard ``--json`` payload: the shared environment header plus
    a metrics snapshot under ``"obs"``.  ``"backend"`` is the device the
    port's entry points run on by default: ``"cuda"`` where a card is
    present, else ``"cpu"``."""
    from repro_torch.kernels.runtime import bench_env   # deferred: no cycle
    reg = registry or get_registry()
    payload = {
        "bench": bench,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "env": bench_env(),
        "smoke": bool(smoke),
        "case": case,
        "results": results,
        "obs": reg.snapshot(),
    }
    payload.update(extra)
    return payload


__all__ = ["block", "time_fn", "bench_payload"]
