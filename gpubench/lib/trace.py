"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over a
few of the cell's units, read into device time by kernel, the device's
busy time, and the idle gaps labelled by what the host was doing.

The profiler runs one unit as its warm-up step (records of the first
launches after it starts may be lost) and the counted units as its one
active step; the traced window is the host clock over the active step,
between two synchronisations.  Busy time is the union of every device
activity's interval (kernels, copies, sets).  A gap between device
activities is labelled by the innermost span the harness opened
(``record_function`` names under ``gpubench/``) and the innermost host
operation that cover its middle, ``span/operation``, else ``host``.
"""
from __future__ import annotations

import heapq
import time


def short_name(key: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters."""
    key = key.replace("(anonymous namespace)::", "")
    base = key.split("<", 1)[0].split("(", 1)[0].split("::")[-1].split()
    return base[-1] if base else key


def label(name: str):
    """A host span the trace names idle gaps by (no cost when no profiler
    runs)."""
    import torch
    return torch.profiler.record_function("gpubench/" + name)


def traced(device, warm, units, sync):
    """Profile ``units()`` after one ``warm()`` and return the reading:
    ``{"window_s", "busy_s", "kernels": {name: [launches, seconds]},
    "idle_gaps": [[label, seconds], ...], "gaps_n"}``; device events are
    absent where the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        sync()
        prof.step()
        t0 = time.perf_counter()
        units()
        sync()
        window_s = time.perf_counter() - t0
        prof.step()
    events = list(prof.events())
    dev, host = [], []
    for ev in events:
        tr = ev.time_range
        if _annotation(ev):
            # a span's own record, on the host or mirrored on the device
            if ev.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, ev.name))
    return summarise(dev, host, window_s)


def _annotation(ev) -> bool:
    """A user annotation (the harness's spans, the profiler's step):
    kineto mirrors them on the device timeline, where they are no work."""
    return (getattr(ev, "is_user_annotation", False)
            or ev.name.startswith(("gpubench/", "ProfilerStep")))


def summarise(dev, host, window_s) -> dict:
    """The reading from device intervals ``dev`` and host intervals
    ``host``, each ``(start_us, end_us, name)``."""
    kernels: dict = {}
    for s, e, name in dev:
        k = kernels.setdefault(short_name(name), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    busy, gaps = 0.0, []
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        busy += (e - s) * 1e-6
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((e0, s1))
    named: dict = {}
    ours = [(s, e, n[len("gpubench/"):]) for s, e, n in host
            if n.startswith("gpubench/")]
    ops = [(s, e, n) for s, e, n in host
           if not n.startswith(("gpubench/", "ProfilerStep"))]
    mids = [0.5 * (g0 + g1) for g0, g1 in gaps]
    for (g0, g1), a, b in zip(gaps, _innermost(ours, mids),
                              _innermost(ops, mids)):
        lab = "/".join(x for x in (a, b) if x) or "host"
        named[lab] = named.get(lab, 0.0) + (g1 - g0) * 1e-6
    idle = sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])
    return {"window_s": window_s, "busy_s": busy, "kernels": kernels,
            "idle_gaps": idle[:10], "gaps_n": len(gaps)}


def _innermost(spans, points):
    """For each of ``points`` (ascending), the name of the shortest span
    of ``spans`` that covers it, or None: one sweep, the covering spans
    in a heap by length, spans that ended dropped from its top."""
    order = sorted(spans)
    heap, out, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][0] <= t:
            s, e, name = order[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def device_ops(reading: dict) -> list:
    """The ten device operations that took most time: [[name, seconds]]."""
    ops = sorted(([k, v[1]] for k, v in reading.get("kernels", {}).items()),
                 key=lambda kv: -kv[1])
    return ops[:10]


def kernel_seconds(reading: dict, names) -> tuple[int, float]:
    """Launches and device seconds of the kernels called ``names``."""
    n, s = 0, 0.0
    for name in names:
        k = reading.get("kernels", {}).get(name)
        if k:
            n += k[0]
            s += k[1]
    return n, s


__all__ = ["traced", "summarise", "label", "device_ops", "kernel_seconds",
           "short_name"]
