"""The program's trace recorder, as the per-layer readers take it.

The port records its own spans and counters while ``torch.profiler``
records (``repro_torch.obs.trace``): in a ``--trace 1`` run that is the
profiler's active step, so the recorder's latest session holds exactly
the counted traced units.  A program without the recorder, an empty
session and one whose ring overflowed read as nothing (``None``)."""
from __future__ import annotations


def session():
    """``{"spans": [record], "counters": {name: {site: [n, seconds]}},
    "dropped": n}`` of the latest session, or None."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    read = getattr(obs, "trace_session", None)
    if read is None:
        return None
    s = read()
    if s["dropped"] or not (s["spans"] or s["counters"]):
        return None
    return s


def spans(s, name: str) -> list:
    """The session's records of the span ``name``."""
    return [r for r in s["spans"] if r["name"] == name]


def host_s(records) -> float:
    """The records' host seconds, summed."""
    return sum(r["end_ns"] - r["start_ns"] for r in records) * 1e-9


def device_s(records):
    """The records' device seconds, summed; None where one has none."""
    if any(r["device_s"] is None for r in records):
        return None
    return sum(r["device_s"] for r in records)


def counted(s, name: str) -> tuple[int, float]:
    """The counter ``name`` over its sites: (count, seconds)."""
    sites = s["counters"].get(name, {})
    return (sum(v[0] for v in sites.values()),
            sum(v[1] for v in sites.values()))


def per_step_ms(phase: str):
    """A training phase's device ms (``train.<phase>``) over the session's
    ``train.step`` records, or None."""
    s = session()
    if s is None:
        return None
    steps = spans(s, "train.step")
    total = device_s(spans(s, "train." + phase))
    if not steps or total is None:
        return None
    return total / len(steps) * 1e3
