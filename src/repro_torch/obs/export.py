"""Exporters: Prometheus text format, JSON-lines, in-memory snapshot.

Three ways out of a :class:`~repro_torch.obs.MetricsRegistry`:

* :meth:`MetricsRegistry.snapshot` -- the in-memory dict view (embedded
  verbatim in every benchmark's ``--json`` payload);
* :func:`to_prometheus` -- the Prometheus text exposition format
  (counters get a ``_total``-as-written name, histograms expand into
  cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``);
* :func:`write_jsonl_snapshot` -- one JSON line per call, for an
  append-only metrics log next to the span :class:`~repro_torch.obs.EventLog`.

:func:`parse_prometheus` parses the text format back into flat samples
-- the round-trip property (export -> parse == the registry's own
samples) is gated in ``tests/test_torch_obs_export.py``.
"""
from __future__ import annotations

import json
import time

from .metrics import MetricsRegistry, get_registry


def _fmt_labels(label_key: str, extra: str = "") -> str:
    parts = []
    if label_key:
        for item in label_key.split(","):
            name, value = item.split("=", 1)
            parts.append(f'{name}="{value}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus(registry: MetricsRegistry | None = None) -> str:
    """The registry in Prometheus text exposition format."""
    reg = registry or get_registry()
    lines = []
    for inst in reg.collect():
        samples = inst.samples()
        if not samples:
            continue
        if inst.help:
            lines.append(f"# HELP {inst.name} {inst.help}")
        lines.append(f"# TYPE {inst.name} {inst.kind}")
        for key, val in samples.items():
            if inst.kind == "histogram":
                cum = 0
                for edge, count in val["buckets"]:
                    cum += count
                    le = 'le="%g"' % edge
                    lines.append(
                        f"{inst.name}_bucket{_fmt_labels(key, le)} {cum}")
                cum += val["overflow"]
                inf = 'le="+Inf"'
                lines.append(
                    f"{inst.name}_bucket{_fmt_labels(key, inf)} {cum}")
                lines.append(
                    f"{inst.name}_sum{_fmt_labels(key)} "
                    f"{_fmt_value(val['sum'])}")
                lines.append(
                    f"{inst.name}_count{_fmt_labels(key)} {val['count']}")
            else:
                lines.append(
                    f"{inst.name}{_fmt_labels(key)} {_fmt_value(val)}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text format into
    ``{series_name: {frozenset(label pairs): value}}`` -- enough to
    verify the export round-trips (``tests/test_torch_obs_export.py``)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            label_str = rest.rstrip("}")
            labels = []
            for item in label_str.split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                labels.append((k, v.strip('"')))
            key = frozenset(labels)
        else:
            name, key = name_part, frozenset()
        value = float(value_part)
        out.setdefault(name, {})[key] = value
    return out


def write_jsonl_snapshot(path, registry: MetricsRegistry | None = None,
                         **meta) -> dict:
    """Append one JSON line holding a full registry snapshot (plus a
    timestamp and any ``meta``); returns the record written."""
    reg = registry or get_registry()
    record = {"ts": time.time(), **meta, "metrics": reg.snapshot()}
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return record


__all__ = ["to_prometheus", "parse_prometheus", "write_jsonl_snapshot"]
