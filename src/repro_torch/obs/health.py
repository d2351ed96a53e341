"""Service-level health view over the async aggregation + serving stack
(the port's copy of ``repro.obs.health``).

Operators of a long-lived FLaaS deployment need one call that answers
"is the service healthy *right now*": how stale are arriving updates,
what is being rejected and why, which wire codecs the fleet actually
uses, what a fold / publish costs, whether the plan cache is absorbing
cohort churn, and how full the serving store is.  :class:`ServiceHealth`
assembles exactly that from the metrics registry plus the live objects
(the registry holds the streams; the objects hold the point-in-time
state a gauge cannot keep honest, like page free lists and pinned
snapshots).

``ServiceHealth(aggregator=..., engine=...).snapshot()`` is the payload
a ``/healthz`` endpoint would serve; everything in it is plain JSON.
See ``docs/observability.md`` for the field catalog.
"""
from __future__ import annotations

from typing import Any

from .metrics import MetricsRegistry, get_registry

#: the latency percentiles every *_latency block reports
PERCENTILES = (0.5, 0.9, 0.99)


def _hist_view(hist_child) -> dict | None:
    if hist_child is None or hist_child.count == 0:
        return None
    view = {"count": int(hist_child.count),
            "mean": hist_child.sum / hist_child.count}
    for q in PERCENTILES:
        view[f"p{int(q * 100)}"] = hist_child.percentile(q)
    return view


def _labelled_values(metric, label: str) -> dict:
    """``{label value: count}`` for a single-label counter family."""
    if metric is None:
        return {}
    out = {}
    for key, value in metric.samples().items():
        # key is "name=value" (single labelname)
        out[key.partition("=")[2]] = value
    return out


class ServiceHealth:
    """One view over an :class:`~repro_torch.fl.AsyncAggregator`, a
    :class:`~repro_torch.serving.ServingEngine` and/or
    :class:`~repro_torch.serving.AdapterStore`, and the metrics registry they
    report into.  Any component may be ``None``; its section is omitted.
    """

    def __init__(self, aggregator=None, engine=None, store=None,
                 registry: MetricsRegistry | None = None):
        self.aggregator = aggregator
        self.engine = engine
        self.store = store if store is not None else (
            engine.store if engine is not None else None)
        if registry is None and aggregator is not None:
            registry = getattr(aggregator, "obs_registry", None)
        self.registry = registry or get_registry()

    # ------------------------------------------------------------ pieces --
    def _span_latency(self, stage: str) -> dict | None:
        hist = self.registry.get("obs_span_seconds")
        if hist is None:
            return None
        child = hist._children.get((stage,))
        return _hist_view(child)

    def staleness(self) -> dict | None:
        """The staleness distribution of accepted updates (histogram
        buckets in the aggregator's clock units) plus its percentiles."""
        hist = self.registry.get("fl_staleness")
        if hist is None or not hist._children:
            return None
        child = hist._children.get(())
        if child is None or child.count == 0:
            return None
        view = child._sample()
        view.update(_hist_view(child))
        return view

    def rejections(self) -> dict:
        """Per-reason rejection counts (see ``docs/observability.md``
        for the reason catalog)."""
        return _labelled_values(
            self.registry.get("fl_updates_rejected_total"), "reason")

    def codec_mix(self) -> dict:
        """Accepted uploads per wire codec."""
        return _labelled_values(
            self.registry.get("fl_uploads_by_codec_total"), "codec")

    def plan_cache(self) -> dict | None:
        """The aggregator strategy's plan-cache hit rate (the live
        per-instance ``plan_stats``, the shimmed public surface)."""
        if self.aggregator is None:
            return None
        stats = dict(self.aggregator.strategy.__dict__.get(
            "plan_stats", {}))
        hits = stats.get("hits", 0)
        misses = stats.get("misses", 0)
        stats["hit_rate"] = hits / (hits + misses) if hits + misses else None
        return stats

    def durability(self) -> dict | None:
        """Crash-recovery posture (only when the aggregator is a
        :class:`~repro_torch.fl.DurableAggregator`): WAL volume, checkpoint
        cadence and latency, recoveries and replays so far, and the serving
        publish quarantine.  The one operator question this answers: *if
        the server died right now, how much would replay cost?*"""
        agg = self.aggregator
        if agg is None or not hasattr(agg, "wal"):
            return None
        view = {
            "wal_last_seq": agg.wal.last_seq,
            "wal_records_appended": agg.wal.n_records,
            "wal_bytes_appended": agg.wal.bytes_written,
            "wal_torn_frames": agg.wal.n_torn,
            "checkpoint_every": agg.checkpoint_every,
            "n_checkpoints": agg.n_checkpoints,
            "n_recoveries": agg.n_recoveries,
            "n_replayed_updates": agg.n_replayed,
            # replay exposure: records journaled past the newest snapshot
            "replay_backlog": max(agg.wal.last_seq - agg._ckpt_seq, 0),
            "checkpoint_latency": _hist_view(
                self._hist_child("fl_checkpoint_seconds")),
            "restore_latency": _hist_view(
                self._hist_child("fl_restore_seconds")),
        }
        eng = self.engine
        if eng is not None and hasattr(eng, "n_publish_failures"):
            view["publish_failures"] = eng.n_publish_failures
            view["publish_quarantined"] = eng._publish_pending is not None
        return view

    def _hist_child(self, name: str):
        hist = self.registry.get(name)
        if hist is None:
            return None
        return hist._children.get(())

    def store_health(self) -> dict | None:
        """Page occupancy per bucket and the pinned-snapshot count --
        read live off the store (free lists and snapshot liveness are
        point-in-time state, not streams)."""
        store = self.store
        if store is None:
            return None
        return {
            "version": store.version,
            "n_tenants": store.n_tenants,
            "pinned_snapshots": store.pinned_snapshots,
            "page_occupancy": store.occupancy(),
        }

    # ----------------------------------------------------------- the view --
    def snapshot(self) -> dict:
        """The health payload: staleness histogram, per-reason
        rejections, codec mix, fold/publish latency percentiles,
        plan-cache hit rate, buffer state, store occupancy."""
        out: dict[str, Any] = {}
        agg = self.aggregator
        if agg is not None:
            out["service"] = {
                "version": agg.version,
                "n_received": agg.n_received,
                "n_folded": agg.n_folded,
                "n_flushes": agg.n_flushes,
                "n_dropped": agg.n_dropped,
                "n_published": agg.n_published,
                "mean_staleness": agg.mean_staleness(),
                "wire_bytes_received": agg.wire_bytes_received,
                "buffer_depth": len(agg.buffer),
                "buffer_wire_bytes": agg.buffer.total_wire_bytes(),
            }
            out["plan_cache"] = self.plan_cache()
        out["staleness"] = self.staleness()
        out["rejections"] = self.rejections()
        out["codec_mix"] = self.codec_mix()
        out["latency"] = {
            stage: self._span_latency(stage)
            for stage in ("submit", "flush", "fold", "publish", "serve")}
        store_view = self.store_health()
        if store_view is not None:
            out["store"] = store_view
        dur_view = self.durability()
        if dur_view is not None:
            out["durability"] = dur_view
        return out


__all__ = ["ServiceHealth", "PERCENTILES"]
