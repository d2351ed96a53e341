"""The port's ``obs`` package: the metrics registry's semantics against the
JAX package's pure-Python registry on the same records, and spans
recording on the CPU (timing, the event log, inertness under
``torch.compile`` tracing, the service's stage histogram).
"""
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.obs import trace as ttrace


def _record(reg):
    c = reg.counter("evts_total", "events", labelnames=("reason",))
    c.labels(reason="x").inc()
    c.labels(reason="x").inc(2)
    c.labels(reason="y").inc()
    g = reg.gauge("depth")
    g.set(5.0)
    g.dec(2.0)
    h = reg.histogram("lat", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.0001, 2.0, 4.0, 4.0001, 100.0):
        h.observe(v)
    s = reg.histogram("stale", buckets=tobs.STALENESS_BUCKETS)
    for v in (0.0, 0.0, 3.0, 9.0, 300.0):
        s.observe(v)
    return c, g, h, s


def test_registry_snapshot_matches_jax():
    """The same records into both registries give the same snapshot,
    percentiles included (the port keeps its own copy of the module)."""
    t, j = _record(tobs.MetricsRegistry()), _record(jobs.MetricsRegistry())
    assert t[0].samples() == j[0].samples() == {"reason=x": 3.0,
                                                "reason=y": 1.0}
    assert t[1].value == j[1].value == 3.0
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert t[2].percentile(q) == j[2].percentile(q)
        assert t[3].percentile(q) == j[3].percentile(q)
    tsnap = tobs.MetricsRegistry()
    jsnap = jobs.MetricsRegistry()
    _record(tsnap), _record(jsnap)
    assert tsnap.snapshot() == jsnap.snapshot()
    assert tobs.STALENESS_BUCKETS == jobs.STALENESS_BUCKETS
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS


def test_histogram_le_semantics_and_bad_buckets():
    reg = tobs.MetricsRegistry()
    h = _record(reg)[2]
    sample = h.samples()[""]
    assert sample["buckets"] == [[1.0, 2], [2.0, 2], [4.0, 1]]
    assert sample["overflow"] == 2 and sample["count"] == 7
    assert h.percentile(1.0) == 100.0
    assert reg.histogram("empty", buckets=(1.0,)).percentile(0.5) is None
    for bad, match in (((1.0, 1.0), "increasing"),
                       ((1.0, float("inf")), "finite"), ((), "at least")):
        with pytest.raises(ValueError, match=match):
            reg.histogram(f"b{len(bad)}{match[0]}", buckets=bad)


def test_counter_label_model_and_registration_conflicts():
    reg = tobs.MetricsRegistry()
    c = _record(reg)[0]
    with pytest.raises(ValueError, match="labels"):
        c.inc()
    with pytest.raises(ValueError, match="monotone"):
        c.labels(reason="x").inc(-1)
    with pytest.raises(ValueError, match="missing label"):
        c.labels(nope="x")
    assert reg.counter("evts_total", labelnames=("reason",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("evts_total")
    with pytest.raises(ValueError, match="bad metric name"):
        reg.counter("no spaces")


def test_disabled_reset_and_scoped():
    reg = tobs.MetricsRegistry(enabled=False)
    c, g, h, _ = _record(reg)
    assert c.labels(reason="x").value == 0.0 and h.count == 0
    assert g.value == 0.0
    reg.enabled = True
    c.labels(reason="x").inc(7)
    with reg.scoped():
        assert c.labels(reason="x").value == 0.0
        c.labels(reason="x").inc(2)
    assert c.labels(reason="x").value == 7.0
    reg.reset()
    assert c.labels(reason="x").value == 0.0
    prev = tobs.set_enabled(False)
    assert not tobs.metrics_enabled()
    tobs.set_enabled(prev)
    assert tobs.get_registry() is tobs.REGISTRY


def test_counters_exact_under_concurrent_writers():
    reg = tobs.MetricsRegistry()
    c = reg.counter("n_total")
    h = reg.histogram("v", buckets=(1.0,))

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.5)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8000.0 and h.count == 8000


# ----------------------------------------------------------------- spans --
def test_span_times_into_stage_histogram_and_logs():
    reg = tobs.MetricsRegistry()
    tobs.EVENT_LOG.clear()
    with tobs.span("fold", registry=reg, log=True, method="rbla") as sp:
        out = sp.block({"A": torch.ones(4) * 2, "rank": torch.tensor(3)})
    assert out["A"].sum() == 8.0
    hist = reg.get("obs_span_seconds")
    assert hist._children[("fold",)].count == 1
    assert sp.duration_s is not None and sp.duration_s >= 0.0
    (event,) = tobs.EVENT_LOG.events()
    assert event["stage"] == "fold" and event["method"] == "rbla"
    with pytest.raises(RuntimeError):
        with tobs.span("flush", registry=reg, log=True):
            raise RuntimeError("boom")
    assert tobs.EVENT_LOG.events()[-1]["error"] == "RuntimeError"
    assert set(tobs.ROUND_STAGES) >= {"submit", "fold", "flush", "publish"}


def test_span_is_a_noop_when_disabled_or_compiling(monkeypatch):
    reg = tobs.MetricsRegistry(enabled=False)
    with tobs.span("fold", registry=reg) as sp:
        pass
    assert sp.duration_s is None and reg.get("obs_span_seconds") is None
    reg = tobs.MetricsRegistry()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert not ttrace._trace_clean()
    with tobs.span("fold", registry=reg, block_on=[torch.ones(2)]) as sp:
        sp.block(torch.ones(3))
    assert sp.duration_s is None and reg.get("obs_span_seconds") is None


def test_block_synchronises_only_cuda_devices(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    ttrace._synchronize({"a": torch.ones(2), "b": [torch.zeros(1), 3]})
    assert calls == []


def test_event_log_ring_and_jsonl_sink(tmp_path):
    log = tobs.EventLog(maxlen=3)
    path = tmp_path / "events.jsonl"
    log.attach_jsonl(path)
    for i in range(5):
        log.log({"i": i})
    log.detach()
    assert [e["i"] for e in log.events()] == [2, 3, 4]
    assert len(path.read_text().splitlines()) == 5
    log.clear()
    assert log.events() == []


def test_async_service_reports_its_stages():
    """The service's submit/flush/fold spans and intake counters land in
    its own registry."""
    from repro_torch.core.strategy import ClientUpdate, ServerState
    from repro_torch.fl import AsyncAggregator
    reg = tobs.MetricsRegistry()
    state = ServerState(adapters=None, base_trainable={"b": torch.zeros(4)})
    agg = AsyncAggregator("fedavg", state, registry=reg, staleness="constant")
    for v in (1.0, 3.0):
        agg.submit(ClientUpdate(adapters=None,
                                base_trainable={"b": torch.full((4,), v)},
                                n_examples=1.0))
    np.testing.assert_allclose(agg.state.base_trainable["b"].numpy(), 2.0)
    stages = reg.get("obs_span_seconds")._children
    assert {("submit",), ("flush",), ("fold",)} <= set(stages)
    assert reg.get("fl_updates_received_total").value == 2.0
    assert reg.get("fl_folds_total").value == 2.0
    assert reg.get("fl_staleness").count == 2
