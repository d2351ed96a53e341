"""The port's ``obs.export`` and ``obs.health`` against the JAX package's
on the same counters: the Prometheus text and its parse, the
JSON-lines snapshot, and ``ServiceHealth`` over twin async services and
serving stores driven with the same uploads (counts, staleness, rejections,
codec mix, plan cache, span counts and store occupancy equal; span
durations are wall time and differ).
"""
import json

import jax
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import port_tree

from repro import obs as jobs
from repro.core import ClientUpdate as JUpdate
from repro.core import ServerState as JState
from repro.core import strategy as jstrategy
from repro.fl import AsyncAggregator as JAgg
from repro.lora import init_adapters
from repro.serving import AdapterStore as JStore
from repro.serving import ServingEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.core import strategy as ts
from repro_torch.fl import AsyncAggregator as TAgg
from repro_torch.serving import AdapterStore, ServingEngine


def _record(reg):
    c = reg.counter("evts_total", "events", labelnames=("reason",))
    c.labels(reason="x").inc()
    c.labels(reason="x").inc(2)
    c.labels(reason="y").inc()
    reg.gauge("depth", "queue depth").set(2.5)
    h = reg.histogram("lat", "latency", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.0001, 2.0, 4.0, 4.0001, 100.0):
        h.observe(v)
    reg.histogram("quiet", buckets=(1.0,))          # an empty histogram
    return reg


def test_prometheus_text_and_parse_match_jax():
    t = _record(tobs.MetricsRegistry())
    j = _record(jobs.MetricsRegistry())
    text = tobs.to_prometheus(t)
    assert text == jobs.to_prometheus(j)
    assert "# TYPE lat histogram" in text and "quiet_count 0" in text
    parsed = tobs.parse_prometheus(text)
    assert parsed == jobs.parse_prometheus(text)
    assert parsed["evts_total"] == {frozenset({("reason", "x")}): 3.0,
                                    frozenset({("reason", "y")}): 1.0}
    assert parsed["lat_bucket"][frozenset({("le", "+Inf")})] == 7.0
    assert parsed["lat_count"][frozenset()] == 7.0
    assert tobs.to_prometheus(tobs.MetricsRegistry()) == ""


def test_jsonl_snapshot_matches_jax(tmp_path):
    t = _record(tobs.MetricsRegistry())
    j = _record(jobs.MetricsRegistry())
    for _ in range(2):
        rt = tobs.write_jsonl_snapshot(tmp_path / "t.jsonl", t, run="a")
    rj = jobs.write_jsonl_snapshot(tmp_path / "j.jsonl", j, run="a")
    assert {k: v for k, v in rt.items() if k != "ts"} == \
        {k: v for k, v in rj.items() if k != "ts"}
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[-1])["metrics"] == \
        rt["metrics"]


def _twin_services():
    """A JAX and a port async service, each publishing into its own store
    through its engine, each reporting into its own registry."""
    rng = np.random.default_rng(0)
    w = {p: (rng.normal(size=(fi, fo)) * 0.1).astype(np.float32)
         for p, (fo, fi) in SPECS.items()}
    jstore = JStore(SPECS, r_max=R_MAX)
    tstore = AdapterStore(SPECS, r_max=R_MAX, device="cpu")
    jeng = JEngine({p: jax.numpy.asarray(v) for p, v in w.items()}, jstore)
    teng = ServingEngine({p: torch.as_tensor(v) for p, v in w.items()},
                         tstore)
    for store in (jstore, tstore):
        store.register("a", rank=3)
        store.register("b", rank=R_MAX)
    init = init_adapters(jax.random.PRNGKey(1), SPECS, R_MAX, R_MAX)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    # fresh strategy copies: the registered ones are process-wide
    # singletons whose plan caches other tests have already warmed
    jagg = JAgg(jstrategy.get_strategy("rbla").with_options(),
                JState(adapters=init, base_trainable={}, r_max=R_MAX),
                backend="ref", buffer_size=2, on_publish=jeng.publisher(),
                registry=jreg)
    tagg = TAgg(ts.get_strategy("rbla").with_options(),
                ts.ServerState(adapters=port_tree(init), base_trainable={},
                               r_max=R_MAX),
                buffer_size=2, on_publish=teng.publisher(), registry=treg)
    return (jagg, jeng, jreg), (tagg, teng, treg)


def test_service_health_matches_jax():
    (jagg, jeng, jreg), (tagg, teng, treg) = _twin_services()
    adapters, ranks, weights = hetero_cohort(n=5, seed=3)
    for i in range(5):
        jagg.submit(JUpdate(adapters=adapters[i], base_trainable={},
                            n_examples=float(weights[i]),
                            rank=int(ranks[i])), model_version=0)
        tagg.submit(ts.ClientUpdate(adapters=port_tree(adapters[i]),
                                    base_trainable={},
                                    n_examples=float(weights[i]),
                                    rank=int(ranks[i])), model_version=0)
    for agg, upd in ((jagg, JUpdate(adapters=adapters[0], base_trainable={},
                                    n_examples=0.0)),
                     (tagg, ts.ClientUpdate(adapters=port_tree(adapters[0]),
                                            base_trainable={},
                                            n_examples=0.0))):
        with pytest.raises(ValueError, match="n_examples"):
            agg.submit(upd)
    jsnap = jobs.ServiceHealth(aggregator=jagg, engine=jeng).snapshot()
    tsnap = tobs.ServiceHealth(aggregator=tagg, engine=teng).snapshot()
    assert set(tsnap) == set(jsnap)
    assert tsnap["store"] == jsnap["store"]
    assert tsnap["store"]["version"] == 2 + 2      # 2 registrations, 2 flushes
    for key in ("staleness", "rejections", "codec_mix"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["rejections"] == {"bad_mass": 1.0}
    ts_, js_ = tsnap["service"], jsnap["service"]
    assert ts_.pop("mean_staleness") == pytest.approx(
        js_.pop("mean_staleness"))
    assert ts_ == js_
    for stage, view in jsnap["latency"].items():
        got = tsnap["latency"][stage]
        assert (got is None) == (view is None), stage
        if view is not None:
            assert got["count"] == view["count"], stage
    assert tsnap["latency"]["publish"]["count"] == 2
    assert {k: v for k, v in tsnap["plan_cache"].items()
            if k in ("hits", "misses")} == \
        {k: v for k, v in jsnap["plan_cache"].items()
         if k in ("hits", "misses")}
    json.dumps(tsnap)                               # plain JSON


def test_service_health_of_a_lone_store():
    store = AdapterStore(SPECS, r_max=R_MAX, device="cpu")
    store.register("a", rank=2)
    pin = store.snapshot()
    view = tobs.ServiceHealth(store=store,
                              registry=tobs.MetricsRegistry()).snapshot()
    assert view["store"] == {"version": 1, "n_tenants": 1,
                             "pinned_snapshots": 1,
                             "page_occupancy": store.occupancy()}
    assert "service" not in view and view["rejections"] == {}
    del pin
