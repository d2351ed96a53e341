"""The port's trace recorder (``repro_torch.obs.trace``) on the CPU: spans
on the profiler's clock, off by default and inert when compiling, one
session at a time, parents by nesting, the ``read_back`` and
``plan_cache`` counters exact on a tiny cohort, and a training step's
phases.  Nothing traced reaches a ``MetricsRegistry``."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch import obs
from repro_torch.core.strategy import ClientUpdate, ServerState, get_strategy
from repro_torch.fl import AsyncAggregator
from repro_torch.obs import trace as ttrace

R_MAX, PAIRS, RANKS = 4, 3, (1, 2, 3, 4)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the module's place, the switch off."""
    rec = ttrace.EventLog(maxlen=1 << 12)
    monkeypatch.setattr(ttrace, "TRACE", rec)
    return rec


def _tree(gen, rank, storage=R_MAX):
    out = {}
    for i in range(PAIRS):
        a = torch.randn(storage, 6, generator=gen)
        b = torch.randn(5, storage, generator=gen)
        a[rank:] = 0
        b[:, rank:] = 0
        out[f"p{i}"] = {"A": a, "B": b,
                        "rank": torch.tensor(rank, dtype=torch.int32)}
    return out


def _service(registry=None, strategy="rbla"):
    gen = torch.Generator().manual_seed(0)
    ups = [ClientUpdate(adapters=_tree(gen, r), base_trainable={},
                        n_examples=1.0 + r, rank=r) for r in RANKS]
    svc = AsyncAggregator(
        strategy, ServerState(adapters=_tree(gen, R_MAX), base_trainable={},
                              round=0, r_max=R_MAX),
        buffer_size=len(RANKS), staleness="constant",
        registry=registry or obs.MetricsRegistry())
    return svc, ups


def _flush(svc, ups):
    for u in ups:
        svc.submit(u)


def _profiled(warm, active, activities=(ProfilerActivity.CPU,)):
    """``warm()`` in a schedule's warm-up step, ``active()`` in its one
    recording step; the profiler."""
    with profile(activities=list(activities), schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        prof.step()
        active()
        prof.step()
    return prof


def _names(records):
    return [r["name"] for r in records]


def test_span_record_lies_on_the_profilers_clock(recorder):
    def active():
        for _ in range(5):
            with obs.trace_span("probe"):
                torch.ones(64).sum()
    prof = _profiled(lambda: None, active)
    recs = recorder.session()["spans"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    evs = sorted((e for e in prof.events() if e.name == "repro_torch.probe"),
                 key=lambda e: e.time_range.start)
    assert len(recs) == len(evs) == 5
    # each record against its event; the median, since a preempted
    # worker can put one call's clock reads apart
    off = sorted(max(abs(t0 + ev.time_range.start * 1000 - r["start_ns"]),
                     abs(t0 + ev.time_range.end * 1000 - r["end_ns"]))
                 for r, ev in zip(recs, evs))
    assert off[2] < 50_000 and off[-1] < 2_000_000, off
    assert all(r["parent"] is None and r["device_s"] is None for r in recs)


def test_tracing_off_records_nothing_and_enters_nothing(recorder,
                                                        monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("entered while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    svc, ups = _service()
    _flush(svc, ups)
    assert not obs.tracing()
    assert obs.trace_span("x", device=torch.device("cuda")) is ttrace._OFF
    assert obs.read_back("validate", bool, torch.tensor(True)) is True
    s = recorder.session()
    assert s == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_stay_inert_while_compiling(recorder, monkeypatch):
    obs.set_tracing(True)
    try:
        with monkeypatch.context() as m:
            m.setattr(torch.compiler, "is_compiling", lambda: True)
            assert not obs.tracing()
            with obs.trace_span("x"):
                obs.count("read_back", "validate")
            with obs.span("fold", registry=obs.MetricsRegistry()):
                pass
    finally:
        obs.set_tracing(False)
    assert recorder.session() == {"spans": [], "counters": {},
                                  "dropped": 0}


def test_trace_span_compiles_in_one_graph(recorder):
    obs.set_tracing(True)
    try:
        @torch.compile(backend="eager", fullgraph=True)
        def f(x):
            with obs.trace_span("inside"):
                return x * 2
        assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
    finally:
        obs.set_tracing(False)
    assert "inside" not in _names(recorder.session()["spans"])


def test_a_new_profiler_session_clears_the_last(recorder):
    def one(name):
        def active():
            with obs.trace_span(name):
                obs.count("read_back", "validate")
        return active

    # the warm-up step records nothing, and its site, finding tracing
    # off, ends the session before: the recording step opens a new one
    _profiled(one("warm-only"), one("first"))
    s = recorder.session()
    assert _names(s["spans"]) == ["first"]
    _profiled(one("warm-only"), one("second"))
    s = recorder.session()
    assert _names(s["spans"]) == ["second"]
    assert s["counters"] == {"read_back": {"validate": [1, 0.0]}}


def test_parent_ids_follow_nesting(recorder):
    svc, ups = _service()
    _profiled(lambda: _flush(svc, ups), lambda: _flush(svc, ups))
    recs = recorder.session()["spans"]
    by_id = {r["id"]: r for r in recs}

    def parent(r):
        return by_id[r["parent"]]["name"] if r["parent"] else None
    for r in recs:
        want = {"fl.validate": "submit", "plan": "fold",
                "strategy.stack": "fold", "fold": "flush",
                "plan.build": "plan", "submit": None,
                "flush": None}[r["name"]]
        assert parent(r) == want, r
    assert _names(recs).count("fl.validate") == len(RANKS)
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"]:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


def test_read_back_counts_by_site_on_a_tiny_cohort(recorder):
    svc, ups = _service()
    _profiled(lambda: _flush(svc, ups),
              lambda: [_flush(svc, ups) for _ in range(3)])
    s = recorder.session()
    reads = s["counters"]["read_back"]
    # validate: each float leaf of each upload; plan.spec: the cohort's
    # rank vector, then each pair's stacked ranks and its prev's ranks
    assert reads["validate"][0] == 3 * len(RANKS) * 2 * PAIRS
    assert reads["plan.spec"][0] == 3 * (1 + 2 * PAIRS)
    assert set(reads) == {"validate", "plan.spec"}    # no card to wait for
    assert all(v[1] >= 0.0 for v in reads.values())


def test_plan_cache_counter_equals_plan_stats_deltas(recorder):
    svc, ups = _service()
    stats = svc.strategy.__dict__.setdefault("plan_stats",
                                             {"hits": 0, "misses": 0})
    before = dict(stats)

    def active():
        _flush(svc, ups)
        # the same ranks in another order: a new spec, a miss
        _flush(svc, ups[::-1])
        _flush(svc, ups)
    _profiled(lambda: None, active)
    got = recorder.session()["counters"]["plan_cache"]
    assert got.get("hit", [0])[0] == stats["hits"] - before["hits"]
    assert got.get("miss", [0])[0] == stats["misses"] - before["misses"]
    assert got["miss"][0] >= 1 and got["hit"][0] >= 1
    builds = _names(recorder.session()["spans"]).count("plan.build")
    assert builds == got["miss"][0]


def test_strategy_read_backs_count_under_their_site(recorder):
    # flora's per-pair round reads each pair's ranks and its prev's on the
    # host
    gen = torch.Generator().manual_seed(0)
    trees = [_tree(gen, r) for r in RANKS]
    prev = _tree(gen, R_MAX, storage=2 * R_MAX)
    obs.set_tracing(True)
    try:
        get_strategy("flora").aggregate_adapters(
            trees, torch.ones(len(RANKS)), r_max=R_MAX, prev_global=prev,
            backend="ref", use_plan=False)
    finally:
        obs.set_tracing(False)
    reads = recorder.session()["counters"]["read_back"]
    assert set(reads) == {"strategy"} and reads["strategy"][0] >= PAIRS


def test_make_step_traces_its_phases_in_order(recorder):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_step
    from repro_torch.lora import strip_ranks
    from repro_torch.models.model import make_model
    from repro_torch.optim import adam
    cfg = get_config("h2o-danube-3-4b").reduced()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    factors, ranks = strip_ranks(model.init_adapters(
        torch.Generator().manual_seed(1), rank=4))
    opt = adam(1e-3)
    step = make_step(model, params, ranks, opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(2))
    state = opt.init(factors)

    def two():
        f, st = factors, state
        for _ in range(2):
            f, st, _ = step(f, st, tokens)
    _profiled(two, two)
    recs = recorder.session()["spans"]
    steps = [r for r in recs if r["name"] == "train.step"]
    assert len(steps) == 2
    for st in steps:
        kids = sorted((r for r in recs if r["parent"] == st["id"]),
                      key=lambda r: r["start_ns"])
        assert _names(kids) == ["train.forward", "train.backward",
                                "train.optimizer"]
        for r in kids + [st]:
            assert r["device_s"] == pytest.approx(
                (r["end_ns"] - r["start_ns"]) * 1e-9)
        assert sum(r["device_s"] for r in kids) <= st["device_s"]


def test_ssd_scan_is_traced_on_its_plain_path(recorder):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 1, 16, 2, 4, 8
    args = (torch.randn(b, l, h, p, generator=g),
            -torch.rand(b, l, h, generator=g),
            torch.randn(b, l, n, generator=g),
            torch.randn(b, l, n, generator=g))
    obs.set_tracing(True)
    try:
        y, _ = ssd_scan(*args, chunk=8, backend="ref")
    finally:
        obs.set_tracing(False)
    (rec,) = recorder.session()["spans"]
    assert rec["name"] == "kernel.ssd_scan" and rec["device_s"] > 0
    assert y.shape == args[0].shape


def test_switch_traces_without_a_profiler_and_writes_jsonl(recorder,
                                                           tmp_path):
    svc, ups = _service()
    obs.set_tracing(True)
    try:
        _flush(svc, ups)
    finally:
        obs.set_tracing(False)
    assert not obs.tracing()
    path = tmp_path / "trace.jsonl"
    recorder.write_jsonl(path)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    spans = [x for x in lines if x["event"] == "span"]
    assert _names(spans) == _names(recorder.session()["spans"])
    sites = {(x["name"], x["site"]): x["n"] for x in lines
             if x["event"] == "counter"}
    assert sites[("read_back", "validate")] == len(RANKS) * 2 * PAIRS
    assert lines[-1] == {"event": "dropped", "n": 0}


def test_a_full_ring_counts_what_falls_off(monkeypatch):
    rec = ttrace.EventLog(maxlen=3)
    monkeypatch.setattr(ttrace, "TRACE", rec)
    obs.set_tracing(True)
    try:
        for i in range(5):
            with obs.trace_span(f"s{i}"):
                pass
    finally:
        obs.set_tracing(False)
    s = rec.session()
    assert _names(s["spans"]) == ["s2", "s3", "s4"] and s["dropped"] == 2


def test_tracing_adds_nothing_to_the_registry(recorder):
    """The service's registry snapshot has the same families and the same
    counts traced as untraced."""
    def snapshot(traced):
        reg = obs.MetricsRegistry()
        svc, ups = _service(registry=reg)
        obs.set_tracing(traced)
        try:
            _flush(svc, ups)
            _flush(svc, ups)
        finally:
            obs.set_tracing(False)
        snap = reg.snapshot()
        spans = snap["histograms"].pop("obs_span_seconds")
        return snap, {stage: h["count"] for stage, h in spans.items()}
    assert snapshot(True) == snapshot(False)
    assert recorder.session()["spans"]
