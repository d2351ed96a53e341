"""The per-layer metrics read from the program's trace recorder
(``gpubench/lib/recorder.py``), on the tiny traced runs of
``test_gpubench_cells.py``: each reads a finite value where its cell runs,
the agg cell's read-backs a flush are the count its adapter tree implies,
and each reads nothing from an empty or an overflowed session."""
from __future__ import annotations

import math

import pytest
from test_gpubench_cells import TINY, run

from gpubench.lib import program, recorder, spec
from gpubench.reference import rbla

AGG = "agg.h2o-danube-3-4b"
TRAIN = ("train.h2o-danube-3-4b", "train.mamba2-1.3b")
AGG_READERS = ("validate_ms.agg", "read_backs_per_flush.agg",
               "read_back_wait_ms.agg", "plan_ms.agg", "plan_hit_ratio.agg")
TRAIN_READERS = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train")
CASES = [(AGG, m) for m in AGG_READERS] + \
    [(c, m) for c in TRAIN for m in TRAIN_READERS]


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced run: (its result, the recorder's session right
    after it)."""
    out = {}

    def get(cell):
        if cell not in out:
            res = run(cell, trace=True)
            out[cell] = (res, recorder.session())
        return out[cell]
    return get


@pytest.mark.parametrize("cell,metric", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_reader_reads_a_finite_value(traced, monkeypatch, cell, metric):
    res, session = traced(cell)
    assert res["correct"] and session is not None
    monkeypatch.setattr(recorder, "session", lambda: session)
    value = spec.load_reader(metric).read({})
    assert value is not None and math.isfinite(value) and value >= 0
    assert res["metrics"][metric]["value"] == pytest.approx(value)


def test_agg_read_backs_a_flush_are_what_the_tree_implies(traced):
    res, session = traced(AGG)
    p = {**spec.load_workload(AGG)["params"], **TINY[AGG]["params"]}
    config = spec.load_config("h2o-danube-3-4b")
    arch = program.build_arch(config, TINY[AGG]["arch"])
    _, structure = program.structures(arch, p["r_max"])
    n_pairs = len(rbla.pairs(structure))
    k = p["buffer_size"]
    # validate: A and B of every pair of each of the K uploads; plan.spec:
    # the cohort's rank vector, each pair's stacked ranks and its prev's;
    # span.block: none on the CPU
    want = k * 2 * n_pairs + 1 + 2 * n_pairs
    assert res["metrics"]["read_backs_per_flush.agg"]["value"] == want
    sites = session["counters"]["read_back"]
    flushes = len(recorder.spans(session, "flush"))
    assert flushes == p["trace_flushes"]
    assert sites["validate"][0] == flushes * k * 2 * n_pairs
    assert sites["plan.spec"][0] == flushes * (1 + 2 * n_pairs)


def _overflowed():
    from repro_torch import obs
    from repro_torch.obs import trace as ttrace
    rec = ttrace.EventLog(maxlen=1)
    ttrace.TRACE, saved = rec, ttrace.TRACE
    obs.set_tracing(True)
    try:
        for name in ("flush", "fl.validate", "plan", "train.step"):
            with obs.trace_span(name, device="cpu"):
                obs.count("read_back", "validate")
    finally:
        obs.set_tracing(False)
        ttrace.TRACE = saved
    return rec


@pytest.mark.parametrize("metric", AGG_READERS + TRAIN_READERS)
@pytest.mark.parametrize("kind", ["empty", "overflowed"])
def test_reader_reads_nothing_from_an_empty_or_overflowed_session(
        monkeypatch, metric, kind):
    from repro_torch.obs import trace as ttrace
    rec = ttrace.EventLog() if kind == "empty" else _overflowed()
    assert rec.dropped == (3 if kind == "overflowed" else 0)
    monkeypatch.setattr(ttrace, "TRACE", rec)
    assert recorder.session() is None
    assert spec.load_reader(metric).read({}) is None
