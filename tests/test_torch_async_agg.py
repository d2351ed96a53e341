"""The port's async FLaaS service against the JAX package: ``fl.comm``,
``make_staleness_fn`` and ``ClientLatencyModel`` (bit for bit), the
``AsyncAggregator`` twin-driven with the JAX one on the same submission
sequence (fully async, buffered, deadline flushes, replay, momentum, the
publish hook, dedup, every rejection reason, quantised uploads), bf16
accumulators by their statistics, and ``run_async_simulation`` against
``repro.fl.run_async_simulation`` with the JAX run's initial model and
batch indices.

States agree within 2e-5 of max|want| (fp32 folds in another summation
order); a simulation within 0.01 accuracy and 1e-3 on the adapters, as
``test_torch_simulation.py`` holds the synchronous loop.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import (assert_trees_close, async_reference_inputs,
                           port_tree)

from repro import obs as jobs
from repro.core import codec as jcodec
from repro.core import strategy as js
from repro.fl import AsyncAggregator as JAgg
from repro.fl import AsyncFLConfig as JConfig
from repro.fl import comm as jcomm
from repro.fl import run_async_simulation as j_run
from repro.fl.async_agg import make_staleness_fn as j_staleness
from repro.fl.selection import ClientLatencyModel as JLatency
from repro.lora import init_adapters
from repro_torch import obs as tobs
from repro_torch.core import codec as tcodec
from repro_torch.core import strategy as ts
from repro_torch.fl import AsyncAggregator as TAgg
from repro_torch.fl import AsyncFLConfig, ClientLatencyModel
from repro_torch.fl import comm as tcomm
from repro_torch.fl import make_staleness_fn, run_async_simulation
from repro_torch.kernels import runtime
from repro_torch.tree import tree_leaves


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configured(mod, name):
    s = mod.get_strategy(name)
    if s.rank_contract == "stacked":
        s = s.with_options(stack_r_cap=256)
    return s


def _states(name):
    jstr = _configured(js, name)
    r_storage = jstr.server_storage_rank(R_MAX) or R_MAX
    jst = js.ServerState(
        adapters=init_adapters(jax.random.PRNGKey(99), SPECS, r_storage,
                               R_MAX),
        base_trainable={"b": jnp.zeros((4,), jnp.float32)}, r_max=R_MAX)
    tst = ts.ServerState(adapters=port_tree(jst.adapters),
                         base_trainable=port_tree(jst.base_trainable),
                         r_max=R_MAX)
    return jstr, jst, _configured(ts, name), tst


def _updates(n=6, seed=3):
    adapters, ranks, w, bases = hetero_cohort(n, seed=seed, with_bases=True)
    jups = [js.ClientUpdate(adapters=adapters[i], base_trainable=bases[i],
                            n_examples=float(w[i]), rank=int(ranks[i]))
            for i in range(n)]
    return jups, [_port_update(u) for u in jups]


def _port_update(u):
    return ts.ClientUpdate(adapters=port_tree(u.adapters),
                           base_trainable=port_tree(u.base_trainable),
                           n_examples=u.n_examples, rank=u.rank)


def _twins(name, **kw):
    jstr, jst, tstr, tst = _states(name)
    ja = JAgg(jstr, jst, registry=jobs.MetricsRegistry(), **kw)
    ta = TAgg(tstr, tst, registry=tobs.MetricsRegistry(), **kw)
    return ja, ta


def _rejections(agg):
    metric = agg.obs_registry.get("fl_updates_rejected_total")
    if metric is None:
        return {}
    return {key.partition("=")[2]: int(v)
            for key, v in metric.samples().items() if v}


COUNTERS = ("version", "n_received", "n_folded", "n_flushes", "n_dropped",
            "staleness_sum", "wire_bytes_received", "n_published")


def _assert_twins(ja, ta, msg=""):
    for c in COUNTERS:
        assert getattr(ta, c) == pytest.approx(getattr(ja, c)), (msg, c)
    assert len(ta.buffer) == len(ja.buffer), msg
    assert _rejections(ta) == _rejections(ja), msg
    if ja.state.adapters is not None:
        if ta.strategy.rank_contract == "stacked":
            for k in SPECS:
                got, want = ta.state.adapters[k], ja.state.adapters[k]
                assert int(got["rank"]) == int(want["rank"]), msg
                assert_trees_close(got["B"] @ got["A"],
                                   np.asarray(want["B"])
                                   @ np.asarray(want["A"]), msg=msg)
        else:
            assert_trees_close(ta.state.adapters, _np(ja.state.adapters),
                               msg=msg)
    assert_trees_close(ta.state.base_trainable,
                       _np(ja.state.base_trainable), msg=msg)


SCENARIOS = {
    "rbla_fully_async": ("rbla", dict(staleness="polynomial")),
    "rbla_ranked_hinge": ("rbla_ranked", dict(staleness="hinge",
                                              staleness_a=0.7,
                                              staleness_b=1.0)),
    "zeropad": ("zeropad", {}),
    "fedavg_wall_clock": ("fedavg", dict(staleness="polynomial",
                                         staleness_clock="wall")),
    "flora_stream": ("flora", dict(staleness="polynomial")),
    "rbla_buffered": ("rbla", dict(buffer_size=3, staleness="polynomial")),
    "rbla_deadline": ("rbla", dict(buffer_size=4, deadline=1.5)),
    "rbla_norm_replay": ("rbla_norm", dict(replay_window=3)),
    "trimmed_replay": ("rbla_trimmed", dict(replay_window=4)),
    "svd_replay": ("svd", {}),
    "rbla_momentum": ("rbla", dict(server_momentum=0.5)),
    "rbla_momentum_buffered": ("rbla", dict(server_momentum=0.5,
                                            buffer_size=2)),
    "rbla_publish_every_2": ("rbla", dict(buffer_size=2, publish_every=2)),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_async_aggregator_matches_jax(scenario):
    """The same submissions (staleness, clocks, deadlines) into both
    services: every counter and, after every submission, the live state."""
    name, kw = SCENARIOS[scenario]
    published = {"jax": [], "torch": []}
    kw = dict(kw)
    if "publish_every" in kw:
        kw_j = dict(kw, on_publish=lambda s: published["jax"].append(
            s.round))
        kw_t = dict(kw, on_publish=lambda s: published["torch"].append(
            s.round))
    else:
        kw_j = kw_t = kw
    jstr, jst, tstr, tst = _states(name)
    ja = JAgg(jstr, jst, registry=jobs.MetricsRegistry(), **kw_j)
    ta = TAgg(tstr, tst, registry=tobs.MetricsRegistry(), **kw_t)
    jups, tups = _updates()
    for i, (ju, tu) in enumerate(zip(jups, tups)):
        now = 0.7 * i
        sub = dict(model_version=max(0, ja.version - i % 3), now=now,
                   pulled_at=now - 0.4 * (i % 4))
        if kw.get("deadline"):
            due = ja.next_deadline()
            assert ta.next_deadline() == due
            if due is not None and due < now:
                assert ta.maybe_flush(due) == ja.maybe_flush(due)
        assert ta.submit(tu, **sub) == ja.submit(ju, **sub)
        _assert_twins(ja, ta, f"{scenario} submit {i}")
    ta.flush(now=10.0)
    ja.flush(now=10.0)
    _assert_twins(ja, ta, f"{scenario} final flush")
    assert ta.mean_staleness() == pytest.approx(ja.mean_staleness())
    assert published["torch"] == published["jax"]


@pytest.mark.parametrize("reason", ["bad_mass", "nan_tensor", "malformed",
                                    "codec_not_allowed", "bad_scale",
                                    "overflow", "duplicate",
                                    "zero_mass_flush"])
def test_every_rejection_reason_matches_jax(reason):
    codecs = "none" if reason == "codec_not_allowed" else ("none", "int8")
    ja, ta = _twins("rbla", codecs=codecs, buffer_size=2, deadline=1.0)
    jups, tups = _updates(2, seed=43)
    if reason == "zero_mass_flush":
        for agg, u in ((ja, jups[0]), (ta, tups[0])):
            agg.buffer.add(u, weight=0.0, now=0.0)
            agg.buffer.add(u, weight=0.0, now=0.0)
            agg.flush(now=10.0)
        _assert_twins(ja, ta)
        assert _rejections(ta) == {"zero_mass_flush": 2}
        return
    if reason == "duplicate":
        for agg, u in ((ja, jups[0]), (ta, tups[0])):
            assert agg.submit(u, update_id="u7") is False   # buffered
            assert agg.submit(u, update_id="u7") is False   # deduplicated
        _assert_twins(ja, ta)
        assert _rejections(ta) == {"duplicate": 1} and ta.n_received == 1
        return
    ju, tu = jups[0], tups[0]
    if reason == "bad_mass":
        ju = dataclasses.replace(ju, n_examples=0.0)
        tu = dataclasses.replace(tu, n_examples=0.0)
    elif reason == "nan_tensor":
        ju = dataclasses.replace(ju, base_trainable={
            "b": jnp.full((4,), jnp.nan)})
        tu = dataclasses.replace(tu, base_trainable={
            "b": torch.full((4,), float("nan"))})
    elif reason == "malformed":
        ad = {k: dict(v) for k, v in ju.adapters.items()}
        ad["fc2"]["B"] = ad["fc2"]["B"][:, :3]           # truncated upload
        ju = dataclasses.replace(ju, adapters=ad)
        tu = _port_update(ju)
    else:
        ju = jcodec.encode_update(ju, "int8")
        tu = tcodec.encode_update(tu, "int8")
        if reason in ("bad_scale", "overflow"):
            poison = float("nan") if reason == "bad_scale" else 3.0e36
            jad = {k: dict(v) for k, v in ju.adapters.items()}
            jad["fc2"]["B_scale"] = jad["fc2"]["B_scale"].at[0].set(poison)
            ju = dataclasses.replace(ju, adapters=jad)
            tad = {k: dict(v) for k, v in tu.adapters.items()}
            tad["fc2"]["B_scale"] = tad["fc2"]["B_scale"].clone()
            tad["fc2"]["B_scale"][0] = poison
            tu = dataclasses.replace(tu, adapters=tad)
    with pytest.raises(ValueError) as want:
        ja.submit(ju)
    with pytest.raises(ValueError) as got:
        ta.submit(tu)
    assert str(got.value) == str(want.value)
    assert _rejections(ta) == _rejections(ja) == {reason: 1}
    assert ta.n_received == 0 and len(ta.buffer) == 0 and ta.version == 0


@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("buffer_size", [1, 5])
def test_quantised_uploads_match_jax(wire, buffer_size):
    """Encoded uploads: fully async decodes them for the fold, a buffered
    flush takes the fused-dequant plan; both as in the JAX package."""
    ja, ta = _twins("rbla", buffer_size=buffer_size)
    jups, tups = _updates(5)
    runtime.reset_counts()
    for ju, tu in zip(jups, tups):
        ja.submit(jcodec.encode_update(ju, wire))
        ta.submit(tcodec.encode_update(tu, wire))
    _assert_twins(ja, ta, wire)
    if buffer_size == 5:
        assert runtime.PLAIN_CALLS["packed_agg"] == 1      # one flush
    assert ta.wire_bytes_received < sum(
        tcomm.tree_bytes(u.adapters) + tcomm.tree_bytes(u.base_trainable)
        for u in tups)


def _fold_many(accum, seed, n_folds=60, beta=0.0):
    jstr, jst, tstr, tst = _states("rbla")
    _, tups = _updates(10, seed=5)
    agg = TAgg(tstr, tst, accum_dtype=accum, seed=seed, server_momentum=beta,
               registry=tobs.MetricsRegistry())
    for i in range(n_folds):
        agg.submit(tups[i % len(tups)])
    return agg


def test_bf16_accumulators_are_seeded_and_deterministic():
    a = _fold_many(torch.bfloat16, seed=7, n_folds=20)
    b = _fold_many("bfloat16", seed=7, n_folds=20)
    assert a.state.adapters["fc1"]["A"].dtype == torch.bfloat16
    for x, y in zip(tree_leaves(a.state.adapters),
                    tree_leaves(b.state.adapters)):
        assert torch.equal(x, y)
    c = _fold_many(torch.bfloat16, seed=8, n_folds=20)
    assert any(not torch.equal(x, y) for x, y in
               zip(tree_leaves(a.state.adapters),
                   tree_leaves(c.state.adapters)))
    assert all(v.dtype == torch.float32
               for v in ts._flat_pair_values(a._fold_state.row_mass))


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_bf16_accumulators_track_the_fp32_run(beta):
    """Unbiased rounding: 60 folds in bf16 storage stay within 5% relative
    Frobenius of the fp32 run (a biased rounder piles up ~60 half-ulps)."""
    fp32 = _fold_many(None, seed=0, beta=beta)
    bf16 = _fold_many(torch.bfloat16, seed=0, beta=beta)
    num = den = 0.0
    for x, y in zip(tree_leaves(fp32.state.adapters),
                    tree_leaves(bf16.state.adapters)):
        if x.is_floating_point():
            num += float(((x - y.float()) ** 2).sum())
            den += float((x ** 2).sum())
    assert (num / den) ** 0.5 < 0.05
    assert bf16.n_folded == 60


def test_service_configuration_errors_match_jax():
    jstr, jst, tstr, tst = _states("rbla")
    fjstr, fjst, ftstr, ftst = _states("flora")
    cases = [dict(buffer_size=0), dict(replay_window=0),
             dict(publish_every=0), dict(staleness_clock="lamport"),
             dict(server_momentum=1.5), dict(codecs=("none", "fp4")),
             dict(accum_dtype="float16"), dict(staleness="cubic")]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            JAgg(jstr, jst, **kw)
        with pytest.raises(ValueError) as got:
            TAgg(tstr, tst, **kw)
        assert type(got.value) is type(want.value), kw
    with pytest.raises(ValueError, match="fixed-rank"):
        TAgg(ftstr, ftst, server_momentum=0.5)


def test_durable_snapshots_wait_for_item_16():
    """Service snapshots, now that they exist (the name is kept so that
    the test's node ID stays stable): ``state_dict`` -> ``pack_obj`` ->
    ``unpack_obj`` -> ``load_state_dict`` restores a service bit for bit,
    and a snapshot missing its fields raises ``KeyError`` and leaves the
    service as it was."""
    from repro_torch.checkpoint import pack_obj, unpack_obj
    _, _, tstr, tst = _states("rbla")
    _, tups = _updates(6)
    kw = dict(buffer_size=2, server_momentum=0.5, accum_dtype="bfloat16",
              seed=3, registry=tobs.MetricsRegistry())
    agg = TAgg(tstr, tst, **kw)
    for i, u in enumerate(tups[:3]):
        agg.submit(u, model_version=0, now=float(i), update_id=f"u{i}")
    twin = TAgg(tstr, tst, **dict(kw, registry=tobs.MetricsRegistry()))
    twin.load_state_dict(unpack_obj(pack_obj(agg.state_dict())))
    assert twin.dedup.state_dict() == agg.dedup.state_dict()
    for a in (agg, twin):
        for i, u in enumerate(tups[3:], start=3):
            a.submit(u, model_version=0, now=float(i), update_id=f"u{i}")
    for c in COUNTERS:
        assert getattr(twin, c) == getattr(agg, c), c
    for x, y in zip(tree_leaves((twin.state.adapters,
                                 twin.state.base_trainable)),
                    tree_leaves((agg.state.adapters,
                                 agg.state.base_trainable))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    before = twin.state
    with pytest.raises(KeyError):
        twin.load_state_dict({})
    assert twin.state is before


# ------------------------------------------------------------------ comm --
def test_comm_matches_jax():
    jdw, tdw = jcomm.DedupWindow(3), tcomm.DedupWindow(3)
    for uid in ("a", "b", "a", "c", "d", "e"):
        jdw.add(uid)
        tdw.add(uid)
    assert tdw.state_dict() == jdw.state_dict() and len(tdw) == 3
    assert ("a" in tdw) == ("a" in jdw) and "e" in tdw
    for kw in (dict(), dict(base=0.5, factor=3.0, max_delay=4.0, seed=7),
               dict(jitter=0.0)):
        jr, tr = jcomm.RetryPolicy(**kw), tcomm.RetryPolicy(**kw)
        assert ([tr.delay(a, salt=s) for a in range(6) for s in (0, 5)]
                == [jr.delay(a, salt=s) for a in range(6) for s in (0, 5)])
        assert tr.give_up(5) == jr.give_up(5)
    jb, tb = jcomm.UpdateBuffer(3, deadline=2.0), tcomm.UpdateBuffer(3, 2.0)
    for i, now in enumerate((0.0, 1.0, 2.5)):
        for b in (jb, tb):
            b.add(f"u{i}", weight=0.5 * i, staleness=i, now=now,
                  wire_bytes=10 * i)
            assert tb.due(now) == jb.due(now)
    assert tb.next_deadline() == jb.next_deadline()
    assert tb.total_weight() == jb.total_weight()
    assert tb.total_wire_bytes() == jb.total_wire_bytes()
    assert [b.update for b in tb.pop()] == [b.update for b in jb.pop()]
    jups, tups = _updates(3)
    for ju, tu in zip(jups, tups):
        for codec in ("none", "bf16", "int8"):
            assert (tcomm.tree_bytes(tcodec.encode_adapters(tu.adapters,
                                                            codec))
                    == jcomm.tree_bytes(jcodec.encode_adapters(ju.adapters,
                                                               codec)))
        for rank in (None, 1, 3, 8):
            assert (tcomm.adapter_upload_bytes(tu.adapters, rank)
                    == jcomm.adapter_upload_bytes(ju.adapters, rank))
    params = {"w": np.zeros((20, 10), np.float32)}
    want = jcomm.round_cost_report(params, jups[0].adapters,
                                   jups[0].base_trainable, [1, 4, 8])
    got = tcomm.round_cost_report(port_tree(params), tups[0].adapters,
                                  tups[0].base_trainable, [1, 4, 8])
    assert got == want


@pytest.mark.parametrize("schedule,a,b", [("constant", 0.5, 4.0),
                                          ("polynomial", 0.5, 4.0),
                                          ("polynomial", 1.3, 0.0),
                                          ("hinge", 0.7, 2.0)])
def test_staleness_schedules_match_jax(schedule, a, b):
    tf, jf = make_staleness_fn(schedule, a=a, b=b), j_staleness(
        schedule, a=a, b=b)
    taus = [0.0, 0.5, 1.0, 2.0, 3.0, 7.5, 40.0]
    assert [tf(t) for t in taus] == [jf(t) for t in taus]
    assert tf(0.0) == 1.0
    assert all(x >= y for x, y in zip(map(tf, taus), map(tf, taus[1:])))
    for bad in (dict(schedule="cubic"), dict(schedule="hinge", a=0.0)):
        s = bad.pop("schedule")
        with pytest.raises(ValueError):
            make_staleness_fn(s, **bad)
    assert make_staleness_fn(abs) is abs


@pytest.mark.parametrize("seed", [0, 42])
def test_client_latency_model_is_bit_identical(seed):
    kw = dict(median_s=1.5, sigma=0.3, straggler_sigma=1.2, seed=seed)
    tl, jl = ClientLatencyModel(7, **kw), JLatency(7, **kw)
    np.testing.assert_array_equal(tl.client_median_s, jl.client_median_s)
    order = [3, 0, 3, 6, 1, 1, 5, 2, 4, 0]
    assert [tl.sample(c) for c in order] == [jl.sample(c) for c in order]
    with pytest.raises(ValueError, match="n_clients"):
        ClientLatencyModel(0)


# ------------------------------------------------------------- simulation --
CFG = dict(dataset="mnist", model="mlp", n_clients=4, n_per_class=20,
           n_test_per_class=10, local_epochs=1, batch_size=16, lr=0.01,
           r_max=8, seed=42, total_updates=10, eval_every=5)


def _spy_flushes(monkeypatch, cls):
    """The adapters after each flush, as numpy (the last one is the run's
    final state)."""
    seen = []
    orig = cls.flush

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        seen.append(jax.tree.map(
            lambda x: np.array(x.detach().cpu() if isinstance(
                x, torch.Tensor) else x), out.adapters))
        return out
    monkeypatch.setattr(cls, "flush", spy)
    return seen


@pytest.mark.parametrize("method,extra", [
    ("rbla", {}), ("rbla", dict(buffer_size=3)), ("zeropad", {}),
    ("flora", dict(stack_r_cap=64)), ("rbla_norm", {})])
def test_async_simulation_matches_reference(method, extra, monkeypatch):
    jcfg = JConfig(method=method, **CFG, **extra)
    params, adapters, idx = async_reference_inputs(
        jcfg, r_storage=extra.get("stack_r_cap"))
    jseen = _spy_flushes(monkeypatch, JAgg)
    jhist = j_run(jcfg)
    tseen = _spy_flushes(monkeypatch, TAgg)
    thist = run_async_simulation(
        AsyncFLConfig(method=method, **CFG, **extra), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda k, ci: torch.as_tensor(idx[k, ci]))
    assert len(thist.test_acc) == len(jhist.test_acc) == 2
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss,
                               rtol=1e-3)
    assert thist.sim_time_s == jhist.sim_time_s
    assert thist.mean_staleness == pytest.approx(jhist.mean_staleness)
    assert len(tseen) == len(jseen)
    if method == "flora":
        for k in SPECS:
            got, want = tseen[-1][k], jseen[-1][k]
            assert int(got["rank"]) == int(want["rank"])
            assert_trees_close(torch.as_tensor(got["B"] @ got["A"]),
                               want["B"] @ want["A"], tol=1e-3)
    else:
        assert_trees_close(tseen[-1], jseen[-1], tol=1e-3, msg=method)


def test_async_simulation_is_deterministic():
    cfg = AsyncFLConfig(method="rbla", **dict(CFG, total_updates=8,
                                              eval_every=4))
    a = run_async_simulation(cfg, device="cpu")
    b = run_async_simulation(cfg, device="cpu")
    assert a.test_acc == b.test_acc and a.train_loss == b.train_loss
    assert a.sim_time_s == sorted(a.sim_time_s)
    assert all(t >= 0 for t in a.mean_staleness)


def test_async_simulation_defaults_to_the_card_and_refuses_item_16(
        tmp_path):
    """The default device is the card; the durable service runs (the name
    is kept so that the test's node ID stays stable): a run with a WAL in
    ``tmp_path`` equals the run without one, and a crash point without a
    WAL raises ``ValueError``, as in the JAX package."""
    from repro_torch.fl import FaultPlan
    cfg = AsyncFLConfig(rounds=1, n_clients=2, n_per_class=2,
                        n_test_per_class=2, total_updates=2)
    plain = run_async_simulation(cfg, device="cpu")
    durable = run_async_simulation(
        dataclasses.replace(cfg, wal_dir=str(tmp_path / "wal"),
                            checkpoint_every=1), device="cpu")
    assert durable.test_acc == plain.test_acc
    assert durable.train_loss == plain.train_loss
    assert durable.mean_staleness == plain.mean_staleness
    assert any(n.startswith("ckpt-") for n in os.listdir(tmp_path / "wal"))
    with pytest.raises(ValueError, match="wal_dir"):
        run_async_simulation(cfg, fault_plan=FaultPlan(crash_at=(1,)),
                             device="cpu")
    if torch.cuda.is_available():
        assert len(run_async_simulation(cfg).test_acc) == 1
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            run_async_simulation(cfg)
