"""The port's durable FLaaS service against the JAX package: every test of
``tests/test_durability.py`` mirrored on ``repro_torch`` (WAL framing,
torn tails and rotation, dedup and retries, exactly-once folding, crash
recovery bit for bit, the chaos plan, the publish fault, the health
view), and the two packages held against each other where both compute
the same thing: ``FaultPlan``'s draws (identical), a crash and recovery
over the same uploads (identical counters, states within 2e-5 of
max|want| in fp32 with stochastic rounding off, since the RNG streams
differ), and the chaos simulation (identical counters, accuracies within
the async parity tests' 0.01).

Property tests run under ``tests/_hypothesis_stub.py`` and real
hypothesis alike: zero-arg wrappers, ``tempfile`` in place of
``tmp_path``.  Every service gets a ``MetricsRegistry`` of its own.
"""
import dataclasses
import heapq
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import (_reference_rig, assert_trees_close, port_tree)

from repro import obs as jobs
from repro.core import strategy as js
from repro.fl import AsyncFLConfig as JConfig
from repro.fl import DurableAggregator as JDurable
from repro.fl import FaultPlan as JPlan
from repro.fl import run_async_simulation as j_run
from repro.fl import async_agg as j_async_mod
from repro.fl.comm import RetryPolicy as JRetry
from repro.fl.selection import ClientLatencyModel as JLatency
from repro.lora import init_adapters
from repro_torch import obs as tobs
from repro_torch.checkpoint import (CheckpointError, GeneratorState, pack_obj,
                                    unpack_obj)
from repro_torch.core import codec as tcodec
from repro_torch.core import strategy as ts
from repro_torch.core.strategy import ClientUpdate, ServerState, get_strategy
from repro_torch.fl import (AsyncAggregator, AsyncFLConfig, DedupWindow,
                            DurableAggregator, FaultPlan, RetryPolicy,
                            WriteAheadLog, run_async_simulation)
from repro_torch.fl import async_agg as t_async_mod
from repro_torch.fl.chaos import flaky
from repro_torch.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")


def _configured(mod, name):
    s = mod.get_strategy(name)
    if s.rank_contract == "stacked":
        s = s.with_options(stack_r_cap=256)
    return s


def _jax_state(strategy, seed=99):
    r_storage = strategy.server_storage_rank(R_MAX) or R_MAX
    prev = init_adapters(jax.random.PRNGKey(seed), SPECS, r_storage, R_MAX)
    return js.ServerState(adapters=prev,
                          base_trainable={"b": jnp.zeros((4,), jnp.float32)},
                          r_max=R_MAX)


def make_state(strategy, seed=99):
    jst = _jax_state(strategy, seed)
    return ServerState(adapters=port_tree(jst.adapters),
                       base_trainable=port_tree(jst.base_trainable),
                       r_max=R_MAX)


def _jax_updates(n=8, seed=3):
    adapters, ranks, w, bases = hetero_cohort(n, seed=seed, with_bases=True)
    return [js.ClientUpdate(adapters=adapters[i], base_trainable=bases[i],
                            n_examples=float(w[i]), rank=int(ranks[i]))
            for i in range(n)]


def _port_update(u):
    return ClientUpdate(adapters=port_tree(u.adapters),
                        base_trainable=port_tree(u.base_trainable),
                        n_examples=u.n_examples, rank=u.rank)


def make_updates(n=8, seed=3):
    return [_port_update(u) for u in _jax_updates(n, seed)]


def svc(cls, strategy, state, **kw):
    return cls(strategy, state, registry=tobs.MetricsRegistry(), **kw)


def assert_trees_equal(a, b, msg=""):
    """Bit-exact tree equality (recovery's contract, not a tolerance)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), msg


def _rejections(registry):
    metric = registry.get("fl_updates_rejected_total")
    if metric is None:
        return {}
    return {key.partition("=")[2]: int(v)
            for key, v in metric.samples().items() if v}


# ----------------------------------------------------------------- the WAL --
def test_wal_roundtrip_and_torn_tail(tmp_path):
    d = str(tmp_path)
    wal = WriteAheadLog(d, fsync=False)
    for i in range(5):
        wal.append("submit", {"i": i})
    wal.close()
    seg = [os.path.join(d, n) for n in sorted(os.listdir(d))][0]
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad")   # crash mid-append
    wal2 = WriteAheadLog(d, fsync=False)
    recs = list(wal2.records())
    assert [b["i"] for _, _, b in recs] == [0, 1, 2, 3, 4]
    assert wal2.last_seq == 5 and wal2.n_torn >= 1
    # appends continue past the discarded torn frame
    assert wal2.append("submit", {"i": 5}) == 6
    wal2.close()


def test_wal_mid_stream_corruption_refuses(tmp_path):
    d = str(tmp_path)
    wal = WriteAheadLog(d, fsync=False)
    for i in range(4):
        wal.append("submit", {"payload": "x" * 64, "i": i})
    wal.close()
    seg = [os.path.join(d, n) for n in sorted(os.listdir(d))][0]
    raw = bytearray(open(seg, "rb").read())
    raw[40] ^= 0xFF                    # inside the FIRST record's payload
    open(seg, "wb").write(bytes(raw))
    # a second, clean segment makes the corrupt one non-final: that is
    # silent record loss, not a torn tail -- refuse, don't skip
    wal2 = WriteAheadLog.__new__(WriteAheadLog)
    wal2.dir, wal2.fsync, wal2._fh, wal2._segment = d, False, None, None
    wal2.n_torn = wal2.bytes_written = wal2.n_records = wal2.last_seq = 0
    wal2._open_segment(100)
    wal2.append("submit", {"i": 99})
    wal2.close()
    with pytest.raises(CheckpointError, match="mid-stream"):
        list(wal2.records())


def test_wal_short_header_before_the_final_segment_refuses(tmp_path):
    """A torn header is a torn tail only in the final segment."""
    d = str(tmp_path)
    wal = WriteAheadLog(d, fsync=False)
    wal.append("submit", {"i": 0})
    wal.rotate(covered_seq=0)
    wal.append("submit", {"i": 1})
    wal.close()
    first = [os.path.join(d, n) for n in sorted(os.listdir(d))][0]
    with open(first, "ab") as f:
        f.write(b"\x01\x02")
    with pytest.raises(CheckpointError, match="mid-stream"):
        WriteAheadLog(d, fsync=False)


def test_wal_rotation_prunes_covered_segments(tmp_path):
    d = str(tmp_path)
    wal = WriteAheadLog(d, fsync=False)
    for i in range(3):
        wal.append("submit", {"i": i})
    wal.rotate(covered_seq=3)
    for i in range(3, 6):
        wal.append("submit", {"i": i})
    # the fully covered first segment is gone; only the live one remains
    assert [b["i"] for _, _, b in wal.records()] == [3, 4, 5]
    assert len([n for n in os.listdir(d) if n.startswith("wal-")]) == 1
    wal.close()


def test_wal_journals_codec_payloads_as_they_arrived(tmp_path):
    """int8 and bf16 wire payloads reach the disk in their wire dtypes,
    with their scales, and come back bit for bit."""
    u = make_updates(1)[0]
    wal = WriteAheadLog(str(tmp_path), fsync=False)
    for codec in ("int8", "bf16"):
        enc = tcodec.encode_update(u, codec)
        wal.append("submit", {"update": enc.adapters})
    wal.close()
    recs = [b["update"] for _, _, b in WriteAheadLog(str(tmp_path),
                                                     fsync=False).records()]
    for codec, got in zip(("int8", "bf16"), recs):
        want = tcodec.encode_update(u, codec).adapters
        assert tcodec.tree_codec(got) == codec
        assert_trees_equal(got, want, codec)


# ------------------------------------------------------- dedup and retries --
def test_dedup_window_slides():
    w = DedupWindow(3)
    for uid in ("a", "b", "c"):
        w.add(uid)
    assert "a" in w and len(w) == 3
    w.add("d")                         # evicts oldest
    assert "a" not in w and "b" in w and "d" in w
    w2 = DedupWindow(3)
    w2.load_state_dict(w.state_dict())
    assert "b" in w2 and "a" not in w2
    with pytest.raises(ValueError):
        DedupWindow(0)


def test_retry_policy_deterministic_bounded():
    p = RetryPolicy(base=0.5, factor=2.0, max_delay=4.0, max_retries=3,
                    jitter=0.2, seed=7)
    a = [p.delay(i, salt=11) for i in range(6)]
    b = [p.delay(i, salt=11) for i in range(6)]
    assert a == b                      # seeded: replays identically
    assert p.delay(0, salt=1) != p.delay(0, salt=2)   # clients decorrelate
    for d in a:
        assert 0 < d <= 4.0 * 1.2
    assert not p.give_up(2) and p.give_up(3)
    with pytest.raises(ValueError):
        RetryPolicy(base=0.0)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=1.5)


# ----------------------------------------- idempotent at-least-once folding --
@pytest.mark.parametrize("mode", ["streaming", "buffered", "replay_anchor"])
def test_same_update_id_folds_exactly_once(mode):
    """Redeliver every upload and the state must match a clean
    exactly-once run bit for bit, in all three fold paths."""
    method = "rbla_median" if mode == "replay_anchor" else "rbla"
    buffer_size = 3 if mode == "buffered" else 1
    s = get_strategy(method)
    if mode == "replay_anchor":
        assert not s.supports_incremental
    updates = make_updates(6)

    clean = svc(AsyncAggregator, s, make_state(s), buffer_size=buffer_size)
    dup = svc(AsyncAggregator, s, make_state(s), buffer_size=buffer_size)
    for i, u in enumerate(updates):
        clean.submit(u, now=float(i), update_id=f"u{i}")
        dup.submit(u, now=float(i), update_id=f"u{i}")
        # at-least-once transport: every upload redelivered immediately
        assert dup.submit(u, now=float(i), update_id=f"u{i}") is False
    # ... and a late redelivery of the first id, many folds later
    assert dup.submit(updates[0], now=99.0, update_id="u0") is False
    clean.flush(now=100.0)
    dup.flush(now=100.0)
    assert dup.version == clean.version
    assert dup.n_received == clean.n_received
    assert_trees_equal(dup.state.adapters, clean.state.adapters,
                       f"{mode}: duplicate delivery changed the state")
    assert_trees_equal(dup.state.base_trainable, clean.state.base_trainable)


# ---------------------------------------------------------- crash recovery --
def run_to(agg, updates, stop, start=0, **kw):
    for i in range(start, stop):
        agg.submit(updates[i], model_version=0, now=float(i),
                   update_id=f"u{i}", **kw)


def test_crash_recovery_bit_identical(tmp_path):
    """Kill after 5 accepted uploads (checkpoint at 3 + WAL tail), recover,
    finish -- bit-identical to never having crashed, including the bf16
    accumulators, the stochastic-rounding generator, momentum, the buffer
    with its deadline and the dedup window."""
    s = get_strategy("rbla")
    kw = dict(accum_dtype="bfloat16", seed=7, server_momentum=0.5,
              buffer_size=2, deadline=5.0)
    oracle = svc(AsyncAggregator, s, make_state(s), **kw)
    updates = make_updates(8)
    run_to(oracle, updates, 8)
    oracle.maybe_flush(now=100.0)

    d = str(tmp_path)
    first = svc(DurableAggregator, s, make_state(s), dir=d,
                checkpoint_every=3, wal_fsync=False, **kw)
    run_to(first, updates, 5)
    first.close()                      # crash: no clean shutdown

    second = svc(DurableAggregator, s, make_state(s), dir=d,
                 checkpoint_every=3, wal_fsync=False, **kw)
    assert second.n_recoveries == 1 and second.n_replayed == 2
    # the restored dedup window still rejects a pre-crash id
    assert second.submit(updates[1], now=1.0, update_id="u1") is False
    run_to(second, updates, 8, start=5)
    second.maybe_flush(now=100.0)
    assert second.state.adapters["fc1"]["A"].dtype == torch.bfloat16
    assert_trees_equal(second.state.adapters, oracle.state.adapters,
                       "recovered run diverged from the uninterrupted one")
    assert_trees_equal(second.state.base_trainable,
                       oracle.state.base_trainable)
    assert_trees_equal(second._fold_state.momentum,
                       oracle._fold_state.momentum)
    assert torch.equal(second._generator.get_state(),
                       oracle._generator.get_state())
    assert second.version == oracle.version
    assert second.n_received == oracle.n_received


@pytest.mark.parametrize("method,kw", [
    ("flora", {}), ("rbla_norm", {}), ("zeropad", dict(buffer_size=3)),
    ("rbla", dict(codecs=("int8", "bf16", "none")))])
def test_crash_recovery_bit_identical_on_each_fold_path(tmp_path, method,
                                                        kw):
    """flora's streaming stack (its segment ledger rides in the snapshot),
    rbla_norm's replay from the anchor, a buffered zeropad and int8/bf16
    uploads journaled as they arrived: recovery is bit for bit."""
    s = _configured(ts, method)
    updates = make_updates(7)
    if "codecs" in kw:
        updates = [tcodec.encode_update(u, ("int8", "bf16", "none")[i % 3])
                   for i, u in enumerate(updates)]
    oracle = svc(AsyncAggregator, s, make_state(s), **kw)
    run_to(oracle, updates, 7)
    oracle.flush(now=50.0)
    d = str(tmp_path)
    first = svc(DurableAggregator, s, make_state(s), dir=d,
                checkpoint_every=2, wal_fsync=False, **kw)
    run_to(first, updates, 5)
    first.close()
    second = svc(DurableAggregator, s, make_state(s), dir=d,
                 checkpoint_every=2, wal_fsync=False, **kw)
    assert second.n_recoveries == 1 and second.n_replayed == 1
    run_to(second, updates, 7, start=5)
    second.flush(now=50.0)
    assert second.version == oracle.version
    assert_trees_equal(second.state.adapters, oracle.state.adapters, method)
    assert_trees_equal(second.state.base_trainable,
                       oracle.state.base_trainable, method)


def test_recovery_falls_back_past_corrupt_checkpoint(tmp_path):
    """A checkpoint torn by bit rot is skipped: recovery restores the
    previous snapshot and replays a longer WAL tail -- same final bits."""
    s = get_strategy("rbla")
    updates = make_updates(8)
    oracle = svc(AsyncAggregator, s, make_state(s))
    run_to(oracle, updates, 7)

    d = str(tmp_path)
    first = svc(DurableAggregator, s, make_state(s), dir=d,
                checkpoint_every=3, keep_checkpoints=2, wal_fsync=False)
    run_to(first, updates, 7)          # checkpoints at 3 and 6
    first.close()
    ckpts = sorted(n for n in os.listdir(d) if n.startswith("ckpt-"))
    assert len(ckpts) == 2
    fp = os.path.join(d, ckpts[-1])
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))

    second = svc(DurableAggregator, s, make_state(s), dir=d,
                 checkpoint_every=3, keep_checkpoints=2, wal_fsync=False)
    assert second.n_replayed == 4      # records 4..7 re-driven
    assert_trees_equal(second.state.adapters, oracle.state.adapters)


@settings(max_examples=6, deadline=None)
@given(spec=st.tuples(st.integers(1, 7), st.integers(1, 4),
                      st.sampled_from(["rbla", "rbla_median"])))
def test_crash_consistency_property(spec):
    """For any crash point x checkpoint cadence x strategy, recover and
    finish equals the uninterrupted run -- bit-identical for the
    incremental strategy, within the parity tolerance for replay from the
    anchor (as the JAX suite allows)."""
    cut, every, method = spec
    s = get_strategy(method)
    updates = make_updates(8)
    oracle = svc(AsyncAggregator, s, make_state(s), seed=11)
    run_to(oracle, updates, 8)

    with tempfile.TemporaryDirectory() as d:
        first = svc(DurableAggregator, s, make_state(s), dir=d, seed=11,
                    checkpoint_every=every, wal_fsync=False)
        run_to(first, updates, cut)
        first.close()
        second = svc(DurableAggregator, s, make_state(s), dir=d, seed=11,
                     checkpoint_every=every, wal_fsync=False)
        run_to(second, updates, 8, start=cut)
        second.close()
    assert second.version == oracle.version
    if s.supports_incremental:
        assert_trees_equal(second.state.adapters, oracle.state.adapters,
                           f"{method} cut={cut} every={every}")
    else:
        assert_trees_close(second.state.adapters, oracle.state.adapters,
                           msg=f"{method} cut={cut} every={every}")
    assert_trees_equal(second.state.base_trainable,
                       oracle.state.base_trainable)


def test_snapshot_roundtrip_restores_a_service_bit_for_bit():
    """state_dict -> pack_obj -> unpack_obj -> load_state_dict on a fresh
    service continues exactly as the original, bf16 rounding included."""
    s = get_strategy("rbla")
    kw = dict(accum_dtype="bfloat16", seed=5, server_momentum=0.3,
              buffer_size=2)
    updates = make_updates(7)
    a = svc(AsyncAggregator, s, make_state(s), **kw)
    run_to(a, updates, 5)
    blob = pack_obj(a.state_dict())
    b = svc(AsyncAggregator, s, make_state(s, seed=1), **kw)
    b.load_state_dict(unpack_obj(blob))
    assert len(b.buffer) == len(a.buffer) == 1
    assert isinstance(b.state_dict()["generator"], GeneratorState)
    for agg in (a, b):
        run_to(agg, updates, 7, start=5)
        agg.flush(now=9.0)
    assert_trees_equal(b.state.adapters, a.state.adapters)
    assert_trees_equal(b.state.base_trainable, a.state.base_trainable)
    for k in AsyncAggregator._COUNTERS:
        assert getattr(b, k) == getattr(a, k), k
    assert b.obs_registry.get("fl_buffer_depth").samples() == \
        a.obs_registry.get("fl_buffer_depth").samples()


# ------------------------------------------------------------------- chaos --
def test_fault_plan_is_deterministic_and_validated():
    p1 = FaultPlan(seed=5, p_drop=0.3, p_corrupt=0.2, crash_at=(10,))
    p2 = FaultPlan(seed=5, p_drop=0.3, p_corrupt=0.2, crash_at=(10,))
    draws1 = [(p1.drop(i), p1.corrupt(i)) for i in range(50)]
    assert draws1 == [(p2.drop(i), p2.corrupt(i)) for i in range(50)]
    assert any(d for d, _ in draws1) and not all(d for d, _ in draws1)
    assert p1.crash_now(10) and not p1.crash_now(9)
    # independent streams: a drop draw says nothing about a corrupt draw
    assert draws1 != [(c, d) for d, c in draws1]
    with pytest.raises(ValueError):
        FaultPlan(p_drop=1.5)
    with pytest.raises(ValueError):
        FaultPlan(reorder_delay_s=-1.0)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_fault_plan_draws_match_jax(seed):
    """Every kind, 200 indices: the port's draws are JAX's, bit for bit."""
    kw = dict(seed=seed, p_drop=0.3, p_duplicate=0.2, p_reorder=0.4,
              p_corrupt=0.1, p_truncate=0.15, p_stale_pull=0.25,
              p_publish_fail=0.5, crash_at=(3, 9))
    tp, jp = FaultPlan(**kw), JPlan(**kw)
    for name in ("duplicate", "reorder", "corrupt", "truncate",
                 "stale_pull", "publish_fail"):
        got = [getattr(tp, name)(i) for i in range(200)]
        assert got == [getattr(jp, name)(i) for i in range(200)], name
        assert any(got) and not all(got), name
    for attempt in range(3):
        assert ([tp.drop(i, attempt) for i in range(200)]
                == [jp.drop(i, attempt) for i in range(200)])
    assert [tp.crash_now(i) for i in range(12)] == \
        [jp.crash_now(i) for i in range(12)]
    assert tp.crash_at == jp.crash_at


def test_corrupt_and_truncate_bounce_off_front_door():
    s = get_strategy("rbla")
    agg = svc(AsyncAggregator, s, make_state(s))
    u = make_updates(1)[0]
    plan = FaultPlan(seed=0, p_corrupt=1.0)
    bad = plan.corrupt_update(u)
    assert torch.isfinite(u.adapters["fc1"]["A"]).all()   # input untouched
    with pytest.raises(ValueError, match="non-finite"):
        agg.submit(bad)
    with pytest.raises(ValueError, match="truncated|malformed"):
        agg.submit(plan.truncate_update(u))
    fft = dataclasses.replace(u, adapters=None)
    assert not torch.isfinite(
        plan.truncate_update(fft).base_trainable["b"]).all()
    assert agg.version == 0            # nothing reached the fold
    assert _rejections(agg.obs_registry) == {"nan_tensor": 1,
                                             "malformed": 1}


def test_durable_front_door_keeps_garbage_out_of_the_wal(tmp_path):
    s = get_strategy("rbla")
    agg = svc(DurableAggregator, s, make_state(s), dir=str(tmp_path),
              wal_fsync=False)
    u = make_updates(1)[0]
    plan = FaultPlan(seed=0)
    for bad in (plan.corrupt_update(u), plan.truncate_update(u)):
        with pytest.raises(ValueError):
            agg.submit(bad, update_id="u0")
    assert agg.wal.last_seq == 0
    agg.submit(u, update_id="u0")
    assert agg.submit(u, update_id="u0") is False
    assert agg.wal.last_seq == 1       # the duplicate is not journaled
    agg.close()


CHAOS_CFG = dict(n_clients=3, r_max=8, n_per_class=8, n_test_per_class=4,
                 batch_size=8, total_updates=10, eval_every=5, buffer_size=2,
                 buffer_deadline_s=3.0, checkpoint_every=4, retry_base_s=0.2)
CHAOS_PLAN = dict(seed=1, p_drop=0.25, p_duplicate=0.25, p_reorder=0.2,
                  p_corrupt=0.1, p_truncate=0.1, p_stale_pull=0.2,
                  crash_at=(4, 7))


def test_chaos_simulation_completes_and_is_deterministic(tmp_path):
    """Drops + retries, duplicates, reordering, corruption, truncation,
    stale pulls and two crash-restarts: the run completes, and an
    identical plan over a fresh directory lands on the identical
    trajectory."""
    cfg = AsyncFLConfig(wal_dir=str(tmp_path / "a"), **CHAOS_CFG)
    plan = FaultPlan(**CHAOS_PLAN)
    h1 = run_async_simulation(cfg, fault_plan=plan, device="cpu")
    cfg2 = dataclasses.replace(cfg, wal_dir=str(tmp_path / "b"))
    h2 = run_async_simulation(cfg2, fault_plan=plan, device="cpu")
    assert len(h1.test_acc) == 2
    assert h1.test_acc == h2.test_acc
    assert h1.mean_staleness == h2.mean_staleness


def _chaos_batch_indices(cfg, plan):
    """The JAX chaos run's initial model and the batch indices of every
    local fit, keyed ``(k, client)`` for the ``k``-th fit: the heap of
    ``repro.fl.run_async_simulation`` replayed with the plan's reorders,
    drops and retries (a retransmission does not train), one ``fit_key``
    drawn per fit in pop order."""
    params, adapters, draw = _reference_rig(cfg)
    latency = JLatency(cfg.n_clients, median_s=cfg.latency_median_s,
                       sigma=cfg.latency_sigma,
                       straggler_sigma=cfg.straggler_sigma, seed=cfg.seed)
    retry = JRetry(base=cfg.retry_base_s, max_retries=cfg.retry_max,
                   seed=cfg.seed)
    heap, counters, idx = [], {"seq": 0, "uid": 0}, {}

    def push(t, ci, uid, attempt):
        heapq.heappush(heap, (t, counters["seq"], ci, uid, attempt))
        counters["seq"] += 1

    def dispatch(ci, now):
        uid = counters["uid"]
        counters["uid"] += 1
        delay = latency.sample(ci)
        if plan.reorder(uid):
            delay += plan.reorder_delay_s
        push(now + delay, ci, uid, 0)

    for ci in range(cfg.n_clients):
        dispatch(ci, 0.0)
    fits = received = 0
    while received < cfg.total_updates:
        now, _, ci, uid, attempt = heapq.heappop(heap)
        if attempt == 0:
            idx[fits, ci] = draw(ci)
            fits += 1
        if plan.drop(uid, attempt) and not retry.give_up(attempt):
            push(now + retry.delay(attempt, salt=uid), ci, uid, attempt + 1)
            continue
        received += 1
        dispatch(ci, now)
    return params, adapters, idx


def _last_instance(monkeypatch, cls):
    seen = []
    orig = cls.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        seen.append(self)
    monkeypatch.setattr(cls, "__init__", init)
    return seen


def test_chaos_simulation_matches_jax(tmp_path, monkeypatch):
    """The same plan in both packages, the port on the JAX run's initial
    model and batch indices: the same uploads received, the same
    rejections by reason, the same recoveries and evaluations, and
    accuracies within the async parity tests' 0.01."""
    plan_kw = CHAOS_PLAN
    jcfg = JConfig(wal_dir=str(tmp_path / "jax"), **CHAOS_CFG)
    params, adapters, idx = _chaos_batch_indices(jcfg, JPlan(**plan_kw))
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    monkeypatch.setattr(j_async_mod, "get_registry", lambda: jreg)
    monkeypatch.setattr(t_async_mod, "get_registry", lambda: treg)
    jaggs = _last_instance(monkeypatch, JDurable)
    taggs = _last_instance(monkeypatch, DurableAggregator)
    jhist = j_run(jcfg, fault_plan=JPlan(**plan_kw))
    thist = run_async_simulation(
        AsyncFLConfig(wal_dir=str(tmp_path / "port"), **CHAOS_CFG),
        fault_plan=FaultPlan(**plan_kw), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda k, ci: torch.as_tensor(idx[k, ci]))
    assert len(jaggs) == len(taggs) == 3        # two crash-restarts
    ja, ta = jaggs[-1], taggs[-1]
    assert ta.n_received == ja.n_received
    assert ta.n_recoveries == ja.n_recoveries >= 1
    assert ta.n_replayed == ja.n_replayed
    assert ta.version == ja.version
    got, want = _rejections(treg), _rejections(jreg)
    assert got == want
    assert "duplicate" in got and ("nan_tensor" in got or "malformed" in got)
    assert len(thist.test_acc) == len(jhist.test_acc) == 2
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    assert thist.sim_time_s == jhist.sim_time_s
    assert thist.mean_staleness == pytest.approx(jhist.mean_staleness)


# ---------------------------------------- crash and recovery across packages --
CROSS_CASES = [("rbla", dict(), 5, 3), ("rbla", dict(buffer_size=3), 5, 2),
               ("rbla", dict(buffer_size=2, deadline=1.5), 4, 3),
               ("zeropad", dict(), 6, 4), ("rbla_median", dict(), 4, 2),
               ("flora", dict(), 5, 2)]


@pytest.mark.parametrize("method,kw,cut,every", CROSS_CASES)
def test_crash_recovery_matches_jax(tmp_path, method, kw, cut, every):
    """The same numpy-built uploads, a duplicate and a poisoned upload
    before the cut, the same cut and cadence in both packages: identical
    replay, recovery, WAL, checkpoint and rejection counters and version;
    recovered and final states within 2e-5 of max|want| (fp32, stochastic
    rounding off: the RNG streams differ)."""
    jstr, tstr = _configured(js, method), _configured(ts, method)
    jups = _jax_updates(8)
    tups = [_port_update(u) for u in jups]
    jbad = dataclasses.replace(jups[2], adapters=jax.tree.map(
        lambda x: x * jnp.nan if x.dtype == jnp.float32 else x,
        jups[2].adapters))
    tbad = _port_update(jbad)

    def drive(cls, strategy, state, ups, bad, d, start, stop, reg):
        agg = cls(strategy, state, dir=d, checkpoint_every=every,
                  wal_fsync=False, registry=reg, **kw)
        for i in range(start, stop):
            agg.submit(ups[i], model_version=max(agg.version - 1, 0),
                       now=float(i), update_id=f"u{i}")
            if i == 1:
                agg.submit(ups[i], now=float(i), update_id=f"u{i}")
                with pytest.raises(ValueError):
                    agg.submit(bad, now=float(i), update_id="bad")
        return agg

    out = {}
    for name, cls, strategy, state, ups, bad, mk_reg in (
            ("jax", JDurable, jstr, _jax_state(jstr), jups, jbad,
             jobs.MetricsRegistry),
            ("port", DurableAggregator, tstr, make_state(tstr), tups, tbad,
             tobs.MetricsRegistry)):
        d, reg = str(tmp_path / name), mk_reg()
        drive(cls, strategy, state, ups, bad, d, 0, cut, reg).close()
        second = drive(cls, strategy, state, ups, bad, d, cut, cut, reg)
        recovered = second.state
        for i in range(cut, 8):
            second.submit(ups[i], model_version=max(second.version - 1, 0),
                          now=float(i), update_id=f"u{i}")
        second.flush(now=20.0)
        out[name] = (second, recovered, _rejections(reg))
        second.close()
    (ja, jrec, jrej), (ta, trec, trej) = out["jax"], out["port"]
    for c in ("n_replayed", "n_recoveries", "n_checkpoints", "version",
              "n_received", "n_folded", "n_flushes"):
        assert getattr(ta, c) == getattr(ja, c), c
    assert ta.wal.last_seq == ja.wal.last_seq
    assert trej == jrej and trej["duplicate"] == 1
    for got, want in ((trec, jrec), (ta.state, ja.state)):
        if tstr.rank_contract == "stacked":
            for k in SPECS:
                g, w = got.adapters[k], want.adapters[k]
                assert int(g["rank"]) == int(w["rank"])
                assert_trees_close(g["B"] @ g["A"], np.asarray(w["B"])
                                   @ np.asarray(w["A"]), msg=method)
        else:
            assert_trees_close(got.adapters, jax.tree.map(np.asarray,
                                                          want.adapters),
                               msg=method)
        assert_trees_close(got.base_trainable, jax.tree.map(
            np.asarray, want.base_trainable), msg=method)


# ------------------------------------------------------------- publishing --
def test_publish_failure_keeps_serving_last_snapshot():
    """A failing hot-swap quarantines the pending state, readers keep the
    last committed snapshot, and the retry (with backoff) publishes the
    NEWEST pending tree."""
    from repro_torch.serving import AdapterStore, ServingEngine

    store = AdapterStore({"l0": (8, 6)}, r_max=4, device="cpu")
    rng = np.random.default_rng(0)
    weights = {"l0": torch.as_tensor(rng.normal(size=(6, 8)),
                                     dtype=torch.float32)}
    eng = ServingEngine(weights, store)

    def tree(seed):
        r = np.random.default_rng(seed)
        return {"l0": {
            "A": torch.as_tensor(r.normal(size=(4, 6)), dtype=torch.float32),
            "B": torch.as_tensor(r.normal(size=(8, 4)), dtype=torch.float32),
            "rank": torch.tensor(4, dtype=torch.int32)}}

    eng.publish(tree(0))
    v0 = store.version
    orig, broken = store.publish, {"on": True}

    def flaky_publish(t):
        if broken["on"]:
            raise RuntimeError("injected publish fault")
        return orig(t)

    store.publish = flaky_publish
    pub = eng.publisher(max_backoff=4)
    state = dataclasses.make_dataclass("S", ["adapters"])

    pub(state(tree(1)))                # fails -> quarantined, skip 1
    assert store.version == v0 and eng.n_publish_failures == 1
    x = torch.ones(3, 6)
    y = eng.apply("l0", x, torch.zeros(3, dtype=torch.int32))
    assert bool(torch.isfinite(y).all())      # still serving v0
    pub(state(tree(2)))                # inside backoff: skipped
    assert eng.n_publish_failures == 1
    pub(state(tree(3)))                # retry -> fails again, skip 2
    assert eng.n_publish_failures == 2 and store.version == v0
    broken["on"] = False
    pub(state(tree(4)))                # skipped (backoff 2)
    pub(state(tree(5)))                # skipped
    pub(state(tree(6)))                # retry succeeds, newest tree wins
    assert store.version == v0 + 1
    assert eng._publish_pending is None and eng._publish_fail_streak == 0


def test_flaky_store_under_a_fault_plan_serves_through_the_service():
    """``chaos.flaky`` in front of the store, the engine's publisher as
    the service's hook: every publish either lands or is quarantined and
    retried, serving never tears, and the newest global is what serves
    once a retry lands."""
    from repro_torch.serving import AdapterStore, ServingEngine

    s = get_strategy("rbla")
    state = make_state(s)
    store = AdapterStore(SPECS, r_max=R_MAX, device="cpu")
    rng = np.random.default_rng(1)
    weights = {p: torch.as_tensor(rng.normal(size=(fi, fo)) * 0.1,
                                  dtype=torch.float32)
               for p, (fo, fi) in SPECS.items()}
    eng = ServingEngine(weights, store)
    plan = FaultPlan(seed=3, p_publish_fail=0.5)
    store.publish = flaky(store.publish, plan)
    agg = svc(AsyncAggregator, s, state, on_publish=eng.publisher(
        max_backoff=2))
    run_to(agg, make_updates(8), 8)
    fails = sum(plan.publish_fail(i) for i in range(8))
    assert eng.n_publish_failures >= 1 and fails >= 1
    assert store.version >= 1
    x = torch.ones(2, SPECS["fc1"][1])
    y = eng.apply("fc1", x, torch.zeros(2, dtype=torch.int32))
    assert bool(torch.isfinite(y).all())


def test_flaky_wrapper_follows_plan():
    plan = FaultPlan(seed=3, p_publish_fail=0.5)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1

    wrapped = flaky(fn, plan)
    outcomes = []
    for _ in range(20):
        try:
            wrapped()
            outcomes.append(True)
        except RuntimeError:
            outcomes.append(False)
    assert outcomes == [not plan.publish_fail(i) for i in range(20)]
    assert calls["n"] == sum(outcomes)


# -------------------------------------------------- durability observability --
def test_health_reports_durability_section(tmp_path):
    from repro_torch.obs import ServiceHealth

    s = get_strategy("rbla")
    agg = svc(DurableAggregator, s, make_state(s), dir=str(tmp_path),
              checkpoint_every=2, wal_fsync=False)
    run_to(agg, make_updates(3), 3)
    view = ServiceHealth(aggregator=agg).snapshot()
    dur = view["durability"]
    assert dur["wal_last_seq"] == 3
    assert dur["n_checkpoints"] == 1
    assert dur["replay_backlog"] == 1          # one record past the snapshot
    assert dur["checkpoint_latency"]["count"] == 1   # a registry of its own
    assert dur["restore_latency"] is None
    assert dur["wal_bytes_appended"] > 0
    agg.close()
    again = svc(DurableAggregator, s, make_state(s), dir=str(tmp_path),
                checkpoint_every=2, wal_fsync=False)
    dur = ServiceHealth(aggregator=again).snapshot()["durability"]
    assert dur["n_recoveries"] == 1 and dur["n_replayed_updates"] == 1
    assert dur["restore_latency"]["count"] == 1
    again.close()
    # plain aggregators have no durability section
    plain = svc(AsyncAggregator, s, make_state(s))
    assert "durability" not in ServiceHealth(aggregator=plain).snapshot()


def test_durable_configuration_errors(tmp_path):
    s = get_strategy("rbla")
    for kw in (dict(checkpoint_every=-1), dict(keep_checkpoints=0)):
        with pytest.raises(ValueError):
            svc(DurableAggregator, s, make_state(s), dir=str(tmp_path), **kw)
