"""The port's serving path on the CPU against the JAX package's, case by
case as ``tests/test_serving.py`` drives ``repro.serving``: the same
adapters (made with numpy, carried across with the bridge) into both
``AdapterStore``s and both ``ServingEngine``s, the same operations, and
the results compared -- put/get, shared geometry buckets, page growth and
eviction, rank validation, the publish re-slice, snapshot pinning (bit for
bit) and the in-place publish when nothing pins (same ``data_ptr``, the
port's counterpart of ``is_deleted``), the engine against
``merged_reference`` and against the JAX engine, ``forward`` under one
snapshot, the in-flight batch, the ``on_publish`` hook of the async
service, and the publisher's quarantine and backoff.

Tolerances: 2e-5 of max(1, max|want|) where the two packages compute in
fp32 in another order; exact where bytes are copied.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import F32_TOL, assert_close, assert_trees_close, port_tree

from repro.core import ClientUpdate as JUpdate
from repro.core import ServerState as JState
from repro.fl import AsyncAggregator as JAgg
from repro.lora import init_adapters, set_ranks
from repro.serving import AdapterStore as JStore
from repro.serving import ServingEngine as JEngine
from repro_torch.core import strategy as ts
from repro_torch.fl import AsyncAggregator as TAgg
from repro_torch.obs import get_registry
from repro_torch.serving import AdapterStore, ServingEngine, merged_reference


def _weights(seed=0):
    """Base weights as numpy, W (fan_in, fan_out) per spec path."""
    rng = np.random.default_rng(seed)
    return {p: (rng.normal(size=(fi, fo)) * 0.1).astype(np.float32)
            for p, (fo, fi) in SPECS.items()}


def one_tenant_adapters(rank, seed=0):
    """A JAX adapter tree at ``rank`` with both factors randomised."""
    ad = init_adapters(jax.random.PRNGKey(seed), SPECS, R_MAX, rank)
    rng = np.random.default_rng(seed)
    ad = jax.tree.map(
        lambda v: v + jnp.asarray(rng.normal(size=v.shape), v.dtype)
        if v.dtype == jnp.float32 else v, ad)
    return set_ranks(ad, rank)


def twin_stores(**kw):
    return JStore(SPECS, r_max=R_MAX, **kw), AdapterStore(
        SPECS, r_max=R_MAX, device="cpu", **kw)


def twin_engines(n=6, seed=0):
    """Both stores with the same ``n`` tenants put, and an engine on each."""
    js, ts_ = twin_stores()
    w = _weights(seed)
    je = JEngine({p: jnp.asarray(v) for p, v in w.items()}, js, impl="xla")
    te = ServingEngine({p: torch.as_tensor(v) for p, v in w.items()}, ts_)
    adapters, _, _ = hetero_cohort(n=n, seed=seed)
    slots = []
    for i in range(n):
        slots.append(js.put(f"t{i}", adapters[i]))
        assert ts_.put(f"t{i}", port_tree(adapters[i])) == slots[-1]
    return js, ts_, je, te, slots


def _pinned_bytes(snap):
    return {p: tuple(t.clone() for t in snap.pair_buffers(p)) for p in SPECS}


# ----------------------------------------------------------------- store --
def test_store_put_get_roundtrip():
    js, ts_ = twin_stores()
    ad = one_tenant_adapters(3, seed=4)
    assert ts_.put("t0", port_tree(ad)) == js.put("t0", ad)
    got = ts_.get("t0")
    assert_trees_close(got, ad, 0.0, "put/get roundtrip")
    assert_trees_close(got, js.get("t0"), 0.0, "port get vs JAX get")
    assert got["fc1"]["rank"].dtype == torch.int32


def test_store_paths_share_geometry_bucket():
    specs = {"p": (8, 16), "q": (8, 16), "r": (8, 12)}
    snap = AdapterStore(specs, r_max=4, device="cpu").snapshot()
    jsnap = JStore(specs, r_max=4).snapshot()
    assert snap.bucket_of["p"] == snap.bucket_of["q"]
    assert snap.bucket_of["p"] != snap.bucket_of["r"]
    assert snap.bucket_of == jsnap.bucket_of


def test_store_page_growth_and_remove():
    """The same registrations and eviction in both stores give the same
    slots, offsets, ranks and page occupancy, and the port's buffers grow
    by doubling as the JAX store's do."""
    js, ts_ = twin_stores(init_pages=1, init_tenant_capacity=2)
    slots = []
    for i in range(5):
        slots.append(ts_.register(f"t{i}", rank=2 + i % 3))
        assert js.register(f"t{i}", rank=2 + i % 3) == slots[-1]
    assert len(set(slots)) == 5 and 0 not in slots
    for p in SPECS:
        t, j = ts_.snapshot().table(p), js.snapshot().table(p)
        np.testing.assert_array_equal(t.off.numpy(), np.asarray(j.off))
        np.testing.assert_array_equal(t.rank.numpy(), np.asarray(j.rank))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        assert len({int(t.off[s]) for s in slots}) == 5
        assert ts_.snapshot().pair_buffers(p)[0].shape == \
            js.snapshot().pair_buffers(p)[0].shape
    assert ts_.occupancy() == js.occupancy()
    ts_.remove("t2")
    js.remove("t2")
    assert ts_.n_tenants == js.n_tenants == 4
    assert int(ts_.snapshot().table("fc1").rank[slots[2]]) == 0
    assert ts_.register("t9", rank=1) == js.register("t9", rank=1) == slots[2]
    assert ts_.occupancy() == js.occupancy()
    assert ts_.version == js.version


def test_store_rank_validation():
    _, ts_ = twin_stores()
    with pytest.raises(ValueError, match="r_max"):
        ts_.register("t", rank=R_MAX + 1)
    bad = port_tree(one_tenant_adapters(2))
    bad["fc1"]["A"] = bad["fc1"]["A"][:, :-1]
    with pytest.raises(ValueError, match="does not match"):
        ts_.put("t", bad)
    with pytest.raises(ValueError, match="r_max must be"):
        AdapterStore(SPECS, r_max=0, device="cpu")


def test_publish_reslices_per_tenant_rank():
    """publish() writes min(tenant_rank, global_rank) rows of the global
    into every segment -- the Alg. 2 re-slice -- as the JAX store does."""
    js, ts_ = twin_stores()
    for name, rank in (("lo", 2), ("hi", R_MAX)):
        js.register(name, rank=rank)
        ts_.register(name, rank=rank)
    glob = one_tenant_adapters(5, seed=8)          # global rank 5
    assert ts_.publish(port_tree(glob)) == js.publish(glob)
    for name in ("lo", "hi"):
        assert_trees_close(ts_.get(name), js.get(name), 0.0, name)
    assert_trees_close(ts_.get("lo"), set_ranks(glob, 2), 0.0, "lo")
    assert all(int(p["rank"]) == R_MAX for p in ts_.get("hi").values())


def test_snapshot_pins_buffers_across_publish():
    """Hot-swap atomicity: a pinned snapshot's bytes never change, and a
    write under a live pin copies instead of writing in place."""
    _, ts_ = twin_stores()
    ts_.register("t", rank=4)
    ts_.publish(port_tree(one_tenant_adapters(4, seed=1)))
    snap = ts_.snapshot()
    assert ts_.pinned_snapshots == 1
    frozen = _pinned_bytes(snap)
    ptrs = {p: snap.pair_buffers(p)[0].data_ptr() for p in SPECS}
    ts_.publish(port_tree(one_tenant_adapters(4, seed=2)))
    new = ts_.snapshot()
    assert new.version > snap.version
    for p in SPECS:
        for got, want in zip(snap.pair_buffers(p), frozen[p]):
            assert torch.equal(got, want)
        assert new.pair_buffers(p)[0].data_ptr() != ptrs[p]
    assert any(not torch.equal(new.pair_buffers(p)[0], frozen[p][0])
               for p in SPECS)


def test_publish_writes_in_place_when_unpinned():
    """With no live snapshot, publish updates the buckets in place: the
    same storage, new content (the JAX store donates the buffer)."""
    js, ts_ = twin_stores()
    js.register("t", rank=4)
    ts_.register("t", rank=4)
    first = one_tenant_adapters(4, seed=1)
    js.publish(first)
    ts_.publish(port_tree(first))
    snap = ts_.snapshot()
    ptrs = {p: tuple(t.data_ptr() for t in snap.pair_buffers(p))
            for p in SPECS}
    del snap                                  # drop the only pin
    assert ts_.pinned_snapshots == 0
    second = one_tenant_adapters(4, seed=2)
    js.publish(second)
    ts_.publish(port_tree(second))
    snap = ts_.snapshot()
    assert {p: tuple(t.data_ptr() for t in snap.pair_buffers(p))
            for p in SPECS} == ptrs
    assert_trees_close(ts_.get("t"), set_ranks(second, 4), 0.0, "content")
    assert_trees_close(ts_.get("t"), js.get("t"), 0.0, "vs JAX")


def test_store_gauges_follow_the_store():
    _, ts_ = twin_stores()
    ts_.register("t", rank=3)
    snap = ts_.snapshot()
    reg = get_registry()
    assert reg.get("serving_store_version").value == ts_.version
    assert reg.get("serving_pinned_snapshots").value == 1
    label = AdapterStore._bucket_label(snap.bucket_of["fc1"])
    assert reg.get("serving_store_pages_used").samples()[
        f"bucket={label}"] == ts_.occupancy()[label]["pages_used"]


def test_the_stream_rule_is_a_no_op_on_the_cpu():
    _, ts_ = twin_stores()
    ts_.register("t", rank=3)
    snap = ts_.snapshot()
    assert snap.ready is None
    snap.wait()
    ts_.note_read(snap.pair_buffers("fc1"))
    assert ts_._reads == []


# ---------------------------------------------------------------- engine --
def test_engine_parity_vs_merged_reference_and_jax():
    js, ts_, je, te, slots = twin_engines()
    rng = np.random.default_rng(0)
    ids = rng.choice(slots + [0], 16).astype(np.int32)
    for path, (fo, fi) in SPECS.items():
        x = rng.normal(size=(16, fi)).astype(np.float32)
        got = te.apply(path, torch.as_tensor(x), torch.as_tensor(ids))
        assert_close(got, merged_reference(te, path, torch.as_tensor(x),
                                           torch.as_tensor(ids)),
                     F32_TOL, f"{path} vs merged_reference")
        assert_close(got, je.apply(path, jnp.asarray(x), jnp.asarray(ids)),
                     F32_TOL, f"{path} vs the JAX engine")


def test_engine_validates_weights():
    _, ts_ = twin_stores()
    w = {p: torch.as_tensor(v) for p, v in _weights().items()}
    with pytest.raises(ValueError, match="does not match"):
        ServingEngine({**w, "fc1": w["fc1"].T}, ts_)
    with pytest.raises(ValueError, match="missing base weights"):
        ServingEngine({"fc1": w["fc1"]}, ts_)
    eng = ServingEngine({**w, "fc2": w["fc2"].T.contiguous().T}, ts_)
    assert all(t.is_contiguous() for t in eng.weights.values())


def test_engine_forward_chains_one_snapshot():
    js, ts_, je, te, slots = twin_engines(seed=5)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, SPECS["fc1"][1])).astype(np.float32)
    ids = rng.choice(slots, 8).astype(np.int32)
    got = te.forward(torch.as_tensor(x), torch.as_tensor(ids),
                     paths=["fc1", "fc2"])
    h = merged_reference(te, "fc1", torch.as_tensor(x), torch.as_tensor(ids))
    assert_close(got, merged_reference(te, "fc2", h, torch.as_tensor(ids)),
                 F32_TOL, "forward vs merged_reference")
    assert_close(got, je.forward(jnp.asarray(x), jnp.asarray(ids),
                                 paths=["fc1", "fc2"]),
                 F32_TOL, "forward vs the JAX engine")


def test_in_flight_batch_sees_one_version():
    """A batch pinned to a snapshot is immune to a concurrent publish; the
    next unpinned batch picks up the new version."""
    js, ts_, je, te, slots = twin_engines(seed=9)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(8, SPECS["fc1"][1])),
                        dtype=torch.float32)
    ids = torch.as_tensor(rng.choice(slots, 8).astype(np.int32))
    snap = te.snapshot()
    before = te.apply("fc1", x, ids, snapshot=snap)
    glob = one_tenant_adapters(R_MAX, seed=77)
    te.publish(port_tree(glob))                      # mid-flight
    js.publish(glob)
    assert torch.equal(te.apply("fc1", x, ids, snapshot=snap), before)
    fresh = te.apply("fc1", x, ids)
    assert not torch.equal(fresh, before)
    assert_close(fresh, merged_reference(te, "fc1", x, ids), F32_TOL)
    assert_close(fresh, je.apply("fc1", jnp.asarray(x.numpy()),
                                 jnp.asarray(ids.numpy())), F32_TOL)


# ------------------------------------------------------- async publish hook --
def test_async_aggregator_on_publish():
    """AsyncAggregator(on_publish=engine.publisher()) hot-swaps each folded
    global into the port's store at the configured cadence, as the JAX
    service does into the JAX store."""
    js, ts_ = twin_stores()
    w = _weights(2)
    je = JEngine({p: jnp.asarray(v) for p, v in w.items()}, js)
    te = ServingEngine({p: torch.as_tensor(v) for p, v in w.items()}, ts_)
    js.register("t", rank=3)
    ts_.register("t", rank=3)
    adapters, ranks, weights, bases = hetero_cohort(n=4, seed=2,
                                                    with_bases=True)
    init = init_adapters(jax.random.PRNGKey(0), SPECS, R_MAX, R_MAX)
    jagg = JAgg("rbla", JState(adapters=init, base_trainable=bases[0],
                               r_max=R_MAX),
                backend="ref", on_publish=je.publisher(), publish_every=2)
    tagg = TAgg("rbla", ts.ServerState(adapters=port_tree(init),
                                       base_trainable=port_tree(bases[0]),
                                       r_max=R_MAX),
                on_publish=te.publisher(), publish_every=2)
    v0, jv0 = ts_.version, js.version
    for i in range(4):
        jagg.submit(JUpdate(adapters=adapters[i], base_trainable=bases[i],
                            n_examples=float(weights[i]),
                            rank=int(ranks[i])))
        tagg.submit(ts.ClientUpdate(adapters=port_tree(adapters[i]),
                                    base_trainable=port_tree(bases[i]),
                                    n_examples=float(weights[i]),
                                    rank=int(ranks[i])))
    assert tagg.n_published == jagg.n_published == 2
    assert ts_.version - v0 == js.version - jv0 == 2
    assert_trees_close(ts_.get("t"), js.get("t"), F32_TOL,
                       "served segment vs JAX")


class _FlakyStore:
    """Publishes that fail on the listed attempts, recorded."""

    def __init__(self, fail_on):
        self.fail_on, self.attempts, self.published = set(fail_on), 0, []

    def publish(self, tree):
        self.attempts += 1
        if self.attempts in self.fail_on:
            raise OSError("volume unavailable")
        self.published.append(tree)
        return len(self.published)


@pytest.mark.parametrize("fail_on", [(1,), (1, 2, 3), (2, 3, 4, 5, 6)])
def test_publisher_quarantine_and_backoff(fail_on):
    """The same failure pattern gives the JAX and the port publisher the
    same skips, retries and latest-wins choices."""
    trace = {}
    for name, cls in (("jax", JEngine), ("port", ServingEngine)):
        eng = cls.__new__(cls)
        eng.store = _FlakyStore(fail_on)
        eng._publish_pending, eng._publish_fail_streak = None, 0
        eng._publish_skip, eng.n_publish_failures = 0, 0
        hook = eng.publisher(max_backoff=4)
        for k in range(12):
            hook(type("S", (), {"adapters": f"global-{k}"})())
        trace[name] = (eng.store.attempts, eng.store.published,
                       eng.n_publish_failures, eng._publish_pending)
    assert trace["port"] == trace["jax"]
    attempts, published, failures, pending = trace["port"]
    assert failures == attempts - len(published) > 0
    # latest wins: whatever is still quarantined is the newest global
    assert pending in (None, "global-11")
    with pytest.raises(ValueError, match="max_backoff"):
        ServingEngine.publisher(None, max_backoff=0)
