"""Donation and the stack memo (``core/plan.py`` "Donation",
``core/donation.py``, ``AggregationStrategy.aggregate_adapters(donate=)``).

On the CPU:

* a donated round equals the round without donation bit for bit, and
  writes into the previous global's storage, for the mean family (rbla,
  rbla_ranked; a plain and an encoded cohort), the robust family
  (rbla_clipped, rbla_trimmed, rbla_median) and flora's stacking round
  (prev at the cap); where the JAX package ignores ``donate`` (strategies
  that keep no prev, svd, the per-leaf path) the port ignores it too;
* the donated round equals JAX's ``aggregate_adapters(donate=True)`` within
  F32_TOL (2e-5 of max|want|);
* the grouped kernels' ``outs=`` contract: written in place and returned,
  a wrong shape, dtype or layout refused;
* ``run_simulation`` (which donates every round, as JAX's simulator does)
  gives the same histories bit for bit as with donation off, the global
  held in one storage throughout;
* the stack memo: a repeated cohort reuses its stacking (on its third
  round: a fingerprint is kept first), an in-place edit of one upload
  misses, a dead cohort releases it.

On the card (marked ``cuda``, skipped here; no JAX needed): one grouped
launch into prev's storage, and the three hazards of the stream rule, each
with the earlier operation held back by ``torch.cuda._sleep``.
"""
import gc

import numpy as np
import pytest
import torch

from _torch_parity import need_cuda

from repro_torch.core import donation, get_strategy
from repro_torch.core.codec import encode_adapters
from repro_torch.core.strategy import AggregationStrategy
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import packed_agg_group
from repro_torch.lora import init_adapters, set_ranks
from repro_torch.tree import tree_leaves, tree_map

SPECS = {"fc1": (12, 16), "fc2": (10, 12)}
R_MAX = 8
SLEEP_CYCLES = 300_000_000          # ~0.15 s at the H100's boost clock
MEAN = ("rbla", "rbla_ranked")
ROBUST = ("rbla_clipped", "rbla_trimmed", "rbla_median")


def _cohort(n=5, seed=0, r_hi=R_MAX, device="cpu"):
    """n clients with ranks in [1, r_hi], noisy A and B (a live B)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, r_hi + 1, n)
    ads = []
    for i in range(n):
        ad = init_adapters(torch.Generator().manual_seed(seed * 100 + i),
                           SPECS, R_MAX, int(ranks[i]))
        ad = tree_map(lambda t: t + torch.as_tensor(
            rng.normal(size=t.shape), dtype=t.dtype)
            if t.dtype == torch.float32 else t, ad)
        ads.append(tree_map(lambda t: t.to(device),
                            set_ranks(ad, int(ranks[i]))))
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                        device=device)
    return ads, torch.as_tensor(ranks, dtype=torch.int32, device=device), w


def _prev(strategy, seed=9, device="cpu"):
    r_st = strategy.server_storage_rank(R_MAX) or R_MAX
    g = torch.Generator().manual_seed(seed)
    prev = init_adapters(g, SPECS, r_st, R_MAX)
    return tree_map(lambda t: (t + torch.randn(t.shape, generator=g)
                               if t.dtype == torch.float32 else t)
                    .to(device), prev)


def _ab(tree) -> list:
    return [t for p in tree.values() for t in (p["A"], p["B"])]


def _round(method, *, encoded=False, device="cpu", r_hi=R_MAX, n=5):
    """(strategy, cohort, ranks, weights, prev) of one round; flora's
    cohort stays under its cap (2 r_max) with prev's rank stacked in."""
    s = get_strategy(method)
    ads, ranks, w = _cohort(n=n, r_hi=r_hi, device=device)
    if encoded:
        ads = [encode_adapters(a, c) for a, c in
               zip(ads, ("int8", "bf16", "none", "bf16", "int8"))]
    return s, ads, ranks, w, _prev(s, device=device)


def _donated_vs_fresh(method, **kw):
    s, ads, ranks, w, prev = _round(method, **kw)
    want = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                                prev_global=tree_map(torch.clone, prev))
    ptrs = [t.data_ptr() for t in _ab(prev)]
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    return want, got, ptrs, prev


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("method", MEAN + ROBUST)
def test_donated_mean_and_robust_rounds_write_into_prev(method, encoded):
    want, got, ptrs, prev = _donated_vs_fresh(method, encoded=encoded)
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in _ab(got)] == ptrs
    for a, b in zip(_ab(prev), _ab(got)):      # prev now holds the output
        assert torch.equal(a, b)


def test_donated_flora_stacking_round_writes_into_prev():
    want, got, ptrs, _ = _donated_vs_fresh("flora", r_hi=3, n=2)
    assert get_strategy("flora")._plan_cache     # the planned round ran
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in _ab(got)] == ptrs
    assert got["fc1"]["A"].shape == (2 * R_MAX, 16)


@pytest.mark.parametrize("method", ["zeropad", "fedavg", "svd"])
def test_donate_is_ignored_where_jax_ignores_it(method):
    """Strategies that keep no prev, and svd's round, allocate their
    output and leave prev as it was, as JAX's plans do."""
    s, ads, ranks, w, prev = _round(method)
    before = tree_map(torch.clone, prev)
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    for a, b in zip(tree_leaves(before), tree_leaves(prev)):
        assert torch.equal(a, b)
    assert not {t.data_ptr() for t in _ab(got)} & {
        t.data_ptr() for t in _ab(prev)}


def test_donate_is_ignored_on_the_per_leaf_path():
    s, ads, ranks, w, prev = _round("rbla")
    before = tree_map(torch.clone, prev)
    want = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                                prev_global=prev, use_plan=False)
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, use_plan=False,
                               donate=True)
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(before), tree_leaves(prev)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ("rbla", "rbla_trimmed", "flora"))
def test_donated_round_matches_jax(method):
    """The port's donated round against JAX's ``aggregate_adapters(...,
    donate=True)`` on the same cohort and prev."""
    import jax.numpy as jnp

    from _torch_parity import F32_TOL, assert_close
    from repro.core import get_strategy as jax_get_strategy
    kw = dict(r_hi=3, n=2) if method == "flora" else {}
    s, ads, ranks, w, prev = _round(method, **kw)
    to_j = lambda t: jnp.asarray(t.numpy())           # noqa: E731
    jwant = jax_get_strategy(method).aggregate_adapters(
        [tree_map(to_j, a) for a in ads], to_j(w), r_max=R_MAX,
        client_ranks=to_j(ranks), prev_global=tree_map(to_j, prev),
        donate=True)
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    for k in SPECS:
        if method == "flora":        # stacked factors: compare products
            assert_close(got[k]["B"] @ got[k]["A"],
                         np.asarray(jwant[k]["B"] @ jwant[k]["A"]),
                         F32_TOL, k)
        else:
            for f in ("A", "B"):
                assert_close(got[k][f], np.asarray(jwant[k][f]), F32_TOL,
                             f"{k}/{f}")
        assert int(got[k]["rank"]) == int(jwant[k]["rank"])


def test_grouped_outs_contract():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(4, 6, 10)), dtype=torch.float32)
    masks = torch.ones(4, 6)
    w = torch.ones(4)
    prev = torch.as_tensor(rng.normal(size=(6, 10)), dtype=torch.float32)
    want = packed_agg_group([x], masks, w, [prev.clone()])[0]
    out = packed_agg_group([x], masks, w, [prev], outs=[prev])[0]
    assert out is prev and torch.equal(out, want)
    for bad in (torch.empty(6, 11), torch.empty(6, 10, dtype=torch.bfloat16),
                torch.empty(10, 6).t()):
        with pytest.raises(ValueError, match="out 0"):
            packed_agg_group([x], masks, w, outs=[bad])
    with pytest.raises(ValueError, match="outs"):
        packed_agg_group([x], masks, w, outs=[prev, prev])


def test_donation_records_nothing_on_the_cpu():
    s, ads, ranks, w, prev = _round("rbla")
    donation.note_read(prev)
    s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                         prev_global=prev, donate=True)
    donation.wait_written(prev)
    assert not (donation._READS or donation._WRITES or donation._HELD)


@pytest.mark.parametrize("method", ["rbla", "rbla_median", "flora"])
def test_run_simulation_is_bit_for_bit_with_donation(method, monkeypatch):
    """The simulator donates every round; with donation forced off the
    histories are the same bit for bit, and the donated global keeps one
    storage from the first round to the last."""
    from repro_torch.fl import FLConfig, run_simulation
    cfg = FLConfig(method=method, rounds=3, n_clients=4, n_per_class=20,
                   n_test_per_class=10, local_epochs=1, batch_size=16,
                   lr=0.01, r_max=R_MAX, seed=42)
    orig = AggregationStrategy.aggregate
    seen = []

    def spy(self, *a, **k):
        seen.append(k.get("donate"))
        state = orig(self, *a, **k)
        seen.append(tree_leaves(state.adapters)[0].data_ptr())
        return state
    monkeypatch.setattr(AggregationStrategy, "aggregate", spy)
    donated = run_simulation(cfg, device="cpu")
    assert seen[0::2] == [True] * 3
    assert len(set(seen[1::2])) == 1 or method == "flora"

    def undonated(self, *a, **k):
        return orig(self, *a, **dict(k, donate=False))
    monkeypatch.setattr(AggregationStrategy, "aggregate", undonated)
    plain = run_simulation(cfg, device="cpu")
    assert np.isfinite(plain.train_loss).all()
    assert donated.test_acc == plain.test_acc
    assert donated.train_loss == plain.train_loss


def test_run_simulation_leaves_the_callers_adapters_alone():
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.models.paper_nets import PAPER_MODELS
    cfg = FLConfig(rounds=2, n_clients=4, n_per_class=20,
                   n_test_per_class=10, r_max=R_MAX, seed=1)
    ad = init_adapters(torch.Generator().manual_seed(0),
                       PAPER_MODELS["mlp"]().lora_specs, R_MAX, R_MAX)
    before = tree_map(torch.clone, ad)
    run_simulation(cfg, device="cpu", adapters=ad)
    for a, b in zip(tree_leaves(before), tree_leaves(ad)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ stack memo --
def _memo_round(s, ads, w, ranks):
    return s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks)


def _count_stacks(monkeypatch) -> list:
    """Counts ``stack_trees`` calls of ``aggregate_adapters``."""
    from repro_torch.core import strategy
    calls, orig = [], strategy.stack_trees

    def counted(trees):
        calls.append(1)
        return orig(trees)
    monkeypatch.setattr(strategy, "stack_trees", counted)
    return calls


def test_stack_memo_hits_a_repeated_cohort(monkeypatch):
    s = get_strategy("rbla").with_options()
    ads, ranks, w = _cohort()
    calls = _count_stacks(monkeypatch)
    outs = [_memo_round(s, ads, w, ranks) for _ in range(3)]
    assert len(calls) == 2                    # fingerprint, store, hit
    for out in outs[1:]:
        for a, b in zip(tree_leaves(outs[0]), tree_leaves(out)):
            assert torch.equal(a, b)


def test_stack_memo_misses_after_an_in_place_edit(monkeypatch):
    s = get_strategy("rbla").with_options()
    ads, ranks, w = _cohort()
    for _ in range(2):
        _memo_round(s, ads, w, ranks)
    ads[2]["fc1"]["A"].add_(1.0)               # bumps the tensor's _version
    calls = _count_stacks(monkeypatch)
    got = _memo_round(s, ads, w, ranks)
    assert len(calls) == 1
    fresh = get_strategy("rbla").with_options()
    want = _memo_round(fresh, [tree_map(torch.clone, a) for a in ads], w,
                       ranks)
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)


def test_stack_memo_keeps_no_payload_for_fresh_cohorts_and_frees_the_dead():
    s = get_strategy("rbla").with_options()
    for seed in range(3):                      # a new cohort every round
        ads, ranks, w = _cohort(seed=seed)
        _memo_round(s, ads, w, ranks)
        assert s._stack_memo._entry is None
    for _ in range(2):
        _memo_round(s, ads, w, ranks)
    assert s._stack_memo._entry is not None
    del ads
    gc.collect()
    assert s._stack_memo._entry is None        # released with the uploads


# --------------------------------------------------------------- the card --
def _hold(monkeypatch):
    """Hold every donated launch back on its stream, after the round's
    host work: ``torch.cuda._sleep`` right after ``begin_write``."""
    orig = donation.begin_write

    def held(targets):
        orig(targets)
        torch.cuda._sleep(SLEEP_CYCLES)
    monkeypatch.setattr(donation, "begin_write", held)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rbla", "rbla_trimmed", "flora"])
def test_donated_round_is_one_launch_into_prev_on_the_card(method):
    need_cuda()
    kw = dict(r_hi=3, n=2) if method == "flora" else {}
    s, ads, ranks, w, prev = _round(method, device="cuda", **kw)
    want = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                                prev_global=tree_map(torch.clone, prev))
    ptrs = [t.data_ptr() for t in _ab(prev)]
    runtime.reset_counts()
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    torch.cuda.synchronize()
    assert sum(runtime.LAUNCHES.values()) == 1
    assert sum(runtime.PLAIN_CALLS.values()) == 0
    assert [t.data_ptr() for t in _ab(got)] == ptrs
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stream_rule_write_after_read():
    """A read of the global queued on a side stream (held back by a
    sleep) and noted; then a donated round on the default stream: the
    round waits for the read, which sees the old global bit for bit."""
    need_cuda()
    s, ads, ranks, w, prev = _round("rbla", device="cuda")
    old = tree_map(torch.clone, prev)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        snap = [t * 1 for t in _ab(prev)]
        donation.note_read(prev)
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    torch.cuda.synchronize()
    for a, b in zip(snap, _ab(old)):
        assert torch.equal(a, b)
    assert not torch.equal(got["fc1"]["A"], old["fc1"]["A"])


@pytest.mark.cuda
def test_stream_rule_read_after_write(monkeypatch):
    """A donated round held back on the default stream, then a read of the
    new global on a side stream that first waits on its write: the read
    sees the new global."""
    need_cuda()
    s, ads, ranks, w, prev = _round("rbla", device="cuda")
    want = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                                prev_global=tree_map(torch.clone, prev))
    torch.cuda.synchronize()
    _hold(monkeypatch)
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        donation.wait_written(got)
        copy = [t * 1 for t in _ab(got)]
    torch.cuda.synchronize()
    for a, b in zip(copy, _ab(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stream_rule_free_while_read(monkeypatch):
    """An encoded cohort (read in place by the kernel) allocated on a side
    stream; the donated round held back on the default stream; the
    uploads dropped and the side stream's next allocations filled with
    NaN: the uploads are not handed out while the round reads them, and
    the round equals the undonated one bit for bit."""
    need_cuda()
    s = get_strategy("rbla")
    host, ranks, w = _cohort()
    prev = _prev(s, device="cuda")
    ranks, w = ranks.cuda(), w.cuda()
    codecs = ("bf16", "int8", "bf16", "int8", "bf16")
    want = s.aggregate_adapters(
        [encode_adapters(tree_map(lambda t: t.cuda(), a), c)
         for a, c in zip(host, codecs)], w, r_max=R_MAX,
        client_ranks=ranks, prev_global=tree_map(torch.clone, prev))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ads = [encode_adapters(tree_map(lambda t: t.cuda(), a), c)
               for a, c in zip(host, codecs)]
    torch.cuda.current_stream().wait_stream(side)
    sizes = [t.numel() * t.element_size() for a in ads
             for t in tree_leaves(a)]
    _hold(monkeypatch)
    got = s.aggregate_adapters(ads, w, r_max=R_MAX, client_ranks=ranks,
                               prev_global=prev, donate=True)
    del ads
    gc.collect()
    with torch.cuda.stream(side):
        junk = [torch.full((n,), 255, dtype=torch.uint8, device="cuda")
                for n in sizes for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)
    del junk
