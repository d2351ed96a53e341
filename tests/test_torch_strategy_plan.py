"""The port's mean-family strategies (``repro_torch.core.strategy``) and
compiled plans (``repro_torch.core.plan``): the packed plan path, the
per-leaf path and the JAX package's reference path agree, and a packed
plan issues one grouped call per round."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import assert_trees_close, port_tree

from repro.core import plan as jplan
from repro.core import strategy as js
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime

MEAN_FAMILY = ["fedavg", "zeropad", "rbla", "rbla_ranked", "rbla_norm"]


@functools.cache
def _cohort(seed):
    adapters, ranks, weights = hetero_cohort(n=5, seed=seed, r_hi=R_MAX - 1)
    rng = np.random.default_rng(seed + 100)
    prev = {k: {"A": rng.normal(size=(R_MAX, fi)).astype(np.float32),
                "B": rng.normal(size=(fo, R_MAX)).astype(np.float32),
                "rank": np.int32(R_MAX)}
            for k, (fo, fi) in SPECS.items()}
    return adapters, ranks, weights, prev


def _port(seed):
    adapters, ranks, weights, prev = _cohort(seed)
    return ([port_tree(a) for a in adapters],
            torch.as_tensor(np.array(ranks)),
            torch.as_tensor(np.array(weights)), port_tree(prev))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", MEAN_FAMILY)
def test_plan_and_per_leaf_match_reference(name, seed):
    adapters, ranks, weights, prev = _cohort(seed)
    want = js.get_strategy(name).aggregate_adapters(
        adapters, weights, r_max=R_MAX, client_ranks=ranks,
        prev_global=jax.tree.map(jnp.asarray, prev), backend="ref")
    tads, tranks, tw, tprev = _port(seed)
    strat = ts.get_strategy(name)
    for use_plan in (True, False):
        got = strat.aggregate_adapters(tads, tw, r_max=R_MAX,
                                       client_ranks=tranks, prev_global=tprev,
                                       backend="ref", use_plan=use_plan)
        assert_trees_close(got, want, msg=f"{name} plan={use_plan}")
        assert all(int(p["rank"]) == R_MAX for p in got.values())


@pytest.mark.parametrize("name", MEAN_FAMILY)
def test_packed_plan_launches_once_per_bucket(name):
    """A planned round is one plain call (one grouped launch on the card)
    where the JAX plan makes one per (width, dtype) bucket, and the two
    rounds agree."""
    adapters, ranks, weights, prev = _cohort(0)
    jprev = jax.tree.map(jnp.asarray, prev)
    jround = js.get_strategy(name).plan(None, jplan.build_cohort_spec(
        js.stack_trees(adapters), kind="ref", r_max=R_MAX,
        client_ranks=ranks, prev_tree=jprev))
    tads, tranks, _, tprev = _port(0)
    strat = ts.get_strategy(name)
    tround = strat.plan(None, tplan.build_cohort_spec(
        ts.stack_trees(tads), kind="ref", r_max=R_MAX, client_ranks=tranks,
        prev_tree=tprev))
    widths = {fi for fo, fi in SPECS.values()} | {fo for fo, fi in
                                                   SPECS.values()}
    assert jround.n_kernel_launches == len(widths)
    assert tround.kind == "packed" and tround.n_kernel_launches == 1
    runtime.reset_counts()
    got = tround(ts.stack_trees(tads), torch.ones(5), tprev)
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    assert_trees_close(got, jround(js.stack_trees(adapters), jnp.ones(5),
                                   jprev), msg=name)


def test_plan_cache_hits_and_misses():
    strat = ts.get_strategy("zeropad").__class__()    # fresh, empty cache
    tads, tranks, tw, tprev = _port(0)
    for _ in range(3):
        strat.aggregate_adapters(tads, tw, r_max=R_MAX, client_ranks=tranks,
                                 backend="ref")
    assert strat.plan_stats == {"hits": 2, "misses": 1}
    strat.aggregate_adapters(tads, tw, r_max=R_MAX,
                             client_ranks=tranks.flip(0), backend="ref")
    assert strat.plan_stats == {"hits": 2, "misses": 2}


@pytest.mark.parametrize("name", ["rbla", "zeropad"])
def test_layer_stacked_pairs_pack(name):
    """Pairs with a leading layer axis and per-layer ranks pack row-wise."""
    rng = np.random.default_rng(5)
    clients = []
    for _ in range(3):
        ranks = jnp.asarray(rng.integers(1, 9, 2), jnp.int32)
        clients.append({"blk": {
            "A": jnp.asarray(rng.normal(size=(2, 8, 10)), jnp.float32),
            "B": jnp.asarray(rng.normal(size=(2, 6, 8)), jnp.float32),
            "rank": ranks}})
    w = jnp.asarray([1.0, 2.0, 0.5])
    want = js.get_strategy(name).aggregate_adapters(clients, w, r_max=8,
                                                    backend="ref")
    got = ts.get_strategy(name).aggregate_adapters(
        [port_tree(c) for c in clients], torch.as_tensor(np.array(w)),
        r_max=8, backend="ref")
    assert_trees_close(got, want)


def test_rbla_norm_refuses_layer_stacked_pairs():
    """A layer-stacked cohort cannot pack for mean_norm; the per-leaf path
    behind the plan refuses it, as the reference does."""
    rng = np.random.default_rng(6)
    clients = [{"blk": {"A": torch.as_tensor(rng.normal(size=(2, 8, 10))),
                        "B": torch.as_tensor(rng.normal(size=(2, 6, 8))),
                        "rank": torch.tensor([3, 5], dtype=torch.int32)}}
               for _ in range(2)]
    strat = ts.get_strategy("rbla_norm")
    spec = tplan.build_cohort_spec(ts.stack_trees(clients), kind="ref",
                                   r_max=8)
    assert strat.plan(None, spec).kind == "eager"
    with pytest.raises(NotImplementedError, match="scalar-rank"):
        strat.aggregate_adapters(clients, torch.ones(2), r_max=8,
                                 backend="ref")


def test_aggregate_round_matches_reference():
    adapters, ranks, weights, prev = _cohort(1)
    bases = [{"fc1": {"b": np.full((12,), float(i), np.float32)}}
             for i in range(5)]
    n_ex = [float(v) for v in np.array(weights) * 10]
    jstate = js.ServerState(adapters=jax.tree.map(jnp.asarray, prev),
                            base_trainable={"fc1": {"b": jnp.zeros(12)}},
                            r_max=R_MAX)
    jupd = [js.ClientUpdate(adapters=a, base_trainable=jax.tree.map(
        jnp.asarray, b), n_examples=n, rank=int(r))
        for a, b, n, r in zip(adapters, bases, n_ex, np.array(ranks))]
    want = js.get_strategy("rbla").aggregate(jstate, jupd, backend="ref")
    tstate = ts.ServerState(adapters=port_tree(prev),
                            base_trainable={"fc1": {"b": torch.zeros(12)}},
                            r_max=R_MAX)
    tupd = [ts.ClientUpdate(adapters=port_tree(a), base_trainable=port_tree(b),
                            n_examples=n, rank=int(r))
            for a, b, n, r in zip(adapters, bases, n_ex, np.array(ranks))]
    got = ts.get_strategy("rbla").aggregate(tstate, tupd, backend="ref",
                                            device="cpu")
    assert_trees_close(got.adapters, want.adapters)
    assert_trees_close(got.base_trainable, want.base_trainable)
    assert got.round == 1 and got.client_ranks.tolist() == list(
        np.array(ranks))
    assert_trees_close(got.current_rank, want.current_rank)


def test_unported_paths_raise():
    with pytest.raises(ValueError, match="unknown aggregation strategy"):
        ts.get_strategy("nope")
    tads, tranks, tw, _ = _port(0)
    rbla = ts.get_strategy("rbla")
    # the distributed backend is ported: with no process group it is a
    # world of one and agrees with the JAX package's one-device mesh
    adapters, _, weights, _ = _cohort(0)
    assert_trees_close(
        rbla.aggregate_adapters(tads, tw, backend="distributed"),
        js.get_strategy("rbla").aggregate_adapters(adapters, weights,
                                                   backend="distributed"))
    # ... and strategies without a distributed path refuse it by name
    with pytest.raises(NotImplementedError, match="rbla_norm"):
        ts.get_strategy("rbla_norm").aggregate_adapters(
            tads, tw, backend="distributed")
    # the codec slice (item 13) and the fold (item 14) are ported: a bf16
    # cohort plans (and equals its decoded aggregate), and the fold on the
    # kernel backend refuses CPU tensors like every other kernel path
    bf16 = [{k: dict(p, A=p["A"].bfloat16(), B=p["B"].bfloat16())
             for k, p in a.items()} for a in tads]
    dec = [{k: dict(p, A=p["A"].float(), B=p["B"].float())
            for k, p in a.items()} for a in bf16]
    assert_trees_close(rbla.aggregate_adapters(bf16, tw),
                       rbla.aggregate_adapters(dec, tw))
    state = ts.ServerState(adapters=dec[0], base_trainable={}, r_max=R_MAX)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rbla.fold(state, ts.ClientUpdate(adapters=dec[1], base_trainable={}),
                  backend="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rbla.aggregate_adapters(tads, tw, backend="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rbla.aggregate_adapters(tads, tw, backend="pallas", use_plan=False)
    assert ts.list_strategies() == js.list_strategies() == sorted(
        MEAN_FAMILY + ["rbla_clipped", "rbla_trimmed", "rbla_median", "svd",
                       "flora"])


def test_aggregate_defaults_to_the_card():
    tads, _, _, tprev = _port(0)
    state = ts.ServerState(adapters=tprev, base_trainable={}, r_max=R_MAX)
    upd = [ts.ClientUpdate(adapters=a, base_trainable={}) for a in tads]
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        ts.get_strategy("rbla").aggregate(state, upd)
