"""The port's svd strategy (product-space aggregation through the
factored engine) and its packed plan against the JAX package, and three
synchronous rounds against ``repro.fl.run_simulation``.

Singular vectors carry arbitrary signs, so aggregates are compared in
product space, ``B[:, :r] @ A[:r]`` per pair, within 2e-5 of max|want|
(fp32 QR and SVD of two LAPACK builds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import (assert_close, port_tree, sim_reference_inputs,
                           spy_states)

from repro.core import plan as jplan
from repro.core import strategy as js
from repro.fl import FLConfig as JConfig
from repro.fl import run_simulation as j_run
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as ts
from repro_torch.core.variants import svd_project_pair
from repro_torch.fl import FLConfig, run_simulation


def _products(tree):
    out = {}
    for k, p in tree.items():
        A, B = np.asarray(p["A"], np.float32), np.asarray(p["B"], np.float32)
        out[k] = B @ A
    return out


def _assert_same_products(got, want, tol=2e-5):
    g, w = _products(got), _products(want)
    assert set(g) == set(w)
    for k in w:
        assert_close(g[k], w[k], tol=tol, msg=k)


@functools.cache
def _cohort(seed):
    return hetero_cohort(n=5, seed=seed)


@pytest.mark.parametrize("method", ["auto", "dense"])
@pytest.mark.parametrize("use_plan", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_svd_matches_reference_in_product_space(seed, use_plan, method):
    adapters, ranks, weights = _cohort(seed)
    want = js.get_strategy("svd").with_options(
        svd_method=method).aggregate_adapters(
            adapters, weights, r_max=R_MAX, client_ranks=ranks,
            backend="ref")
    got = ts.get_strategy("svd").with_options(
        svd_method=method).aggregate_adapters(
            [port_tree(a) for a in adapters],
            torch.as_tensor(np.array(weights)), r_max=R_MAX,
            client_ranks=torch.as_tensor(np.array(ranks)), backend="ref",
            use_plan=use_plan)
    _assert_same_products(got, want)
    for k, (fo, fi) in SPECS.items():
        assert got[k]["A"].shape == (R_MAX, fi)
        assert got[k]["B"].shape == (fo, R_MAX) and int(got[k]["rank"]) == R_MAX


def test_svd_plan_buckets_pairs_by_geometry():
    adapters, ranks, weights = _cohort(0)
    jround = js.get_strategy("svd").plan(None, jplan.build_cohort_spec(
        js.stack_trees(adapters), kind="ref", r_max=R_MAX,
        client_ranks=ranks))
    tround = ts.get_strategy("svd").plan(None, tplan.build_cohort_spec(
        ts.stack_trees([port_tree(a) for a in adapters]), kind="ref",
        r_max=R_MAX, client_ranks=torch.as_tensor(np.array(ranks))))
    assert tround.kind == jround.kind == "packed"
    assert tround.n_kernel_launches == jround.n_kernel_launches == len(SPECS)


def test_same_shape_pairs_share_one_batched_svd():
    """Three same-shape pairs and one other: two buckets, and the batched
    bucket agrees with the per-pair path."""
    rng = np.random.default_rng(3)
    specs = {"a": (6, 5), "b": (6, 5), "c": (6, 5), "d": (4, 5)}
    clients = []
    for r in (2, 4, 6):
        clients.append({k: {"A": rng.normal(size=(6, fi)).astype(np.float32)
                            * (np.arange(6) < r)[:, None],
                            "B": rng.normal(size=(fo, 6)).astype(np.float32)
                            * (np.arange(6) < r)[None, :],
                            "rank": np.int32(r)}
                        for k, (fo, fi) in specs.items()})
    tclients = [port_tree(c) for c in clients]
    w = torch.tensor([1.0, 2.0, 0.5])
    strat = ts.get_strategy("svd")
    round_ = strat.plan(None, tplan.build_cohort_spec(
        ts.stack_trees(tclients), kind="ref", r_max=6))
    assert round_.n_kernel_launches == 2
    got = strat.aggregate_adapters(tclients, w, r_max=6, backend="ref")
    per_pair = strat.aggregate_adapters(tclients, w, r_max=6, backend="ref",
                                        use_plan=False)
    _assert_same_products(got, per_pair)
    want = js.get_strategy("svd").aggregate_adapters(
        jax.tree.map(jnp.asarray, clients), jnp.asarray(w.numpy()), r_max=6,
        backend="ref")
    _assert_same_products(got, want)


def test_layer_stacked_pairs_match_reference():
    rng = np.random.default_rng(5)
    clients = []
    for _ in range(3):
        ranks = rng.integers(1, 9, 2)
        mask = np.arange(8)[None, :] < ranks[:, None]
        clients.append({"blk": {
            "A": (rng.normal(size=(2, 8, 10)) * mask[:, :, None]).astype(
                np.float32),
            "B": (rng.normal(size=(2, 6, 8)) * mask[:, None, :]).astype(
                np.float32),
            "rank": ranks.astype(np.int32)}})
    w = np.array([1.0, 2.0, 0.5], np.float32)
    want = js.get_strategy("svd").aggregate_adapters(
        jax.tree.map(jnp.asarray, clients), jnp.asarray(w), r_max=8,
        backend="ref")
    got = ts.get_strategy("svd").aggregate_adapters(
        [port_tree(c) for c in clients], torch.as_tensor(w), r_max=8,
        backend="ref")
    for layer in range(2):
        assert_close(got["blk"]["B"][layer] @ got["blk"]["A"][layer],
                     np.asarray(want["blk"]["B"][layer])
                     @ np.asarray(want["blk"]["A"][layer]))


def test_svd_project_pair_matches_reference():
    from repro.core.variants import svd_project_pair as j_project
    adapters, ranks, weights = _cohort(2)
    stacked = js.stack_trees(adapters)["fc1"]
    sc = R_MAX / np.maximum(np.array(ranks, np.float32), 1.0)
    jB, jA = j_project(stacked["B"], stacked["A"], ranks, weights, 5,
                       scales=jnp.asarray(sc))
    tB, tA = svd_project_pair(
        torch.as_tensor(np.array(stacked["B"])),
        torch.as_tensor(np.array(stacked["A"])),
        torch.as_tensor(np.array(ranks)),
        torch.as_tensor(np.array(weights)), 5, scales=torch.as_tensor(sc))
    assert tB.shape == (12, 5) and tA.shape == (5, 16)
    assert_close(tB @ tA, np.asarray(jB) @ np.asarray(jA))


def test_svd_knobs_and_backends():
    svd = ts.get_strategy("svd")
    assert svd.with_options(svd_method="randomized").plan_knobs()[0] == \
        "randomized"
    adapters, ranks, weights = _cohort(0)
    tads = [port_tree(a) for a in adapters]
    # svd has no kernel of its own: the kernel backend runs the engine's
    # math on the tensors' device, here the CPU
    kw = dict(r_max=R_MAX, client_ranks=torch.as_tensor(np.array(ranks)))
    tw = torch.as_tensor(np.array(weights))
    # the distributed backend (a world of one without a process group)
    # gathers the factors and projects them as the ref backend does
    _assert_same_products(svd.aggregate_adapters(tads, tw, r_max=R_MAX,
                                                 backend="distributed"),
                          svd.aggregate_adapters(tads, tw, r_max=R_MAX,
                                                 backend="ref"), tol=0.0)
    _assert_same_products(svd.aggregate_adapters(tads, tw, backend="kernel",
                                                 **kw),
                          svd.aggregate_adapters(tads, tw, backend="ref",
                                                 **kw), tol=0.0)


# ------------------------------------------------------------- simulation --
CFG = dict(dataset="mnist", model="mlp", rounds=3, n_clients=4,
           n_per_class=20, n_test_per_class=10, local_epochs=1,
           batch_size=16, lr=0.01, r_max=8, seed=42)


def test_three_rounds_match_reference(monkeypatch):
    """Per-round accuracy identical to the JAX run; the final global's
    products within 1e-3 of max|want| (three rounds of training and an
    SVD per round, each in two LAPACK builds)."""
    jcfg = JConfig(method="svd", **CFG)
    params, adapters, idx = sim_reference_inputs(jcfg)
    jseen = spy_states(monkeypatch, js.AggregationStrategy)
    jhist = j_run(jcfg)
    tseen = spy_states(monkeypatch, ts.AggregationStrategy)
    thist = run_simulation(
        FLConfig(method="svd", **CFG), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda rnd, ci: torch.as_tensor(idx[rnd, ci]))
    assert thist.test_acc == jhist.test_acc
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss,
                               rtol=1e-3)
    _assert_same_products(tseen[-1].adapters, jseen[-1].adapters, tol=1e-3)
