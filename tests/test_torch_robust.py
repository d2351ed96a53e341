"""The port's robust family: ``packed_robust`` (plain version) against the
JAX package's oracles, the rbla_clipped / rbla_trimmed / rbla_median
strategies against the JAX strategies, their breakdown bound, and three
synchronous rounds against ``repro.fl.run_simulation``.

Tolerances follow ``tests/test_kernels.py``: 2e-5 in fp32 and 2e-2 in bf16,
scaled by max|want| (the two packages sum in different orders).
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import (BF16_TOL, F32_TOL, assert_close,
                           assert_trees_close, port_tree,
                           sim_reference_inputs, spy_states)

from repro.core import strategy as js
from repro.fl import FLConfig as JConfig
from repro.fl import run_simulation as j_run
from repro.kernels.rbla_agg import kernel as jkernel
from repro.kernels.rbla_agg import ref as jref
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as ts
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import packed_robust

ROBUST = ["rbla_clipped", "rbla_trimmed", "rbla_median"]
MODES = ["clipped", "trimmed", "median"]
KNOBS = dict(clip_norm=2.5, trim_frac=0.2)


def _inputs(n, r, d, dtype, seed, with_prev):
    """numpy inputs with unowned rows (rank 0 clients, rows past every
    rank) and ties (one column equal across clients)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, r, n)
    masks = (np.arange(r)[None, :] < ranks[:, None]).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    scales = None
    if dtype == "int8":
        x = rng.integers(-127, 128, (n, r, d)).astype(np.int8)
        x[:, :, 1] = 7
        scales = rng.uniform(0.001, 0.02, (n, r)).astype(np.float32)
        scales[:, 0] = 0.01
    else:
        x = rng.normal(size=(n, r, d)).astype(np.float32)
        x[:, :, 1] = 0.5
        if dtype == "bf16":
            x = x.astype(ml_dtypes.bfloat16)
    out_np = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    prev = rng.normal(size=(r, d)).astype(out_np) if with_prev else None
    return x, masks, weights, prev, scales


def _t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("n", [1, 2, 3, 10, 70])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_packed_robust_plain_matches_jax_ref(mode, dtype, with_prev, n):
    """Every mode x dtype x prev, at cohorts of 1, 2, 3, 10 and 70 clients
    (70 is above the kernel's largest register network, 64)."""
    x, masks, w, prev, scales = _inputs(n, 12, 9, dtype, n, with_prev)
    out_dtype = torch.float32 if dtype == "int8" else None
    got = packed_robust(_t(x), _t(masks), _t(w), _t(prev), mode=mode,
                        scales=_t(scales), out_dtype=out_dtype, **KNOBS)
    jkw = dict(mode=mode, scales=_j(scales),
               out_dtype=jnp.float32 if out_dtype else None, **KNOBS)
    want = jref.packed_robust_ref(_j(x), _j(masks), _j(w), _j(prev), **jkw)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert_close(got, want, tol, f"{mode} {dtype} n={n}")
    # the JAX package's CPU network lowering: the second oracle
    assert_close(got, jref.packed_robust_xla(_j(x), _j(masks), _j(w),
                                             _j(prev), **jkw), tol)


@pytest.mark.parametrize("n", [3, 10])
@pytest.mark.parametrize("mode", MODES)
def test_packed_robust_plain_matches_jax_kernel(mode, n):
    """Against the Pallas kernel itself, interpreted, at an aligned tile."""
    x, masks, w, prev, _ = _inputs(n, 8, 128, "f32", 50 + n, True)
    got = packed_robust(_t(x), _t(masks), _t(w), _t(prev), mode=mode,
                        **KNOBS)
    want = jkernel.packed_robust_pallas(_j(x), _j(masks), _j(w), _j(prev),
                                        mode=mode, interpret=True, **KNOBS)
    assert_close(got, want)


def test_unowned_rows_keep_prev_and_nan_propagates():
    x, masks, w, prev, _ = _inputs(4, 6, 5, "f32", 3, True)
    masks[:, -1] = 0.0
    for mode in MODES:
        got = packed_robust(_t(x), _t(masks), _t(w), _t(prev), mode=mode,
                            **KNOBS)
        assert torch.equal(got[-1], _t(prev)[-1])
    owner = int(np.argmax(masks[:, 0]))
    x[owner, 0, 2] = np.nan
    for mode in ("trimmed", "median"):
        got = packed_robust(_t(x), _t(masks), _t(w), None, mode=mode,
                            **KNOBS)
        assert torch.isnan(got[0, 2]) and torch.isfinite(got[0, 3])


def test_packed_robust_validation():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="unknown robust mode"):
        packed_robust(x, torch.ones(2, 3), torch.ones(2), mode="mean")
    with pytest.raises(ValueError, match="masks"):
        packed_robust(x, torch.ones(3, 3), torch.ones(2), mode="median")
    with pytest.raises(ValueError, match="scales"):
        packed_robust(x, torch.ones(2, 3), torch.ones(2), mode="clipped",
                      scales=torch.ones(2, 2))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        packed_robust(x, torch.ones(2, 3), torch.ones(2), mode="median",
                      backend="kernel")
    runtime.reset_counts()
    packed_robust(x, torch.ones(2, 3), torch.ones(2), mode="median")
    assert runtime.PLAIN_CALLS["packed_robust"] == 1


# ------------------------------------------------------------- strategies --
@functools.cache
def _cohort(seed):
    adapters, ranks, weights = hetero_cohort(n=5, seed=seed, r_hi=R_MAX - 1)
    rng = np.random.default_rng(seed + 100)
    prev = {k: {"A": rng.normal(size=(R_MAX, fi)).astype(np.float32),
                "B": rng.normal(size=(fo, R_MAX)).astype(np.float32),
                "rank": np.int32(R_MAX)}
            for k, (fo, fi) in SPECS.items()}
    return adapters, ranks, weights, prev


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ROBUST)
def test_robust_strategies_match_reference(name, seed):
    adapters, ranks, weights, prev = _cohort(seed)
    jstrat = js.get_strategy(name).with_options(**KNOBS)
    want = jstrat.aggregate_adapters(
        adapters, weights, r_max=R_MAX, client_ranks=ranks,
        prev_global=jax.tree.map(jnp.asarray, prev), backend="ref")
    strat = ts.get_strategy(name).with_options(**KNOBS)
    assert strat.robustness == jstrat.robustness
    tads = [port_tree(a) for a in adapters]
    for use_plan in (True, False):
        got = strat.aggregate_adapters(
            tads, torch.as_tensor(np.array(weights)), r_max=R_MAX,
            client_ranks=torch.as_tensor(np.array(ranks)),
            prev_global=port_tree(prev), backend="ref", use_plan=use_plan)
        assert_trees_close(got, want, msg=f"{name} plan={use_plan}")


@pytest.mark.parametrize("name", ROBUST)
def test_robust_plan_launches_once_per_bucket(name):
    adapters, ranks, weights, prev = _cohort(0)
    strat = ts.get_strategy(name)
    round_ = strat.plan(None, tplan.build_cohort_spec(
        ts.stack_trees([port_tree(a) for a in adapters]), kind="ref",
        r_max=R_MAX, client_ranks=torch.as_tensor(np.array(ranks)),
        prev_tree=port_tree(prev)))
    # every pair side of the round in one grouped call
    assert round_.kind == "packed" and round_.n_kernel_launches == 1
    runtime.reset_counts()
    round_(ts.stack_trees([port_tree(a) for a in adapters]), torch.ones(5),
           port_tree(prev))
    assert runtime.PLAIN_CALLS["packed_robust"] == 1
    assert runtime.PLAIN_CALLS["packed_agg"] == 0


def test_robust_knobs_are_part_of_the_plan_key():
    """A knob changed on an instance never serves a plan built under the
    old value; with_options copies start with no plans."""
    adapters, ranks, weights, prev = _cohort(0)
    tads = [port_tree(a) for a in adapters]
    tw = torch.as_tensor(np.array(weights))
    strat = ts.get_strategy("rbla_clipped").__class__()
    loose = strat.aggregate_adapters(tads, tw, r_max=R_MAX, backend="ref")
    strat.clip_norm = 0.01
    tight = strat.aggregate_adapters(tads, tw, r_max=R_MAX, backend="ref")
    assert strat.plan_stats == {"hits": 0, "misses": 2}
    fresh = ts.get_strategy("rbla_clipped").with_options(clip_norm=0.01)
    assert "_plan_cache" not in fresh.__dict__
    assert_trees_close(fresh.aggregate_adapters(tads, tw, r_max=R_MAX,
                                                backend="ref"),
                       tight)
    assert float(tight["fc1"]["A"].abs().max()) < float(
        loose["fc1"]["A"].abs().max())
    with pytest.raises(ValueError, match="no option"):
        ts.get_strategy("rbla_median").with_options(stack_r_cap=4)


def test_layer_stacked_pairs_pack():
    rng = np.random.default_rng(5)
    clients = []
    for _ in range(4):
        clients.append({"blk": {
            "A": jnp.asarray(rng.normal(size=(2, 8, 10)), jnp.float32),
            "B": jnp.asarray(rng.normal(size=(2, 6, 8)), jnp.float32),
            "rank": jnp.asarray(rng.integers(1, 9, 2), jnp.int32)}})
    w = jnp.asarray([1.0, 2.0, 0.5, 1.5])
    for name in ROBUST:
        want = js.get_strategy(name).aggregate_adapters(clients, w, r_max=8,
                                                        backend="ref")
        got = ts.get_strategy(name).aggregate_adapters(
            [port_tree(c) for c in clients], torch.as_tensor(np.array(w)),
            r_max=8, backend="ref")
        assert_trees_close(got, want, msg=name)


def _max_dist(a, b):
    return max(float((a[k][f] - b[k][f]).abs().max())
               for k in SPECS for f in ("A", "B"))


@pytest.mark.parametrize("name", ROBUST)
def test_breakdown_single_adversary_moves_global_boundedly(name):
    """One client uploading 1e6x-norm factors moves the robust global by
    less than 50 and the rbla global by more than 1e4 (homogeneous
    full-rank cohort of 5: every row has 5 owners)."""
    adapters, _, weights = hetero_cohort(n=5, seed=41, r_lo=R_MAX)
    tads = [port_tree(a) for a in adapters]
    attacked = list(tads)
    attacked[0] = {k: dict(p, A=p["A"] * 1e6, B=p["B"] * 1e6)
                   for k, p in tads[0].items()}
    tw = torch.as_tensor(np.array(weights))

    def move(strat):
        kw = dict(r_max=R_MAX, backend="ref")
        return _max_dist(strat.aggregate_adapters(tads, tw, **kw),
                         strat.aggregate_adapters(attacked, tw, **kw))
    assert move(ts.get_strategy(name).with_options(**KNOBS)) < 50.0
    assert move(ts.get_strategy("rbla")) > 1e4


# ------------------------------------------------------------- simulation --
CFG = dict(dataset="mnist", model="mlp", rounds=3, n_clients=4,
           n_per_class=20, n_test_per_class=10, local_epochs=1,
           batch_size=16, lr=0.01, r_max=8, seed=42)


@pytest.mark.parametrize("method", ROBUST)
def test_three_rounds_match_reference(method, monkeypatch):
    """Per-round accuracy identical to the JAX run; the final global within
    1e-3 (three rounds of training compound fp32 reassociation)."""
    jcfg = JConfig(method=method, **CFG)
    params, adapters, idx = sim_reference_inputs(jcfg)
    jseen = spy_states(monkeypatch, js.AggregationStrategy)
    jhist = j_run(jcfg)
    tseen = spy_states(monkeypatch, ts.AggregationStrategy)
    thist = run_simulation(
        FLConfig(method=method, **CFG), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda rnd, ci: torch.as_tensor(idx[rnd, ci]))
    assert thist.test_acc == jhist.test_acc
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss,
                               rtol=1e-3)
    assert_trees_close(tseen[-1].adapters, jseen[-1].adapters, tol=1e-3,
                       msg=method)
