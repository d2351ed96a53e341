"""The port's distributed aggregation (``repro_torch.core.distributed``, the
strategies' collective paths, ``repro_torch.launch.mesh``) against the JAX
package's ``backend="distributed"``, on numpy cohorts made from a seed.

* **A world of one**, in this process with no process group: every
  strategy with a distributed path, prev on and off, ranks given or
  inferred, layer-stacked pairs, int8 and bf16 encoded cohorts, against
  JAX's one-device mesh; no collective is called.  The refusals (rbla_norm
  and the robust family, flora's and svd's leafwise aggregators,
  rbla_ranked's one-client collective) raise as in JAX.
* **gloo worlds of 2 and 4**, one spawn of ``tests/_dist_child.py`` per
  world size (a fixture of this module; no process group is ever
  initialised in the test process): even (8) and uneven (7, 3) cohorts,
  ``make_distributed_aggregator`` on each rank's slice, the one-client
  ``rbla_tree_allreduce`` round of ``tests/test_distributed.py::
  test_fl_round_spmd``, prev retention, flora with prev as its first
  contributor and ``make_test_mesh``.  Every rank's result is held against
  JAX, and the collectives are counted: one ``all_reduce`` a mean round,
  one ``all_gather`` a gathered round.
* **End to end**: ``run_simulation`` and the async service with
  ``backend="distributed"`` against the JAX package's, from the JAX run's
  initial model and batch indices.

Tolerance: 2e-5 of max|want| in fp32; svd and flora as products ``B @ A``
(their factors carry arbitrary signs and a cohort-dependent live rank).
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import (assert_close, assert_trees_close,
                           async_reference_inputs, port_tree,
                           sim_reference_inputs, spy_states)

from repro.core import codec as jcodec
from repro.core import strategy as js
from repro.fl import AsyncFLConfig as JAsyncConfig
from repro.fl import FLConfig as JConfig
from repro.fl import run_async_simulation as j_run_async
from repro.fl import run_simulation as j_run
from repro.lora import adapter_masks as j_adapter_masks
from repro.lora import init_adapters as j_init_adapters
from repro.lora import set_ranks as j_set_ranks
from repro_torch.core import codec as tcodec
from repro_torch.core import compat
from repro_torch.core import strategy as ts
from repro_torch.core.distributed import (make_distributed_aggregator,
                                          rbla_allreduce)
from repro_torch.fl import AsyncFLConfig, FLConfig, run_async_simulation
from repro_torch.fl import run_simulation
from repro_torch.kernels import runtime
from repro_torch.lora import adapter_masks as t_adapter_masks
from repro_torch.tree import tree_leaves

METHODS = ["fedavg", "zeropad", "rbla", "rbla_ranked", "svd", "flora"]
REFUSING = ["rbla_norm", "rbla_clipped", "rbla_trimmed", "rbla_median"]
PRODUCT_SPACE = ("svd", "flora")
CAP = 64                       # flora's stack_r_cap: every cohort here stacks
CHILD = Path(__file__).resolve().parent / "_dist_child.py"
CHILD_TIMEOUT = 120            # seconds, each rank of a spawned world


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(mod, name):
    s = mod.get_strategy(name)
    return s.with_options(stack_r_cap=CAP) if name == "flora" else s


def _assert_agrees(got, want, method, msg=""):
    """``got`` a port tree (torch or numpy leaves), ``want`` a JAX one."""
    want = _np(want)
    if method not in PRODUCT_SPACE:
        assert_trees_close(got, want, msg=msg)
        return
    for k, p in want.items():
        g = got[k]
        assert int(np.max(np.asarray(g["rank"]))) == int(np.max(p["rank"])), msg
        gB, gA = np.asarray(g["B"], np.float32), np.asarray(g["A"], np.float32)
        assert_close(np.matmul(gB, gA), np.matmul(p["B"], p["A"]),
                     msg=f"{msg}/{k}")


def _prev(method, adapters, ranks, w, seed=99):
    """A previous global: flora's is its own aggregate at the cap (a live
    rank below it); the others' full-rank noise at storage R_MAX."""
    if method == "flora":
        return _pair(js, "flora").aggregate_adapters(
            adapters, w, r_max=R_MAX, client_ranks=ranks, backend="ref")
    prev = j_init_adapters(jax.random.PRNGKey(seed), SPECS, R_MAX, R_MAX)
    return jax.tree.map(lambda x: x + 1.0 if x.dtype == jnp.float32 else x,
                        prev)


# ---------------------------------------------------------- a world of one --
@pytest.mark.parametrize("given", [True, False], ids=["ranks", "inferred"])
@pytest.mark.parametrize("with_prev", [True, False], ids=["prev", "noprev"])
@pytest.mark.parametrize("method", METHODS)
def test_world_of_one_matches_jax(method, with_prev, given):
    adapters, ranks, w = hetero_cohort(5, seed=1)
    prev = _prev(method, adapters, ranks, w) if with_prev else None
    kw = dict(r_max=R_MAX, client_ranks=ranks if given else None)
    want = _pair(js, method).aggregate_adapters(
        adapters, w, prev_global=prev, backend="distributed", **kw)
    runtime.reset_counts()
    got = _pair(ts, method).aggregate_adapters(
        [port_tree(a) for a in adapters], torch.as_tensor(np.asarray(w)),
        r_max=R_MAX,
        client_ranks=torch.as_tensor(np.asarray(ranks)) if given else None,
        prev_global=None if prev is None else port_tree(prev),
        backend="distributed")
    assert runtime.COLLECTIVES == {"all_reduce": 0, "all_gather": 0,
                                   "all_to_all": 0}
    _assert_agrees(got, want, method)


def _layered(seed, n=4, layers=2, fo=6, fi=10):
    """``n`` clients with one layer-stacked pair (A (L, R_MAX, fi), B (L, fo,
    R_MAX)), each client's rank uniform over its layers (flora's rule)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, R_MAX + 1, n)
    clients = []
    for r in ranks:
        live = np.arange(R_MAX) < r
        clients.append({"blk": {
            "A": (rng.normal(size=(layers, R_MAX, fi))
                  * live[None, :, None]).astype(np.float32),
            "B": (rng.normal(size=(layers, fo, R_MAX))
                  * live[None, None, :]).astype(np.float32),
            "rank": np.full((layers,), r, np.int32)}})
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return clients, ranks.astype(np.int32), w


@pytest.mark.parametrize("method", METHODS)
def test_world_of_one_layer_stacked_matches_jax(method):
    clients, ranks, w = _layered(7)
    prev = None
    if method != "flora":
        rng = np.random.default_rng(8)
        prev = {"blk": {"A": rng.normal(size=(2, R_MAX, 10)).astype(
            np.float32), "B": rng.normal(size=(2, 6, R_MAX)).astype(
            np.float32), "rank": np.full((2,), R_MAX, np.int32)}}
    jclients = [jax.tree.map(jnp.asarray, c) for c in clients]
    want = _pair(js, method).aggregate_adapters(
        jclients, jnp.asarray(w), r_max=R_MAX, client_ranks=jnp.asarray(ranks),
        prev_global=None if prev is None else jax.tree.map(jnp.asarray, prev),
        backend="distributed")
    got = _pair(ts, method).aggregate_adapters(
        [port_tree(c) for c in clients], torch.as_tensor(w), r_max=R_MAX,
        client_ranks=torch.as_tensor(ranks),
        prev_global=None if prev is None else port_tree(prev),
        backend="distributed")
    if method not in PRODUCT_SPACE:
        assert_trees_close(got, _np(want))
        return
    g, p = got["blk"], _np(want)["blk"]
    assert np.array_equal(np.asarray(g["rank"]), p["rank"])
    for layer in range(2):
        assert_close(g["B"][layer] @ g["A"][layer],
                     p["B"][layer] @ p["A"][layer], msg=f"layer {layer}")


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("method", METHODS)
def test_world_of_one_encoded_cohort_matches_jax(method, codec):
    """Encoded uploads decode before a distributed round, in both
    packages."""
    adapters, ranks, w = hetero_cohort(5, seed=3)
    prev = _prev(method, adapters, ranks, w, seed=5)
    jenc = [jcodec.encode_adapters(a, codec) for a in adapters]
    tenc = [tcodec.encode_adapters(port_tree(a), codec) for a in adapters]
    want = _pair(js, method).aggregate_adapters(
        jenc, w, r_max=R_MAX, prev_global=prev, backend="distributed")
    got = _pair(ts, method).aggregate_adapters(
        tenc, torch.as_tensor(np.asarray(w)), r_max=R_MAX,
        prev_global=port_tree(prev), backend="distributed")
    _assert_agrees(got, want, method)


def _refusal(case):
    """Call the port's path that ``case`` names (all must raise)."""
    tads = [port_tree(a) for a in hetero_cohort(3, seed=0)[0]]
    w = torch.ones(3)
    if case in REFUSING:
        return ts.get_strategy(case).aggregate_adapters(
            tads, w, r_max=R_MAX, backend="distributed")
    if case in ("flora_aggregator", "svd_aggregator"):
        return ts.get_strategy(case.split("_")[0]).make_distributed_aggregator(
            None)
    if case == "rbla_ranked_allreduce":
        return rbla_allreduce(tads[0]["fc1"]["A"], None, 1.0,
                              method="rbla_ranked")
    raise ValueError(case)


@pytest.mark.parametrize("case,match", [
    *[(m, m) for m in REFUSING],
    ("flora_aggregator", "ragged"), ("svd_aggregator", "distributed"),
    ("rbla_ranked_allreduce", "rbla_ranked")])
def test_documented_refusals(case, match):
    with pytest.raises(NotImplementedError, match=match):
        _refusal(case)


def test_fold_maps_distributed_to_the_devices_own_backend():
    """One update has nothing to distribute: a distributed fold is the
    device's own fold (the plain version on the CPU), bit for bit, and a
    strategy without a distributed path refuses it by name."""
    adapters, ranks, w = hetero_cohort(3, seed=2)
    for name in ("rbla", "fedavg", "flora"):
        s = _pair(ts, name)
        state = ts.ServerState(
            adapters=port_tree(_prev(name, adapters, ranks, w)),
            base_trainable={"b": torch.zeros(4)}, r_max=R_MAX)
        upd = ts.ClientUpdate(adapters=port_tree(adapters[0]),
                              base_trainable={"b": torch.ones(4)},
                              rank=int(ranks[0]))
        got, _ = s.fold(state, upd, 2.0, backend="distributed")
        want, _ = s.fold(state, upd, 2.0, backend="ref")
        for a, b in zip(tree_leaves((got.adapters, got.base_trainable)),
                        tree_leaves((want.adapters, want.base_trainable))):
            assert torch.equal(a, b), name
    state = ts.ServerState(adapters=port_tree(_prev("rbla", adapters, ranks,
                                                    w)),
                           base_trainable={}, r_max=R_MAX)
    with pytest.raises(NotImplementedError, match="rbla_norm"):
        ts.get_strategy("rbla_norm").fold(
            state, ts.ClientUpdate(adapters=port_tree(adapters[0]),
                                   base_trainable={}), backend="distributed")


def test_backend_resolution_and_mesh_without_a_group():
    assert runtime.resolve_backend("distributed", "cpu") == "distributed"
    with pytest.raises(ValueError, match="strategy path"):
        runtime.use_kernel("distributed", torch.ones(2), "packed_agg")
    assert compat.axis_size() == 1
    assert compat.client_slices(7, 4) == [(0, 2), (2, 4), (4, 6), (6, 7)]
    assert compat.client_slices(3, 4)[-1] == (3, 3)     # a rank holds none
    from repro_torch.core.plan import default_client_mesh
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    assert default_client_mesh("clients") is None
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        make_test_mesh((2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True)


# ------------------------------------------------------ gloo worlds of 2, 4 --
def _cohort_np(n, seed, **kw):
    adapters, ranks, w = hetero_cohort(n, seed=seed, **kw)
    return [_np(a) for a in adapters], np.asarray(ranks), np.asarray(w)


def _spmd_round(world):
    """``test_fl_round_spmd``'s round at ``world`` clients, one a rank:
    client k at rank ``(k + 1) * 8 // world`` pushes A by 0.1 x its data
    mean; the JAX package's want through its reference aggregate."""
    server = _np(j_init_adapters(jax.random.PRNGKey(0), {"fc1": (16, 8)},
                                 r_max=8, rank=8))
    xs = np.arange(world, dtype=np.float32)[:, None] * np.ones((world, 4),
                                                             np.float32)
    client_ranks = [(k + 1) * 8 // world for k in range(world)]
    clients = []
    for k, r in enumerate(client_ranks):
        ad = j_set_ranks(jax.tree.map(jnp.asarray, server), r)
        ad = {"fc1": dict(ad["fc1"], A=ad["fc1"]["A"] + 0.1 * xs[k].mean())}
        clients.append(j_set_ranks(ad, r))
    want = js.get_strategy("rbla").aggregate_adapters(
        clients, jnp.ones(world), client_ranks=jnp.asarray(client_ranks),
        backend="ref")
    case = dict(name="spmd_round", kind="tree_allreduce", server=server,
                xs=xs, client_ranks=client_ranks)
    return case, {"fc1": {"A": want["fc1"]["A"], "B": want["fc1"]["B"]}}


@functools.cache
def _gloo_cases(world):
    """The cases of one spawned world and each one's JAX want, tagged with
    how it is compared."""
    cases, wants = _gloo_common_cases()
    case, want = _spmd_round(world)
    return cases + [case], dict(wants, **{case["name"]: ("spmd", want)})


@functools.cache
def _gloo_common_cases():
    cases, wants = [], {}
    for n in (8, 7):
        adapters, ranks, w = _cohort_np(n, seed=10 + n)
        for method in METHODS:
            prev = _np(_prev(method, adapters, ranks, w))
            name = f"agg-{method}-n{n}"
            cases.append(dict(name=name, kind="agg", method=method,
                              options={"stack_r_cap": CAP}
                              if method == "flora" else None,
                              adapters=adapters, weights=w, ranks=ranks,
                              r_max=R_MAX, prev=prev))
            wants[name] = (method, _pair(js, method).aggregate_adapters(
                adapters, w, r_max=R_MAX, client_ranks=ranks,
                prev_global=prev, backend="distributed"))
    adapters, ranks, w = _cohort_np(7, seed=20)
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("clients",))
    stacked = js.stack_trees(adapters)
    for method in ("rbla", "zeropad", "fedavg", "rbla_ranked"):
        s = js.get_strategy(method)
        wt = s.transform_weights(jnp.asarray(w), jnp.asarray(ranks))
        masks = jax.tree.map(
            lambda x, m: jnp.broadcast_to(m.astype(jnp.float32), x.shape),
            stacked, js.stack_trees([j_adapter_masks(a) for a in adapters]))
        out = s.make_distributed_aggregator(mesh1, "clients")(stacked,
                                                               masks, wt)
        name = f"local-{method}"
        cases.append(dict(name=name, kind="local_aggregator", method=method,
                          adapters=adapters, weights=w, ranks=ranks))
        wants[name] = ("factors", {k: {f: p[f] for f in ("A", "B")}
                                   for k, p in out.items()})
    # an all-low-rank cohort keeps the rows no participant owns
    adapters, ranks, w = _cohort_np(4, seed=4, r_lo=2, r_hi=3)
    prev = _np(_prev("rbla", adapters, ranks, w))
    cases.append(dict(name="retain-rbla", kind="agg", method="rbla",
                      adapters=adapters, weights=w, ranks=ranks, r_max=R_MAX,
                      prev=prev))
    wants["retain-rbla"] = ("retain", (prev, int(ranks.max()),
                                       js.get_strategy("rbla")
                                       .aggregate_adapters(
                                           adapters, w, r_max=R_MAX,
                                           client_ranks=ranks,
                                           prev_global=prev,
                                           backend="distributed")))
    # flora: the previous global is the first contributor (3 clients)
    adapters, ranks, w = _cohort_np(3, seed=6, r_lo=1, r_hi=3)
    flora = _pair(js, "flora")
    prev = _np(flora.aggregate_adapters(adapters, w, r_max=R_MAX,
                                        client_ranks=ranks, backend="ref"))
    cases.append(dict(name="flora-prev-first", kind="agg", method="flora",
                      options={"stack_r_cap": CAP}, adapters=adapters,
                      weights=w, ranks=ranks, r_max=R_MAX, prev=prev))
    wants["flora-prev-first"] = ("flora_prev", (prev, int(ranks.sum()),
                                                flora.aggregate_adapters(
                                                    adapters, w, r_max=R_MAX,
                                                    client_ranks=ranks,
                                                    prev_global=prev,
                                                    backend="distributed")))
    cases.append(dict(name="mesh", kind="mesh"))
    return cases, wants


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """``gloo_world(world)``: spawn ``world`` ranks of
    ``tests/_dist_child.py`` once per world size (a ``FileStore`` under a
    temporary directory, a timeout per rank) and return each rank's
    ``(arrays, meta)``."""
    runs = {}

    def get(world):
        if world in runs:
            return runs[world]
        d = tmp_path_factory.mktemp(f"gloo{world}")
        cases, _ = _gloo_cases(world)
        inputs = d / "inputs.pkl"
        with open(inputs, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, str(CHILD), str(inputs), str(d / "store"),
             str(k), str(world), str(d / f"out{k}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for k in range(world)]
        errs = []
        try:
            for k, p in enumerate(procs):
                _, err = p.communicate(timeout=CHILD_TIMEOUT)
                if p.returncode != 0:
                    errs.append(f"rank {k} exited {p.returncode}: "
                                f"{err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert not errs, "\n".join(errs)
        outs = []
        for k in range(world):
            with open(d / f"out{k}.npz.meta", "rb") as f:
                meta = pickle.load(f)
            outs.append((dict(np.load(d / f"out{k}.npz")), meta))
        runs[world] = outs
        return outs
    return get


def _unflat(arrays, name):
    tree = {}
    for key, v in arrays.items():
        parts = key.split("|")
        if parts[0] != name:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


GLOO_CASES = ([f"agg-{m}-n{n}" for n in (8, 7) for m in METHODS]
              + [f"local-{m}" for m in ("rbla", "zeropad", "fedavg",
                                        "rbla_ranked")]
              + ["spmd_round", "retain-rbla", "flora-prev-first"])


@pytest.mark.parametrize("case", GLOO_CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_matches_jax(world, case, gloo_world):
    outs = gloo_world(world)
    kind, want = _gloo_cases(world)[1][case]
    for rank, (arrays, meta) in enumerate(outs):
        got = _unflat(arrays, case)
        msg = f"world {world} rank {rank} {case}"
        counts = meta[case]["collectives"]
        if kind in PRODUCT_SPACE or kind == "flora_prev":
            assert counts == {"all_reduce": 0, "all_gather": 1,
                              "all_to_all": 0}, msg
        elif kind == "spmd":     # one collective a leaf: A, B, rank
            assert counts == {"all_reduce": 3, "all_gather": 0,
                              "all_to_all": 0}, msg
        else:                    # one all_reduce a round
            assert counts == {"all_reduce": 1, "all_gather": 0,
                              "all_to_all": 0}, msg
        if kind in ("factors", "spmd"):
            for k, p in want.items():
                for f in ("A", "B"):
                    assert_close(got[k][f], p[f], msg=f"{msg} {k}/{f}")
            if kind == "spmd":
                A, base = got["fc1"]["A"], _spmd_round(world)[0]["server"]
                # row 7: owned only by the rank-8 client, kept verbatim
                np.testing.assert_allclose(
                    A[7], base["fc1"]["A"][7] + 0.1 * (world - 1), rtol=1e-5)
                np.testing.assert_allclose(
                    A[0], base["fc1"]["A"][0] + 0.1 * np.mean(
                        np.arange(world)), rtol=1e-5)
        elif kind == "retain":
            prev, r_top, full = want
            _assert_agrees(got, full, "rbla", msg)
            for k in SPECS:
                np.testing.assert_allclose(got[k]["A"][r_top:],
                                           prev[k]["A"][r_top:], rtol=1e-6)
                np.testing.assert_allclose(got[k]["B"][:, r_top:],
                                           prev[k]["B"][:, r_top:], rtol=1e-6)
        elif kind == "flora_prev":
            prev, r_sum, full = want
            _assert_agrees(got, full, "flora", msg)
            r_prev = int(prev["fc1"]["rank"])
            assert int(got["fc1"]["rank"]) == r_prev + r_sum, msg
            np.testing.assert_allclose(got["fc1"]["A"][:r_prev],
                                       prev["fc1"]["A"][:r_prev], rtol=1e-6)
        else:
            _assert_agrees(got, want, kind, msg)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_test_mesh(world, gloo_world):
    for rank, (_, meta) in enumerate(gloo_world(world)):
        got = meta["mesh"]
        if world < 4:
            assert "need 4 ranks" in got["error"]
            continue
        assert got["names"] == ["data", "model"] and got["sizes"] == [2, 2]
        # rank = 2 * data + model: a data group shares the model index
        assert got["groups"]["data"] == [rank % 2, rank % 2 + 2]
        assert got["groups"]["model"] == [rank - rank % 2, rank - rank % 2 + 1]


# -------------------------------------------------------------- end to end --
SIM_CFG = dict(dataset="mnist", model="mlp", rounds=2, n_clients=4,
               n_per_class=20, n_test_per_class=10, local_epochs=1,
               batch_size=16, lr=0.01, r_max=8, seed=42,
               agg_backend="distributed")


@pytest.mark.parametrize("method", ["rbla", "flora"])
def test_simulation_matches_jax_distributed(method, monkeypatch):
    extra = {"stack_r_cap": CAP} if method == "flora" else {}
    jcfg = JConfig(method=method, **SIM_CFG, **extra)
    params, adapters, idx = sim_reference_inputs(
        jcfg, r_storage=extra.get("stack_r_cap"))
    jseen = spy_states(monkeypatch, js.AggregationStrategy)
    jhist = j_run(jcfg)
    tseen = spy_states(monkeypatch, ts.AggregationStrategy)
    thist = run_simulation(
        FLConfig(method=method, **SIM_CFG, **extra), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda rnd, ci: torch.as_tensor(idx[rnd, ci]))
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss, rtol=1e-3)
    if method == "flora":
        for k, p in jseen[-1].adapters.items():
            g = tseen[-1].adapters[k]
            assert int(g["rank"]) == int(p["rank"])
            assert_close(g["B"] @ g["A"], p["B"] @ p["A"], tol=1e-3)
    else:
        assert_trees_close(tseen[-1].adapters, jseen[-1].adapters, tol=1e-3)
    assert_trees_close(tseen[-1].base_trainable, jseen[-1].base_trainable,
                       tol=1e-3)


ASYNC_CFG = dict(dataset="mnist", model="mlp", n_clients=4, n_per_class=20,
                 n_test_per_class=10, local_epochs=1, batch_size=16, lr=0.01,
                 r_max=8, seed=42, total_updates=10, eval_every=5,
                 agg_backend="distributed")


@pytest.mark.parametrize("buffer_size", [1, 3], ids=["streaming",
                                                     "buffered"])
def test_async_service_matches_jax_distributed(buffer_size, monkeypatch):
    """The async service with ``backend="distributed"``: a streaming fold
    is the device's own fold; a buffered flush a distributed round."""
    from repro.fl import AsyncAggregator as JAgg
    from repro_torch.fl import AsyncAggregator as TAgg
    seen = {}
    for name, cls in (("jax", JAgg), ("torch", TAgg)):
        got = seen[name] = []
        orig = cls.flush

        def spy(self, *a, _orig=orig, _got=got, **k):
            out = _orig(self, *a, **k)
            assert self.backend == "distributed"
            _got.append(jax.tree.map(lambda x: np.array(
                x.detach().cpu() if isinstance(x, torch.Tensor) else x),
                out.adapters))
            return out
        monkeypatch.setattr(cls, "flush", spy)
    jcfg = JAsyncConfig(method="rbla", buffer_size=buffer_size, **ASYNC_CFG)
    params, adapters, idx = async_reference_inputs(jcfg)
    jhist = j_run_async(jcfg)
    thist = run_async_simulation(
        AsyncFLConfig(method="rbla", buffer_size=buffer_size, **ASYNC_CFG),
        device="cpu", params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda k, ci: torch.as_tensor(idx[k, ci]))
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss, rtol=1e-3)
    assert len(seen["torch"]) == len(seen["jax"]) > 0
    assert_trees_close(seen["torch"][-1], seen["jax"][-1], tol=1e-3)


def test_local_aggregator_without_a_group_is_the_whole_cohort():
    """``make_distributed_aggregator`` in a world of one reduces the
    clients it is given, as JAX's on a one-device mesh."""
    adapters, ranks, w = hetero_cohort(5, seed=12)
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("clients",))
    stacked = js.stack_trees(adapters)
    masks = jax.tree.map(
        lambda x, m: jnp.broadcast_to(m.astype(jnp.float32), x.shape),
        stacked, js.stack_trees([j_adapter_masks(a) for a in adapters]))
    want = js.get_strategy("rbla").make_distributed_aggregator(
        mesh1, "clients")(stacked, masks, w)
    tstacked = ts.stack_trees([port_tree(a) for a in adapters])
    got = make_distributed_aggregator(None, "clients")(
        tstacked, ts.stack_trees([t_adapter_masks(port_tree(a))
                                  for a in adapters]),
        torch.as_tensor(np.asarray(w)))
    for k in SPECS:
        for f in ("A", "B"):
            assert_close(got[k][f], want[k][f], msg=f"{k}/{f}")
