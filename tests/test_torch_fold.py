"""The port's per-update fold against the JAX package: ``axpy_fold`` (plain
version and CPU wrapper) against the JAX kernel in interpret mode and its
oracle, the packed fold plan (``build_fold_plan``) against JAX
``RBLAStrategy.fold(backend="pallas")`` for rbla and rbla_ranked, the
default fold of fedavg and zeropad, flora's streaming stack including a
cap crossing, and folding a cohort one update at a time against the
one-shot aggregate for every incremental strategy.

The fold is three separately rounded fp32 operations per element in both
packages, so folds agree within 2e-5 of max|want| (the JAX side runs XLA's
CPU kernels); the port's packed and per-pair folds run the same arithmetic
and agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import assert_close, assert_trees_close, port_tree

from repro.core import strategy as js
from repro.kernels.rbla_agg import ops as jops
from repro.kernels.rbla_agg import ref as jref
from repro.lora import init_adapters
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import axpy_fold, axpy_fold_ref
from repro_torch.tree import tree_leaves, tree_map

INCREMENTAL = ["fedavg", "zeropad", "rbla", "rbla_ranked", "flora"]


def _configured(mod, name, cap=None):
    s = mod.get_strategy(name)
    if s.rank_contract == "stacked":
        s = s.with_options(stack_r_cap=cap or 256)
    return s


def _jstate(strategy, seed=99, layers=None):
    r_storage = strategy.server_storage_rank(R_MAX) or R_MAX
    prev = init_adapters(jax.random.PRNGKey(seed), SPECS, r_storage, R_MAX)
    if layers:
        prev = jax.tree.map(lambda x: jnp.stack([x] * layers), prev)
    return js.ServerState(adapters=prev,
                          base_trainable={"b": jnp.zeros((4,), jnp.float32)},
                          r_max=R_MAX)


def _tstate(jstate):
    return ts.ServerState(adapters=port_tree(jstate.adapters),
                          base_trainable=port_tree(jstate.base_trainable),
                          r_max=jstate.r_max)


def _updates(n=5, seed=3, layers=None):
    """(JAX updates, port updates) of one hetero-rank cohort."""
    adapters, ranks, w, bases = hetero_cohort(n, seed=seed, with_bases=True)
    if layers:
        adapters = [jax.tree.map(lambda x: jnp.stack([x] * layers), a)
                    for a in adapters]
    jups = [js.ClientUpdate(adapters=adapters[i], base_trainable=bases[i],
                            n_examples=float(w[i]), rank=int(ranks[i]))
            for i in range(n)]
    tups = [ts.ClientUpdate(adapters=port_tree(u.adapters),
                            base_trainable=port_tree(u.base_trainable),
                            n_examples=u.n_examples, rank=u.rank)
            for u in jups]
    return jups, tups


def _fold_all(strategy, state, updates, weights=None, **kw):
    fs = strategy.init_fold(state)
    for i, u in enumerate(updates):
        w = None if weights is None else weights[i]
        state, fs = strategy.fold(state, u, w, fold_state=fs, **kw)
    return state, fs


# -------------------------------------------------------------- axpy_fold --
@pytest.mark.parametrize("shape", [(64, 784), (256, 200), (64, 10), (7, 3, 5),
                                   (9,)])
@pytest.mark.parametrize("per_row", [True, False])
def test_axpy_fold_plain_matches_jax(shape, per_row):
    rng = np.random.default_rng(sum(shape))
    y = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    if per_row:
        alpha = rng.uniform(0.0, 1.0, shape[0]).astype(np.float32)
        alpha[::3] = 0.0                     # rows the client does not own
    else:
        alpha = np.float32(0.3)
    runtime.reset_counts()
    got = axpy_fold(torch.as_tensor(y), torch.as_tensor(x),
                    torch.as_tensor(alpha))
    assert runtime.PLAIN_CALLS["axpy_fold"] == 1
    assert runtime.LAUNCHES["axpy_fold"] == 0
    want = jref.axpy_fold_ref(jnp.asarray(y), jnp.asarray(x),
                              jnp.asarray(alpha))
    assert_close(got, want)
    kern = jops.axpy_fold(jnp.asarray(y), jnp.asarray(x), jnp.asarray(alpha),
                          interpret=True)
    assert_close(got, kern)
    if per_row:
        np.testing.assert_array_equal(got.numpy()[::3], y[::3])


def test_axpy_fold_bf16_and_scalar_alpha():
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.normal(size=(16, 40)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(16, 40)).astype(np.float32))
    got = axpy_fold(y.bfloat16(), x.bfloat16(), 0.25)
    assert got.dtype == torch.bfloat16
    want = jref.axpy_fold_ref(jnp.asarray(y.numpy(), jnp.bfloat16),
                              jnp.asarray(x.numpy(), jnp.bfloat16), 0.25)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    gen = torch.Generator().manual_seed(0)
    rounded = axpy_fold(y.bfloat16(), x.bfloat16(), 0.25, generator=gen)
    exact = axpy_fold_ref(y.bfloat16(), x.bfloat16(), 0.25,
                          out_dtype=torch.float32)
    assert rounded.dtype == torch.bfloat16
    assert bool(((rounded.float() - exact).abs()
                 <= 2.0 ** -7 * exact.abs()).all())


def test_axpy_fold_refuses_bad_shapes_and_kernel_on_cpu():
    y = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="x"):
        axpy_fold(y, torch.zeros(4, 2), 0.5)
    with pytest.raises(ValueError, match="alpha"):
        axpy_fold(y, y, torch.zeros(3))
    with pytest.raises(ValueError, match="needs CUDA"):
        axpy_fold(y, y, 0.5, backend="kernel")


# ---------------------------------------------------- packed fold plans --
@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("name", ["rbla", "rbla_ranked"])
def test_fold_plan_matches_jax_pallas_fold(name, layers):
    """Every intermediate state of a 5-update stream: the port's packed
    fold against the JAX package's packed fold (``axpy_fold`` in
    interpret mode)."""
    jups, tups = _updates(layers=layers)
    jstr, tstr = js.get_strategy(name), ts.get_strategy(name)
    jst = _jstate(jstr, layers=layers)
    tst = _tstate(jst)
    jfs, tfs = jstr.init_fold(jst), tstr.init_fold(tst)
    runtime.reset_counts()
    for ju, tu in zip(jups, tups):
        jst, jfs = jstr.fold(jst, ju, fold_state=jfs, backend="pallas")
        tst, tfs = tstr.fold(tst, tu, fold_state=tfs, backend="ref")
        assert_trees_close(tst.adapters, jax.tree.map(np.asarray,
                                                      jst.adapters))
        assert_trees_close(tst.base_trainable,
                           jax.tree.map(np.asarray, jst.base_trainable))
        for got, want in zip(ts._flat_pair_values(tfs.row_mass),
                             js._flat_pair_values(jfs.row_mass)):
            assert_close(got, want)
    # one launch (here: plain call) per bucket and one per base leaf
    n_buckets = len(tplan._make_buckets(tplan.build_state_spec(
        tst.adapters, kind="ref"), use_mask=True))
    assert runtime.PLAIN_CALLS["axpy_fold"] == len(tups) * (n_buckets + 1)
    assert runtime.PLAIN_CALLS["packed_agg"] == 0


@pytest.mark.parametrize("layers", [None, 3])
def test_per_pair_fold_equals_packed_fold(layers):
    """``use_plan=False`` declines the packed path: two axpy_fold calls per
    pair, the same arithmetic, the same bits."""
    _, tups = _updates(layers=layers)
    tstr = ts.get_strategy("rbla")
    tst = _tstate(_jstate(js.get_strategy("rbla"), layers=layers))
    runtime.reset_counts()
    packed, _ = _fold_all(tstr, tst, tups, backend="ref")
    n_packed = runtime.PLAIN_CALLS["axpy_fold"]
    per_pair, _ = _fold_all(tstr, tst, tups, backend="ref", use_plan=False)
    n_pairs = len(SPECS)
    assert (runtime.PLAIN_CALLS["axpy_fold"] - n_packed
            == len(tups) * (2 * n_pairs + 1))
    for a, b in zip(tree_leaves(packed.adapters),
                    tree_leaves(per_pair.adapters)):
        assert torch.equal(a, b)


def test_fold_plan_is_cached_per_state_spec():
    _, tups = _updates(2)
    tstr = ts.get_strategy("rbla").with_options()
    tst = _tstate(_jstate(js.get_strategy("rbla")))
    _fold_all(tstr, tst, tups, backend="ref")
    assert len(tstr.__dict__["_fold_plan_cache"]) == 1
    (spec,) = tstr.__dict__["_fold_plan_cache"]
    assert spec.kind == "ref" and spec.device == "cpu"
    bf = ts.ServerState(adapters=tree_map(
        lambda t: t.bfloat16() if t.is_floating_point() else t,
        tst.adapters), base_trainable=tst.base_trainable, r_max=R_MAX)
    tstr.fold(bf, tups[0], backend="ref")
    assert len(tstr.__dict__["_fold_plan_cache"]) == 2    # dtype is keyed


@pytest.mark.parametrize("name", ["fedavg", "zeropad"])
def test_default_fold_matches_jax(name):
    """The default fold: a one-client aggregate mixed in at w / (mass +
    w), against the JAX fold on its reference and kernel backends."""
    jups, tups = _updates()
    jstr, tstr = js.get_strategy(name), ts.get_strategy(name)
    jst = _jstate(jstr)
    tst = _tstate(jst)
    n_buckets = len(tplan._make_buckets(tplan.build_state_spec(
        tst.adapters, kind="ref"), use_mask=True))
    runtime.reset_counts()
    got, _ = _fold_all(tstr, tst, tups, backend="ref")
    # per fold: the one-client aggregate (one call per bucket), then one
    # mix per float leaf: A and B of every pair, and the base leaf
    assert runtime.PLAIN_CALLS["packed_agg"] == len(tups) * n_buckets
    assert runtime.PLAIN_CALLS["axpy_fold"] == len(tups) * (2 * len(SPECS)
                                                            + 1)
    for backend in ("ref", "pallas"):
        want, _ = _fold_all(jstr, jst, jups, backend=backend)
        assert_trees_close(got.adapters,
                           jax.tree.map(np.asarray, want.adapters),
                           msg=backend)
        assert_trees_close(got.base_trainable,
                           jax.tree.map(np.asarray, want.base_trainable))


@pytest.mark.parametrize("cap", [256, 16])
def test_flora_streaming_fold_matches_jax(cap):
    """Below the cap every fold is copies and column rescales; at cap 16
    the stream crosses it mid-way and re-projects by SVD (compared in
    product space, where singular-vector signs cancel)."""
    jups, tups = _updates()
    jstr = _configured(js, "flora", cap)
    tstr = _configured(ts, "flora", cap)
    jst = _jstate(jstr)
    tst = _tstate(jst)
    jfs, tfs = jstr.init_fold(jst), tstr.init_fold(tst)
    crossed = False
    for ju, tu in zip(jups, tups):
        jst, jfs = jstr.fold(jst, ju, fold_state=jfs, backend="ref")
        tst, tfs = tstr.fold(tst, tu, fold_state=tfs, backend="ref")
        for k in SPECS:
            assert int(tst.adapters[k]["rank"]) == int(jst.adapters[k]["rank"])
            assert_close(tst.adapters[k]["B"] @ tst.adapters[k]["A"],
                         np.asarray(jst.adapters[k]["B"])
                         @ np.asarray(jst.adapters[k]["A"]))
        crossed |= any(p["anchor_mass"] is not None
                       for p in tfs.extra["pairs"])
        assert ([p["seg_ranks"] for p in tfs.extra["pairs"]]
                == [p["seg_ranks"] for p in jfs.extra["pairs"]])
    assert crossed == (cap == 16)
    if cap == 256:
        assert_trees_close(tst.adapters, jax.tree.map(np.asarray,
                                                      jst.adapters))


# --------------------------------------------------- fold == aggregate --
@pytest.mark.parametrize("name", INCREMENTAL)
def test_fold_one_at_a_time_equals_one_shot_aggregate(name):
    """The parity gate: zero-staleness folding of a cohort reproduces the
    one-shot cohort aggregate (and the JAX package's)."""
    jups, tups = _updates()
    tstr = _configured(ts, name)
    jstr = _configured(js, name)
    jst = _jstate(jstr)
    tst = _tstate(jst)
    w = [u.n_examples for u in tups]
    folded, _ = _fold_all(tstr, tst, tups, w, backend="ref")
    one_shot = tstr.aggregate(tst, tups, weights=w, backend="ref",
                              device="cpu")
    want = jstr.aggregate(jst, jups, weights=jnp.asarray(w), backend="ref")
    for got in (folded, one_shot):
        if name == "flora":          # live rank equal, B A equal
            for k in SPECS:
                assert_close(got.adapters[k]["B"] @ got.adapters[k]["A"],
                             np.asarray(want.adapters[k]["B"])
                             @ np.asarray(want.adapters[k]["A"]))
        else:
            assert_trees_close(got.adapters,
                               jax.tree.map(np.asarray, want.adapters))
        assert_trees_close(got.base_trainable,
                           jax.tree.map(np.asarray, want.base_trainable))


@pytest.mark.parametrize("name", INCREMENTAL)
def test_fold_never_writes_the_anchor(name):
    """Two folds from one anchor state: the anchor's tensors, the update's
    and the second fold's result are untouched by the first."""
    _, tups = _updates(2)
    tstr = _configured(ts, name)
    anchor = _tstate(_jstate(_configured(js, name)))
    before = tree_map(torch.clone, (anchor.adapters, anchor.base_trainable))
    upd_before = tree_map(torch.clone, tups[0].adapters)
    a, _ = tstr.fold(anchor, tups[0], backend="ref")
    b, _ = tstr.fold(anchor, tups[1], backend="ref")
    after = (anchor.adapters, anchor.base_trainable)
    for x, y in zip(tree_leaves(before), tree_leaves(after)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(upd_before), tree_leaves(tups[0].adapters)):
        assert torch.equal(x, y)
    shared = {id(t) for t in tree_leaves(after)}
    assert not any(id(t) in shared for t in tree_leaves(a.adapters)
                   if t.is_floating_point())
    assert not all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a.adapters), tree_leaves(b.adapters)))


def test_fold_refuses_non_positive_weight():
    _, tups = _updates(1)
    for name in ("rbla", "fedavg", "flora"):
        tstr = _configured(ts, name)
        tst = _tstate(_jstate(_configured(js, name)))
        with pytest.raises(ValueError, match="positive weight"):
            tstr.fold(tst, tups[0], 0.0, backend="ref")


def test_supports_incremental_matches_jax():
    for name in ts.list_strategies():
        assert (ts.get_strategy(name).supports_incremental
                == js.get_strategy(name).supports_incremental), name
