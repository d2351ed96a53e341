"""The port's per-update fold against the JAX package: ``axpy_fold`` (plain
version and CPU wrapper) against the JAX kernel in interpret mode and its
oracle, the packed fold plan (``build_fold_plan``) against JAX
``RBLAStrategy.fold(backend="pallas")`` for rbla and rbla_ranked, the
default fold of fedavg and zeropad, flora's streaming stack including a
cap crossing, and folding a cohort one update at a time against the
one-shot aggregate for every incremental strategy.

The fold is three separately rounded fp32 operations per element in both
packages, so folds agree within 2e-5 of max|want| (the JAX side runs XLA's
CPU kernels); the port's planned and per-pair folds run the same arithmetic
and agree exactly.  Every fold is one grouped ``axpy_fold`` call
(``axpy_fold_group``): its plain version is held bit for bit against
per-leaf ``axpy_fold_ref`` and within 2e-5 against the JAX kernel, and
every strategy's fold bit for bit against the per-leaf fold (one
``axpy_fold`` per leaf, B transposed) that it replaced.
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
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import (axpy_fold, axpy_fold_group,
                                          axpy_fold_group_ref, axpy_fold_ref)
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


# ------------------------------------------------------ axpy_fold_group --
#: (label, y shape, rate kind): "row" rates over the leading dims
#: ("row2" over two of them), "col" over the leading dims and the last
#: axis (a LoRA B leaf), "value" one number, "first" a 0-d tensor
GROUP_SEGMENTS = [
    ("A 64x784", (64, 784), "row"),
    ("B 784x64", (784, 64), "col"),
    ("A 64x200 ragged", (64, 203), "row"),
    ("B 200x64", (200, 64), "col"),
    ("A layered 3x8x12", (3, 8, 12), "row2"),
    ("B layered 3x10x8", (3, 10, 8), "col"),
    ("bias 200", (200,), "value"),
    ("bias 10", (10,), "first"),
    ("scalar leaf", (), "value"),
]


def _group_inputs(seed, dtype=torch.float32, segments=GROUP_SEGMENTS):
    """numpy-made (ys, xs, alphas, cols) of one grouped fold; a third of
    the rank rows take rate 0 (rows the client does not own)."""
    rng = np.random.default_rng(seed)
    ys, xs, alphas, cols = [], [], [], []
    for _, shape, kind in segments:
        ys.append(torch.as_tensor(rng.normal(size=shape).astype(np.float32)))
        xs.append(torch.as_tensor(rng.normal(size=shape).astype(np.float32)))
        if kind in ("value", "first"):
            a = np.float32(rng.uniform(0.05, 1.0))
            alphas.append(float(a) if kind == "value"
                          else torch.tensor(a))
        else:
            ashape = {"row": shape[:1], "row2": shape[:2],
                      "col": shape[:-2] + shape[-1:]}[kind]
            a = rng.uniform(0.05, 1.0, ashape).astype(np.float32)
            a[rng.random(ashape) < 0.3] = 0.0
            alphas.append(torch.as_tensor(a))
        cols.append(kind == "col")
    return ([y.to(dtype) for y in ys], [x.to(dtype) for x in xs], alphas,
            cols)


def _per_leaf(y, x, alpha, col):
    """One segment through per-leaf ``axpy_fold_ref``, the parent's route:
    rank rows leading (B transposed), trailing dims flattened."""
    if col:
        return _per_leaf(y.transpose(-1, -2), x.transpose(-1, -2),
                         alpha, False).transpose(-1, -2)
    k = alpha.ndim if isinstance(alpha, torch.Tensor) and alpha.ndim else 1
    rows = int(np.prod(y.shape[:k])) if y.ndim else 1
    a = alpha.reshape(rows) if isinstance(alpha, torch.Tensor) and \
        alpha.ndim else alpha
    return axpy_fold_ref(y.reshape(rows, -1), x.reshape(rows, -1),
                         a).reshape(y.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy_fold_group_plain_equals_per_leaf_fold(dtype):
    ys, xs, alphas, cols = _group_inputs(7, getattr(torch, dtype))
    runtime.reset_counts()
    got = axpy_fold_group(ys, xs, alphas, cols=cols)
    assert runtime.PLAIN_CALLS["axpy_fold"] == 1      # one dtype pair
    assert runtime.LAUNCHES["axpy_fold"] == 0
    for g, y, x, a, c in zip(got, ys, xs, alphas, cols):
        assert g.dtype == y.dtype and g.shape == y.shape
        assert torch.equal(g, _per_leaf(y, x, a, c))


@pytest.mark.parametrize("label,shape,kind", GROUP_SEGMENTS)
def test_axpy_fold_group_matches_jax_pallas(label, shape, kind):
    """Each segment of a grouped fold against the JAX kernel in interpret
    mode on the same numpy inputs (B transposed to the JAX layout, rank
    rows leading), within 2e-5 of max|want|."""
    ys, xs, alphas, cols = _group_inputs(11, segments=[(label, shape, kind)])
    (got,) = axpy_fold_group(ys, xs, alphas, cols=cols)
    y, x, g, a = ys[0].numpy(), xs[0].numpy(), got, alphas[0]
    a = a.numpy() if isinstance(a, torch.Tensor) else np.float32(a)
    if kind == "col":           # the JAX layout: the rank axis leads
        y, x = np.swapaxes(y, -1, -2), np.swapaxes(x, -1, -2)
        g = g.transpose(-1, -2)
    # the JAX wrapper folds (R, *dims) with R rank rows (or one 0-d leaf
    # as one row): fold the leading dims the rates cover into R
    rows = a.size if a.ndim else (shape[0] if shape else 1)
    want = jops.axpy_fold(jnp.asarray(y.reshape(rows, -1)),
                          jnp.asarray(x.reshape(rows, -1)),
                          jnp.asarray(a.reshape(-1) if a.ndim else a),
                          interpret=True)
    assert_close(g.reshape(rows, -1), want, msg=label)


def test_axpy_fold_group_counts_one_plain_call_per_dtype_pair():
    f32 = _group_inputs(3)
    bf = _group_inputs(4, torch.bfloat16, GROUP_SEGMENTS[:2])
    ys, xs = f32[0] + bf[0], f32[1] + bf[1]
    runtime.reset_counts()
    got = axpy_fold_group(ys, xs, f32[2] + bf[2], cols=f32[3] + bf[3])
    assert runtime.PLAIN_CALLS["axpy_fold"] == 2      # fp32 and bf16
    assert [g.dtype for g in got] == [y.dtype for y in ys]
    empty = axpy_fold_group([torch.zeros(0, 4)], [torch.zeros(0, 4)], [0.5])
    assert empty[0].shape == (0, 4)
    assert runtime.PLAIN_CALLS["axpy_fold"] == 2      # nothing to fold
    assert axpy_fold_group([], [], []) == []


def test_axpy_fold_group_refuses_bad_segments():
    y = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="x"):
        axpy_fold_group([y], [torch.zeros(4, 2)], [0.5])
    with pytest.raises(ValueError, match="alpha"):
        axpy_fold_group([y], [y], [torch.zeros(3)])
    with pytest.raises(ValueError, match="column-mode alpha"):
        axpy_fold_group([y], [y], [torch.zeros(4)], cols=[True])
    with pytest.raises(ValueError, match="2 alphas"):
        axpy_fold_group([y], [y], [0.5, 0.5])
    with pytest.raises(ValueError, match="needs CUDA"):
        axpy_fold_group([y], [y], [0.5], backend="kernel")
    # the plain version itself takes what the wrapper passes through
    out = axpy_fold_group_ref([y], [y + 1], [torch.full((3,), 0.5)],
                              cols=[True])
    assert torch.equal(out[0], torch.full((4, 3), 0.5))


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
    # one grouped call (here: its plain version) per fold: every pair side
    # and the base leaf share one dtype pair, so one launch on the card
    assert runtime.PLAIN_CALLS["axpy_fold"] == len(tups)
    assert runtime.PLAIN_CALLS["packed_agg"] == 0


@pytest.mark.parametrize("layers", [None, 3])
def test_per_pair_fold_equals_packed_fold(layers):
    """``use_plan=False`` declines the fold plan: the rates are built pair
    by pair, still one grouped axpy_fold call per fold, the same
    arithmetic, the same bits."""
    _, tups = _updates(layers=layers)
    tstr = ts.get_strategy("rbla")
    tst = _tstate(_jstate(js.get_strategy("rbla"), layers=layers))
    runtime.reset_counts()
    packed, _ = _fold_all(tstr, tst, tups, backend="ref")
    n_packed = runtime.PLAIN_CALLS["axpy_fold"]
    per_pair, _ = _fold_all(tstr, tst, tups, backend="ref", use_plan=False)
    assert n_packed == len(tups)
    assert runtime.PLAIN_CALLS["axpy_fold"] - n_packed == len(tups)
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


def _parent_fold(strategy, state, update, fs, w):
    """One fold as the per-leaf path computed it before folds were
    grouped: one ``axpy_fold_ref`` per float leaf, RBLA's per-row rates
    on A and on B transposed, the base at ``w / (mass + w)``.  Returns
    (adapters, base)."""
    alpha = w / (fs.mass + w)
    if isinstance(strategy, ts.RBLAStrategy):
        wa = strategy._fold_adapter_weight(update, w, int(update.rank))

        def pair_fold(pair, upd, dmass):
            rank = torch.as_tensor(upd["rank"], dtype=torch.int32)
            owned = (torch.arange(pair["A"].shape[-2])
                     < rank[..., None]).float()
            a = torch.where(owned > 0, wa / (dmass + wa), 0.0)
            return {"A": _per_leaf(pair["A"], upd["A"], a, False),
                    "B": _per_leaf(pair["B"], upd["B"], a, True),
                    "rank": pair["rank"]}
        adapters = ts._map_pairs(pair_fold, state.adapters, update.adapters,
                                 fs.row_mass)
        new = update.base_trainable
    elif strategy.name == "flora":         # copies: only the base mixes
        adapters, new = None, update.base_trainable
    else:
        agg = strategy.aggregate(state, [update], weights=[w], backend="ref",
                                 device="cpu")
        adapters = tree_map(lambda o, n: _per_leaf(o, n, alpha, False)
                            if o.is_floating_point() else n,
                            state.adapters, agg.adapters)
        new = agg.base_trainable
    base = tree_map(lambda o, n: _per_leaf(o, n, alpha, False),
                    state.base_trainable, new)
    return adapters, base


PARENT_CASES = [(name, dtype, plan) for name in INCREMENTAL
                for dtype in ("float32", "bfloat16")
                for plan in ((True, False) if name in ("rbla", "rbla_ranked")
                             else (True,))]


@pytest.mark.parametrize("name,dtype,use_plan", PARENT_CASES)
def test_fold_equals_parent_per_leaf_fold(name, dtype, use_plan):
    """Every incremental strategy's fold, three folds in a row, bit for
    bit against the per-leaf fold it replaced, in one grouped call per
    fold (two with bf16 adapters beside fp32 base trainables: one per
    dtype pair)."""
    _, tups = _updates(3)
    strat = _configured(ts, name)
    st = _tstate(_jstate(_configured(js, name)))
    st = ts.ServerState(adapters=tree_map(
        lambda t: t.to(getattr(torch, dtype)) if t.is_floating_point() else t,
        st.adapters), base_trainable=st.base_trainable, r_max=st.r_max)
    fs = strat.init_fold(st)
    kw = {} if use_plan else {"use_plan": False}
    for u in tups:
        want_ad, want_base = _parent_fold(strat, st, u, fs, u.n_examples)
        runtime.reset_counts()
        st, fs = strat.fold(st, u, fold_state=fs, backend="ref", **kw)
        groups = 1 if dtype == "float32" or name == "flora" else 2
        assert runtime.PLAIN_CALLS["axpy_fold"] == groups
        if want_ad is not None:
            for a, b in zip(tree_leaves(st.adapters), tree_leaves(want_ad)):
                assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(tree_leaves(st.base_trainable),
                        tree_leaves(want_base)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["fedavg", "zeropad"])
def test_default_fold_matches_jax(name):
    """The default fold: a one-client aggregate mixed in at w / (mass +
    w), against the JAX fold on its reference and kernel backends."""
    jups, tups = _updates()
    jstr, tstr = js.get_strategy(name), ts.get_strategy(name)
    jst = _jstate(jstr)
    tst = _tstate(jst)
    runtime.reset_counts()
    got, _ = _fold_all(tstr, tst, tups, backend="ref")
    # per fold: the one-client aggregate (one grouped call), then one
    # grouped mix of every float leaf: A and B of every pair, the base leaf
    assert runtime.PLAIN_CALLS["packed_agg"] == len(tups)
    assert runtime.PLAIN_CALLS["axpy_fold"] == len(tups)
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
