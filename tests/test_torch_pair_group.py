"""The per-pair rounds as one grouped call (``rbla_agg_group``,
``flora_stack_group`` in ``repro_torch.kernels.rbla_agg``) on the CPU: their
plain twins against the JAX package's ``rbla_agg`` and ``flora_stack``
Pallas kernels leaf by leaf (interpret mode, as the JAX package's tests run
them), and every per-pair strategy's ``aggregate_tree_kernel`` -- the
grouped wrappers switched to their plain twins, as the wrappers do for CPU
tensors -- against JAX's ``aggregate_tree_pallas``: the prev rule with a
client of weight 0 at the top rank, a NaN in a rank row its client does not
own, and the cases where the reference raises.

Inputs are made with numpy from a seed.  Tolerances follow
``tests/test_kernels.py``: 2e-5 in fp32 and 2e-2 in bf16 of max(1,
max|want|) (``_torch_parity.assert_close``); flora is compared as B @ A,
and its stack exactly where both sides scale by the same fp32 numbers.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, SPECS, hetero_cohort
from _torch_parity import (BF16_TOL, F32_TOL, assert_close,
                           assert_trees_close, np32, port_tree)

from repro.core import strategy as js
from repro.kernels.rbla_agg import ops as jops
from repro_torch.core import strategy as ts
from repro_torch.core.masks import stacked_rank_masks
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import (flora_stack_group,
                                          flora_stack_group_ref,
                                          packed_agg_group_ref,
                                          rbla_agg_group,
                                          rbla_agg_group_ref, rbla_agg_ref)
from repro_torch.kernels.rbla_agg.ref import flora_mass_scales

MEAN = ["fedavg", "zeropad", "rbla", "rbla_ranked"]
PER_PAIR = MEAN + ["rbla_norm", "rbla_clipped", "rbla_trimmed",
                   "rbla_median", "flora"]
GROUPED = ("rbla_agg_group", "flora_stack_group", "packed_agg_group",
           "packed_robust_group")


def _t(a, dtype=None):
    """numpy (or JAX) -> torch, bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _plain(monkeypatch):
    """Route the strategies' grouped calls to the plain twins (the wrappers
    take those for CPU tensors; the strategies ask for the kernel)."""
    for name in GROUPED:
        fn = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _fn=fn, **k: _fn(
            *a, **dict(k, backend="ref")))


def _pair_segments(seed, n=6, fans=((12, 16), (10, 12), (3, 40)), r=8,
                   dtype=np.float32, shared=True, zero_rank=True):
    """One per-pair round's segments: each pair's A (n, r, fan_in) and B
    (n, fan_out, r) with random ranks in [0, r] (one column shared by every
    pair, or one a pair), a previous global, weights."""
    rng = np.random.default_rng(seed)
    cols = 1 if shared else len(fans)
    ranks = rng.integers(0, r + 1, (n, cols)).astype(np.int32)
    if zero_rank:
        ranks[0] = 0
    ranks[1] = r
    xs, prevs = [], []
    for fo, fi in fans:
        for shape in ((r, fi), (fo, r)):
            xs.append(rng.normal(size=(n,) + shape).astype(dtype))
            prevs.append(rng.normal(size=shape).astype(dtype))
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rank_cols = [0 if shared else i // 2 for i in range(len(xs))]
    return xs, ranks, w, prevs, rank_cols


# ------------------------------------------------------------ rbla_agg_group --
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["rbla", "zeropad"])
def test_rbla_group_plain_matches_jax_kernel_per_leaf(method, dtype, shared):
    """Each segment of the grouped twin equals JAX's ``rbla_agg`` kernel
    (interpreted) on that leaf, B through its rank-leading transpose."""
    npdt = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    xs, ranks, w, _, rank_cols = _pair_segments(3, dtype=npdt, shared=shared)
    runtime.reset_counts()
    got = rbla_agg_group([_t(x) for x in xs], _t(ranks), _t(w),
                         cols=[i % 2 == 1 for i in range(len(xs))],
                         rank_cols=rank_cols, method=method)
    assert runtime.PLAIN_CALLS["rbla_agg"] == 1
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    for i, (g, x, c) in enumerate(zip(got, xs, rank_cols)):
        xj = jnp.asarray(x)
        if i % 2:
            xj = jnp.swapaxes(xj, 1, 2)
        want = jops.rbla_agg(xj, jnp.asarray(ranks[:, c]), jnp.asarray(w),
                             method=method, interpret=True)
        want = np.asarray(want, np.float32)
        assert g.shape == x.shape[1:] and g.dtype == _t(x).dtype
        assert_close(g, want.T if i % 2 else want, tol, f"segment {i}")


def test_rbla_group_plain_is_the_float_mask_mean_with_positive_weights():
    """Rank masks are the float masks of ``stacked_rank_masks``: with every
    weight positive the per-pair prev rule (no owner) and the plan's (no
    owner mass) agree, so the twins give the same bits."""
    xs, ranks, w, prevs, _ = _pair_segments(4)
    tx, tp = [_t(x) for x in xs], [_t(p) for p in prevs]
    cols = [i % 2 == 1 for i in range(len(xs))]
    got = rbla_agg_group(tx, _t(ranks), _t(w), tp, cols=cols)
    masks = stacked_rank_masks(8, _t(ranks[:, 0]))
    want = packed_agg_group_ref(tx, masks, _t(w), tp, cols=cols,
                                scales=[None] * len(xs),
                                mask_offs=[0] * len(xs),
                                out_dtypes=[torch.float32] * len(xs))
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    one = rbla_agg_ref(tx[0], _t(ranks[:, 0]), _t(w))
    owned = int(ranks.max())
    assert torch.equal(got[0][:owned], one[:owned])


def test_rbla_group_zero_weight_top_rank_client_gives_zero_not_prev():
    """Rank rows only a client of weight 0 owns are 0 (JAX's per-pair
    path: the kernel's 0, then prev only at r >= max rank); the plan's rule
    (no owner mass) would keep prev there.  Rows no client owns keep prev."""
    xs, ranks, w, prevs, _ = _pair_segments(5, n=3, zero_rank=False)
    ranks[:, 0] = [2, 5, 7]
    w[2] = 0.0
    tx, tp = [_t(x) for x in xs], [_t(p) for p in prevs]
    cols = [i % 2 == 1 for i in range(len(xs))]
    got = rbla_agg_group(tx, _t(ranks), _t(w), tp, cols=cols)
    a, b = got[0], got[1]
    assert torch.equal(a[5:7], torch.zeros_like(a[5:7]))
    assert torch.equal(b[:, 5:7], torch.zeros_like(b[:, 5:7]))
    assert torch.equal(a[7:], tp[0][7:]) and torch.equal(b[:, 7:],
                                                         tp[1][:, 7:])
    plan = packed_agg_group_ref(
        tx[:2], stacked_rank_masks(8, _t(ranks[:, 0])), _t(w), tp[:2],
        cols=cols[:2], scales=[None] * 2, mask_offs=[0, 0],
        out_dtypes=[torch.float32] * 2)
    assert torch.equal(plan[0][5:7], tp[0][5:7])


def test_rbla_group_nan_in_an_unowned_row_reaches_the_result():
    """JAX multiplies (w * m) * x: a NaN in a rank row its client does not
    own makes that element NaN wherever another client owns the row, and
    nowhere else."""
    xs, ranks, w, _, _ = _pair_segments(6, n=3, zero_rank=False)
    ranks[:, 0] = [2, 8, 8]
    xs[0][0, 4, 3] = np.nan                      # client 0 owns rows 0..1
    xs[1][0, 2, 6] = np.inf                      # B: rank column 6
    got = rbla_agg_group([_t(x) for x in xs], _t(ranks), _t(w),
                         cols=[i % 2 == 1 for i in range(len(xs))])
    want_a = np.asarray(jops.rbla_agg(jnp.asarray(xs[0]),
                                      jnp.asarray(ranks[:, 0]),
                                      jnp.asarray(w), interpret=True))
    want_b = np.asarray(jops.rbla_agg(jnp.swapaxes(jnp.asarray(xs[1]), 1, 2),
                                      jnp.asarray(ranks[:, 0]),
                                      jnp.asarray(w), interpret=True)).T
    for g, want in ((got[0], want_a), (got[1], want_b)):
        g = g.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
        fin = np.isfinite(want)
        assert_close(g[fin], want[fin])
    assert bool(got[0][4, 3].isnan()) and bool(got[0][4, 2].isfinite())
    assert bool(got[1][2, 6].isnan()) and bool(got[1][2, 5].isfinite())


def test_rbla_group_validation():
    xs, ranks, w, prevs, _ = _pair_segments(7)
    tx = [_t(x) for x in xs]
    with pytest.raises(ValueError, match="unknown kernel method"):
        rbla_agg_group(tx, _t(ranks), _t(w), method="median")
    with pytest.raises(ValueError, match="rank column"):
        rbla_agg_group(tx, _t(ranks), _t(w), rank_cols=[1] * len(tx))
    with pytest.raises(ValueError, match="must be one pair side"):
        rbla_agg_group([tx[0][None]], _t(ranks), _t(w))
    with pytest.raises(ValueError, match="prev"):
        rbla_agg_group(tx[:1], _t(ranks), _t(w), [_t(prevs[1])])
    with pytest.raises(TypeError, match="integers"):
        rbla_agg_group(tx, _t(ranks).float(), _t(w))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rbla_agg_group(tx, _t(ranks), _t(w), backend="kernel")


# --------------------------------------------------------- flora_stack_group --
def _flora_segments(seed, n=5, lead=(), prev_rank=3, cap=40):
    """A per-pair flora round's segments (prev first, live clients by
    index, rank-0 clients skipped): A and B of two pairs."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, 7, n)
    ranks[0] = 0
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    con = ((((-1, prev_rank),) if prev_rank else ())
           + tuple((i, int(r)) for i, r in enumerate(ranks) if r > 0))
    xs, prevs, cols = [], [], []
    for fo, fi in ((9, 16), (4, 7)):
        for col, shape, pshape in ((False, (8, fi), (12, fi)),
                                   (True, (fo, 8), (fo, 12))):
            xs.append(rng.normal(size=(n,) + lead + shape).astype(np.float32))
            prevs.append(rng.normal(size=lead + pshape).astype(np.float32))
            cols.append(col)
    return xs, prevs, cols, con, w, cap


@pytest.mark.parametrize("prev_rank", [0, 3])
def test_flora_group_plain_matches_jax_kernel_per_leaf(prev_rank):
    """Each segment equals JAX's ``flora_stack`` kernel (interpreted) on the
    contributor stack the JAX per-pair path builds for it (cast to fp32,
    padded, B transposed, concatenated), with the same scales."""
    xs, prevs, cols, con, w, cap = _flora_segments(8, prev_rank=prev_rank)
    scales = [None, "mass"] * 2
    runtime.reset_counts()
    got = flora_stack_group([_t(x) for x in xs], [con] * 4,
                            [_t(p) for p in prevs], cap=cap, cols=cols,
                            scales=scales, weights=_t(w), prev_weight=1.0)
    assert runtime.PLAIN_CALLS["flora_stack"] == 1
    mass = np.asarray(flora_mass_scales(_t(w), con, 1.0, 1e-12), np.float32)
    for g, x, p, col, sc in zip(got, xs, prevs, cols, scales):
        if col:
            x, p = np.swapaxes(x, -1, -2), np.swapaxes(p, -1, -2)
        r_st = max(x.shape[-2], p.shape[-2])
        pad = lambda a: np.concatenate([a, np.zeros(          # noqa: E731
            a.shape[:-2] + (r_st - a.shape[-2], a.shape[-1]), a.dtype)], -2)
        stack = np.stack([pad(p) if s < 0 else pad(x[s]) for s, _ in con])
        want = np.asarray(jops.flora_stack(
            jnp.asarray(stack), jnp.asarray(mass if sc else np.ones_like(mass)),
            segs=tuple(r for _, r in con), out_rows=cap, interpret=True))
        np.testing.assert_array_equal(g.numpy(), want.T if col else want)


def test_flora_group_layers_dtypes_and_given_scales():
    """A layer-stacked pair stacks every layer on its own; bf16 leaves are
    scaled in fp32 and rounded once (what an fp32 stack cast back gives);
    given scales follow the contributors."""
    xs, prevs, cols, con, w, cap = _flora_segments(9, lead=(3,))
    tx = [_t(x).bfloat16() for x in xs]
    tp = [_t(p).bfloat16() for p in prevs]
    given = torch.linspace(0.5, 2.0, len(con))
    got = flora_stack_group(tx, [con] * 4, tp, cap=cap, cols=cols,
                            scales=[given, "mass", None, given],
                            weights=_t(w))
    for layer in range(3):
        one = flora_stack_group([t[:, layer] for t in tx], [con] * 4,
                                [p[layer] for p in tp], cap=cap, cols=cols,
                                scales=[given, "mass", None, given],
                                weights=_t(w))
        for g, o in zip(got, one):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g[layer], o)
    a = got[2][1]                                   # unscaled A, layer 1
    off = con[0][1]
    src, rows = con[1]
    assert torch.equal(a[off:off + rows], tx[2][src, 1, :rows])
    assert torch.equal(a[sum(r for _, r in con):],
                       torch.zeros_like(a[sum(r for _, r in con):]))
    b = got[3][1]                                   # given scales, layer 1
    want = (float(given[1]) * tx[3][src, 1, :, :rows].float()).bfloat16()
    assert torch.equal(b[:, off:off + rows], want)


def test_flora_mass_scales_are_the_strategy_composition():
    """The in-order fp32 scales equal the composition the per-pair path
    computed with torch reductions to within their summation order."""
    rng = np.random.default_rng(10)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 7).astype(np.float32))
    con = ((-1, 8), (1, 3), (2, 6), (4, 1), (6, 8))
    got = np.asarray(flora_mass_scales(w, con, 1.0, 1e-12), np.float32)
    masses = torch.stack([1.0 * w.mean()] + [w[s] for s, _ in con[1:]])
    mhat = masses / (masses.sum() + 1e-12)
    segs = np.asarray([r for _, r in con], np.float32)
    want = (mhat * torch.as_tensor(np.float32(segs.sum()) / segs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_flora_group_validation():
    xs, prevs, cols, con, w, cap = _flora_segments(11)
    tx, tp = [_t(x) for x in xs], [_t(p) for p in prevs]
    with pytest.raises(ValueError, match="cap is"):
        flora_stack_group(tx, [con] * 4, tp, cap=4, cols=cols)
    with pytest.raises(ValueError, match="contributor"):
        flora_stack_group(tx, [((-1, 3),)] * 4, None, cap=cap, cols=cols)
    with pytest.raises(ValueError, match="contributor"):
        flora_stack_group(tx, [((0, 9),)] * 4, tp, cap=cap, cols=cols)
    with pytest.raises(ValueError, match="'mass'"):
        flora_stack_group(tx, [con] * 4, tp, cap=cap, cols=cols,
                          scales=["mass"] * 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flora_stack_group(tx, [con] * 4, tp, cap=cap, cols=cols,
                          backend="kernel")


# ------------------------------------------------------------- strategies --
def _cohort(seed, n=6, dtype=None):
    adapters, ranks, w = hetero_cohort(n=n, seed=seed, r_lo=0,
                                       r_hi=R_MAX - 2)
    prev = hetero_cohort(n=1, seed=seed + 100, r_lo=R_MAX, r_hi=R_MAX)[0][0]
    if dtype is not None:
        cast = lambda a: jax.tree.map(                        # noqa: E731
            lambda x: x.astype(dtype) if x.dtype == jnp.float32 else x, a)
        adapters, prev = [cast(a) for a in adapters], cast(prev)
    return adapters, ranks, w, prev


def _product(tree):
    return {k: np32(p["B"]).astype(np.float64) @ np32(p["A"]) for k, p in
            tree.items()}


@pytest.mark.parametrize("given_ranks", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", PER_PAIR)
def test_per_pair_round_matches_jax_aggregate_tree_pallas(
        monkeypatch, name, dtype, given_ranks):
    """Every per-pair strategy's ``aggregate_tree_kernel`` (one grouped call
    a round, run on the plain twins) against JAX's ``aggregate_tree_pallas``
    (interpret mode) with prev, rank-0 clients and rank rows no client
    owns; client ranks given, or read from each pair."""
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    adapters, ranks, w, prev = _cohort(12, dtype=jdt)
    opts = dict(stack_r_cap=64) if name == "flora" else {}
    jstr = js.get_strategy(name).with_options(**opts)
    jargs = (js.stack_trees(adapters), w, ranks if given_ranks else None,
             prev)
    _plain(monkeypatch)
    tstr = ts.get_strategy(name).with_options(**opts)
    targs = (ts.stack_trees([port_tree(a) for a in adapters]), _t(w),
             _t(ranks) if given_ranks else None, port_tree(prev))
    if name == "rbla_ranked" and not given_ranks:   # no ranks to reweight by
        with pytest.raises(ValueError, match="needs client_ranks"):
            jstr.aggregate_tree_pallas(*jargs, r_max=R_MAX, interpret=True)
        with pytest.raises(ValueError, match="needs client_ranks"):
            tstr.aggregate_tree_kernel(*targs, r_max=R_MAX)
        return
    want = jstr.aggregate_tree_pallas(*jargs, r_max=R_MAX, interpret=True)
    runtime.reset_counts()
    got = tstr.aggregate_tree_kernel(*targs, r_max=R_MAX)
    kernel = {"flora": "flora_stack", "rbla_norm": "packed_agg"}.get(
        name, "packed_robust" if name.startswith("rbla_") and name not in MEAN
        else "rbla_agg")
    calls = runtime.PLAIN_CALLS[kernel]
    assert calls == (len(SPECS) if kernel in ("packed_agg", "packed_robust")
                     else 1), runtime.PLAIN_CALLS
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    if name == "flora":
        for k in SPECS:
            assert int(got[k]["rank"]) == int(want[k]["rank"])
            assert got[k]["A"].dtype == port_tree(prev)[k]["A"].dtype
            assert_close(_product(got)[k], _product(want)[k], tol, k)
        return
    for k in SPECS:
        for side in ("A", "B"):
            assert got[k][side].dtype == port_tree(prev)[k][side].dtype
    assert_trees_close({k: {s: p[s] for s in "AB"} for k, p in got.items()},
                       {k: {s: np.asarray(p[s], np.float32) for s in "AB"}
                        for k, p in want.items()}, tol, msg=name)


@pytest.mark.parametrize("name", MEAN)
def test_per_pair_round_zero_weight_top_rank_client(monkeypatch, name):
    """A client of weight 0 alone at the top ranks: JAX's per-pair rows
    there are 0, not prev, and so are the port's."""
    adapters, ranks, w, prev = _cohort(13, n=3)
    ranks = jnp.asarray([2, 4, R_MAX], jnp.int32)
    w = jnp.asarray([1.0, 1.5, 0.0], jnp.float32)
    want = js.get_strategy(name).aggregate_tree_pallas(
        js.stack_trees(adapters), w, ranks, prev, r_max=R_MAX,
        interpret=True)
    _plain(monkeypatch)
    got = ts.get_strategy(name).aggregate_tree_kernel(
        ts.stack_trees([port_tree(a) for a in adapters]), _t(w), _t(ranks),
        port_tree(prev), r_max=R_MAX)
    for k in SPECS:
        assert_close(got[k]["A"], want[k]["A"], msg=k)
        assert_close(got[k]["B"], want[k]["B"], msg=k)
    if name != "fedavg":        # fedavg masks nothing: every row a mean
        assert bool((got["fc1"]["A"][4:] == 0).all())
        assert bool((got["fc1"]["B"][:, 4:] == 0).all())


@pytest.mark.parametrize("with_prev", [False, True])
def test_flora_rank_zero_cohort_raises_where_the_reference_raises(
        monkeypatch, with_prev):
    """A flora cohort of rank-0 clients: without a prev the reference raises
    (an empty stack), and so does the port, rather than return zeros; with
    a prev both stack the prev alone."""
    adapters, _, w, prev = _cohort(14, n=3)
    ranks = jnp.zeros(3, jnp.int32)
    jstr = js.get_strategy("flora").with_options(stack_r_cap=64)
    tstr = ts.get_strategy("flora").with_options(stack_r_cap=64)
    _plain(monkeypatch)
    jargs = (js.stack_trees(adapters), w, ranks, prev if with_prev else None)
    targs = (ts.stack_trees([port_tree(a) for a in adapters]), _t(w),
             _t(ranks), port_tree(prev) if with_prev else None)
    if not with_prev:
        with pytest.raises(ValueError):
            jstr.aggregate_tree_pallas(*jargs, r_max=R_MAX, interpret=True)
        with pytest.raises(ValueError, match="empty cohort"):
            tstr.aggregate_tree_kernel(*targs, r_max=R_MAX)
        return
    want = jstr.aggregate_tree_pallas(*jargs, r_max=R_MAX, interpret=True)
    got = tstr.aggregate_tree_kernel(*targs, r_max=R_MAX)
    for k in SPECS:
        assert int(got[k]["rank"]) == int(want[k]["rank"]) == R_MAX
        assert_close(_product(got)[k], _product(want)[k], msg=k)


@pytest.mark.parametrize("name", MEAN)
def test_mean_per_pair_round_refuses_layer_stacked_pairs(monkeypatch, name):
    """The mean family's per-pair path takes scalar-rank pairs only, as
    before the grouped call; layer-stacked cohorts go through the plan."""
    adapters, ranks, w, _ = _cohort(16, n=3)
    stacked = {k: {s: torch.stack([v, v], 1) for s, v in p.items()}
               for k, p in ts.stack_trees(
                   [port_tree(a) for a in adapters]).items()}
    _plain(monkeypatch)
    # rbla_ranked cannot reweight without the client ranks (it raises)
    for given in (_t(ranks),) + ((None,) if name != "rbla_ranked" else ()):
        with pytest.raises(NotImplementedError, match="scalar-rank pairs"):
            ts.get_strategy(name).aggregate_tree_kernel(
                stacked, _t(w), given, None, r_max=R_MAX)


def test_flora_per_pair_round_is_one_call_with_over_cap_pairs(monkeypatch):
    """Pairs within the cap stack in one grouped call; a pair over it is
    re-projected by SVD and takes no segment."""
    adapters, ranks, w, prev = _cohort(15)
    rank_leaf = lambda r: jnp.asarray(r, jnp.int32)          # noqa: E731
    prev = {k: dict(p, rank=rank_leaf(R_MAX)) for k, p in prev.items()}
    calls = []
    fn = ts.flora_stack_group

    def spy(xs, *a, **k):
        calls.append(len(xs))
        return fn(xs, *a, **dict(k, backend="ref"))
    monkeypatch.setattr(ts, "flora_stack_group", spy)
    cap = R_MAX + int(np.sum(ranks))
    tstr = ts.get_strategy("flora").with_options(stack_r_cap=cap)
    got = tstr.aggregate_tree_kernel(
        ts.stack_trees([port_tree(a) for a in adapters]), _t(w), _t(ranks),
        port_tree(prev), r_max=R_MAX)
    assert calls == [2 * len(SPECS)]
    assert all(int(p["rank"]) == cap for p in got.values())
    calls.clear()
    small = ts.get_strategy("flora").with_options(stack_r_cap=cap - 1)
    small.aggregate_tree_kernel(
        ts.stack_trees([port_tree(a) for a in adapters]), _t(w), _t(ranks),
        port_tree(prev), r_max=R_MAX)
    assert calls == []
