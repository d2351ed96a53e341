"""The port's flora slice: ``flora_stack`` and ``packed_stack`` (plain
versions and the stack kernel's per-row table) against the JAX package,
the plan's segments through ``packed_stack_group``'s plain twin against
JAX's stacking oracle, ``FloraStrategy`` and its packed plan against the
JAX strategy within and over the cap (and against the per-pair round, bit
for bit), and three synchronous rounds against
``repro.fl.run_simulation``.

Stacking is copies and one fp32 multiply per element, so the plain
versions match the JAX oracles exactly; a round that re-projects by SVD is
compared in product space (``B @ A``), where the signs of singular vectors
cancel, within 2e-5 of max|want| (fp32 QR/SVD of two LAPACK builds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import SPECS, hetero_cohort
from _torch_parity import (assert_close, assert_trees_close, port_tree,
                           sim_reference_inputs, spy_states)

from repro.core import plan as jplan
from repro.core import strategy as js
from repro.fl import FLConfig as JConfig
from repro.fl import run_simulation as j_run
from repro.kernels.rbla_agg import ops as jops
from repro.kernels.rbla_agg import ref as jref
from repro_torch.core import plan as tplan
from repro_torch.core import strategy as ts
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import (flora_stack, flora_stack_group,
                                          packed_stack,
                                          packed_stack_group_ref,
                                          packed_stack_ref, stack_table)
from repro_torch.kernels.rbla_agg.ref import flora_mass_scales

R_MAX = 8


def _apply_table(rows, x, prev, scales):
    """What the stack kernel computes from its table, in numpy: output row
    i is ``scales[si] * source[src_row]`` or zero."""
    out = np.zeros((rows.shape[0], x.shape[-1]), np.float32)
    for i, (src, r, si) in enumerate(rows):
        if src == -2:
            continue
        row = prev[r] if src == -1 else x[src, r]
        out[i] = np.float32(scales[si]) * row.astype(np.float32)
    return out


# ------------------------------------------------------------ flora_stack --
@pytest.mark.parametrize("segs,out_rows", [((3, 0, 5), 10), ((6, 6, 6), 18),
                                            ((0, 1, 0), 4)])
def test_flora_stack_plain_matches_jax(segs, out_rows):
    rng = np.random.default_rng(sum(segs))
    x = rng.normal(size=(3, 6, 7)).astype(np.float32)
    sc = rng.uniform(0.2, 3.0, 3).astype(np.float32)
    got = flora_stack(torch.as_tensor(x), torch.as_tensor(sc), segs=segs,
                      out_rows=out_rows)
    want = jref.flora_stack_ref(jnp.asarray(x), jnp.asarray(sc), segs,
                                out_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kern = jops.flora_stack(jnp.asarray(x), jnp.asarray(sc), segs=segs,
                            out_rows=out_rows, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    grouped = flora_stack_group([torch.as_tensor(x)[:, None]],
                                [tuple(enumerate(segs))], cap=out_rows,
                                scales=[torch.as_tensor(sc)])[0]
    np.testing.assert_array_equal(grouped[0].numpy(), got.numpy())


def test_flora_stack_trailing_dims_and_bf16():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(2, 4, 3, 5)).astype(np.float32))
    got = flora_stack(x.bfloat16(), torch.tensor([1.0, 0.5]), segs=(2, 4),
                      out_rows=7)
    assert got.shape == (7, 3, 5) and got.dtype == torch.bfloat16
    want = jref.flora_stack_ref(
        jnp.asarray(x.numpy().reshape(2, 4, 15), jnp.bfloat16),
        jnp.asarray([1.0, 0.5]), (2, 4), 7)
    assert_close(got.reshape(7, 15), want, tol=0.0)


def test_flora_stack_validation():
    x = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="segments for 2"):
        flora_stack(x, torch.ones(2), segs=(1,), out_rows=4)
    with pytest.raises(ValueError, match="outside"):
        flora_stack(x, torch.ones(2), segs=(5, 0), out_rows=8)
    with pytest.raises(ValueError, match="exceed out_rows"):
        flora_stack(x, torch.ones(2), segs=(3, 3), out_rows=5)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flora_stack(x, torch.ones(2), segs=(1, 1), out_rows=4,
                    backend="kernel")
    runtime.reset_counts()
    flora_stack(x, torch.ones(2), segs=(1, 1), out_rows=4)
    assert runtime.PLAIN_CALLS["flora_stack"] == 1



@pytest.mark.parametrize("layers", [1, 3])
def test_flora_stack_layers_match_jax_per_layer(layers):
    """A layer-stacked pair in one call: every layer stacked on its own,
    exactly as the JAX oracle stacks that layer; the kernel's table (one
    block per layer) reproduces it."""
    rng = np.random.default_rng(10 + layers)
    segs, r, out_rows = (3, 0, 5, 2), 6, 12
    x = rng.normal(size=(4, layers * r, 7)).astype(np.float32)
    sc = rng.uniform(0.2, 3.0, 4).astype(np.float32)
    runtime.reset_counts()
    got = flora_stack(torch.as_tensor(x), torch.as_tensor(sc), segs=segs,
                      out_rows=out_rows, layers=layers).numpy()
    assert runtime.PLAIN_CALLS["flora_stack"] == 1
    assert got.shape == (layers * out_rows, 7)
    for layer in range(layers):
        want = jref.flora_stack_ref(
            jnp.asarray(x[:, layer * r:(layer + 1) * r]), jnp.asarray(sc),
            segs, out_rows)
        np.testing.assert_array_equal(
            got[layer * out_rows:(layer + 1) * out_rows], np.asarray(want))
    grouped = flora_stack_group(
        [torch.as_tensor(x).reshape(4, layers, r, 7)],
        [tuple(enumerate(segs))], cap=out_rows,
        scales=[torch.as_tensor(sc)])[0]
    np.testing.assert_array_equal(grouped.reshape(-1, 7).numpy(), got)
    with pytest.raises(ValueError, match="do not split"):
        flora_stack(torch.as_tensor(x), torch.as_tensor(sc), segs=segs,
                    out_rows=out_rows, layers=layers + 4)

# ----------------------------------------------------------- packed_stack --
COPIES_X = ((0, 1, 0, 2, 1), (2, 0, 4, 3, 2), (1, 2, 5, 2, 0))
COPIES_PREV = ((0, 8, 2, 1), (1, 3, 2, 2))      # overlaps an x copy at 3-5


def test_packed_stack_plain_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 6, 7)).astype(np.float32)
    prev = rng.normal(size=(4, 7)).astype(np.float32)
    sc = np.array([0.5, 2.0, 3.0], np.float32)
    kw = dict(copies_x=COPIES_X, copies_prev=COPIES_PREV, out_rows=11)
    got = packed_stack(torch.as_tensor(x), torch.as_tensor(sc),
                       torch.as_tensor(prev), **kw).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(sc), jnp.asarray(prev))
    np.testing.assert_array_equal(got, np.asarray(
        jref.packed_stack_ref(*jargs, **kw)))
    np.testing.assert_array_equal(got, np.asarray(
        jops.packed_stack(*jargs, interpret=True, **kw)))
    table = stack_table(COPIES_X, COPIES_PREV, out_rows=11, n=3, r_in=6,
                        r_prev=4, n_scales=3)
    np.testing.assert_array_equal(_apply_table(table.rows, x, prev, sc), got)


@pytest.mark.parametrize("copy,match", [
    ((3, 0, 0, 1, 0), "bad copy"), ((0, 5, 0, 2, 0), "bad copy"),
    ((0, 0, 10, 2, 0), "bad copy"), ((0, 0, 0, 1, 3), "bad copy")])
def test_packed_stack_refuses_bad_copies(copy, match):
    x = torch.zeros(3, 6, 7)
    with pytest.raises(ValueError, match=match):
        packed_stack(x, torch.ones(3), copies_x=(copy,), out_rows=11)


def test_packed_stack_refuses_bad_prev_copies():
    x = torch.zeros(3, 6, 7)
    with pytest.raises(ValueError, match="no prev buffer"):
        packed_stack(x, torch.ones(3), copies_prev=((0, 0, 1, 0),),
                     out_rows=4)
    with pytest.raises(ValueError, match="bad prev copy"):
        packed_stack(x, torch.ones(3), torch.zeros(2, 7),
                     copies_prev=((1, 0, 2, 0),), out_rows=4)
    table = stack_table(out_rows=4, n=3, r_in=6, n_scales=3)
    with pytest.raises(ValueError, match="another geometry"):
        packed_stack(x, torch.ones(3), out_rows=5, table=table)


# ------------------------------------------------------------- strategies --
@functools.cache
def _cohort(seed, prev_rank):
    """Five clients at storage R_MAX; a previous global at storage 4 *
    R_MAX with live rank ``prev_rank`` (0: no previous global)."""
    adapters, ranks, weights = hetero_cohort(n=5, seed=seed, r_hi=R_MAX)
    prev = None
    if prev_rank:
        rng = np.random.default_rng(seed + 7)
        prev = {}
        for k, (fo, fi) in SPECS.items():
            A = np.zeros((4 * R_MAX, fi), np.float32)
            B = np.zeros((fo, 4 * R_MAX), np.float32)
            A[:prev_rank] = rng.normal(size=(prev_rank, fi))
            B[:, :prev_rank] = rng.normal(size=(fo, prev_rank))
            prev[k] = {"A": A, "B": B, "rank": np.int32(prev_rank)}
    return adapters, ranks, weights, prev


def _products(tree):
    """Each pair's live product ``B[:, :r] @ A[:r]`` and its rank."""
    out = {}
    for k, p in tree.items():
        A, B = np.asarray(p["A"], np.float32), np.asarray(p["B"], np.float32)
        r = int(np.asarray(p["rank"]))
        out[k] = (B[:, :r] @ A[:r], r)
    return out


def _run_both(cap, prev_rank, seed=0, use_plan=True):
    adapters, ranks, weights, prev = _cohort(seed, prev_rank)
    jprev = None if prev is None else jax.tree.map(jnp.asarray, prev)
    want = js.get_strategy("flora").with_options(
        stack_r_cap=cap).aggregate_adapters(
            adapters, weights, r_max=R_MAX, client_ranks=ranks,
            prev_global=jprev, backend="ref")
    got = ts.get_strategy("flora").with_options(
        stack_r_cap=cap).aggregate_adapters(
            [port_tree(a) for a in adapters],
            torch.as_tensor(np.array(weights)), r_max=R_MAX,
            client_ranks=torch.as_tensor(np.array(ranks)),
            prev_global=None if prev is None else port_tree(prev),
            backend="ref", use_plan=use_plan)
    return got, want, int(np.sum(ranks)) + prev_rank


@pytest.mark.parametrize("use_plan", [True, False])
@pytest.mark.parametrize("prev_rank", [0, 5])
def test_flora_within_the_cap_matches_reference(prev_rank, use_plan):
    """Within the cap the stacked factors themselves agree: one fp32
    multiply per element on both sides."""
    got, want, total = _run_both(4 * R_MAX, prev_rank, use_plan=use_plan)
    assert total <= 4 * R_MAX
    assert_trees_close(got, want, msg=f"prev={prev_rank} plan={use_plan}")
    assert all(int(p["rank"]) == total for p in got.values())


@pytest.mark.parametrize("use_plan", [True, False])
@pytest.mark.parametrize("prev_rank", [0, 5])
def test_flora_over_the_cap_matches_reference_in_product_space(prev_rank,
                                                               use_plan):
    got, want, total = _run_both(2 * R_MAX, prev_rank, use_plan=use_plan)
    assert total > 2 * R_MAX
    g, w = _products(got), _products(want)
    for k in w:
        assert g[k][1] == w[k][1] == R_MAX
        assert_close(g[k][0], w[k][0], msg=k)
        assert got[k]["A"].shape == (2 * R_MAX, SPECS[k][1])


def _port_launches(jround) -> int:
    """The port's launches for a round the JAX plan makes in one launch
    per (width, dtype) bucket plus one per re-projected pair: one grouped
    stack launch if any pair stacks, plus the same re-projections."""
    stacks = jround.n_kernel_launches > jround.n_fallback_pairs
    return int(stacks) + jround.n_fallback_pairs


@pytest.mark.parametrize("cap,prev_rank", [(4 * R_MAX, 5), (2 * R_MAX, 5),
                                           (4 * R_MAX, 0)])
def test_flora_plan_counts_match_reference(cap, prev_rank):
    adapters, ranks, weights, prev = _cohort(0, prev_rank)
    jspec = jplan.build_cohort_spec(
        js.stack_trees(adapters), kind="ref", r_max=R_MAX,
        client_ranks=ranks,
        prev_tree=None if prev is None else jax.tree.map(jnp.asarray, prev))
    jround = js.get_strategy("flora").with_options(stack_r_cap=cap).plan(
        None, jspec)
    tround = ts.get_strategy("flora").with_options(stack_r_cap=cap).plan(
        None, tplan.build_cohort_spec(
            ts.stack_trees([port_tree(a) for a in adapters]), kind="ref",
            r_max=R_MAX, client_ranks=torch.as_tensor(np.array(ranks)),
            prev_tree=None if prev is None else port_tree(prev)))
    assert tround.kind == jround.kind == "packed"
    assert tround.n_fallback_pairs == jround.n_fallback_pairs
    assert tround.n_kernel_launches == _port_launches(jround)



def _layered_cohort(seed, n=4, layers=3, prev_rank=0):
    """``n`` clients with layer-stacked pairs (A (L, R_MAX, in), B (L, out,
    R_MAX), one rank per client uniform over the L layers) as JAX trees,
    and a layer-stacked previous global at storage 4 R_MAX."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, R_MAX + 1, n)

    def pair(fo, fi, storage, rank):
        A = np.zeros((layers, storage, fi), np.float32)
        B = np.zeros((layers, fo, storage), np.float32)
        A[:, :rank] = rng.normal(size=(layers, rank, fi))
        B[:, :, :rank] = rng.normal(size=(layers, fo, rank))
        return {"A": jnp.asarray(A), "B": jnp.asarray(B),
                "rank": jnp.full((layers,), rank, jnp.int32)}
    adapters = [{k: pair(fo, fi, R_MAX, int(r)) for k, (fo, fi) in
                 SPECS.items()} for r in ranks]
    prev = ({k: pair(fo, fi, 4 * R_MAX, prev_rank) for k, (fo, fi) in
             SPECS.items()} if prev_rank else None)
    weights = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    return adapters, jnp.asarray(ranks, jnp.int32), weights, prev


@pytest.mark.parametrize("cap,prev_rank", [(4 * R_MAX, 0), (4 * R_MAX, 5),
                                           (R_MAX, 5)])
def test_per_pair_path_stacks_layer_stacked_pairs(monkeypatch, cap,
                                                  prev_rank):
    """``aggregate_tree_kernel`` on a layer-stacked cohort: within the cap
    one ``flora_stack_group`` call takes every pair side and stacks each
    layer on its own (run here on the plain version, which the
    wrapper takes for CPU tensors); over the cap the pair is re-projected.
    Within the cap the factors match the JAX strategy to fp32 tolerance
    (one multiply per element on both sides); over it, in product space."""
    adapters, ranks, weights, prev = _layered_cohort(2, prev_rank=prev_rank)
    want = js.get_strategy("flora").with_options(
        stack_r_cap=cap).aggregate_adapters(
            adapters, weights, r_max=R_MAX, client_ranks=ranks,
            prev_global=prev, backend="ref")
    calls = []

    def plain_stack(xs, *a, **k):
        calls.append([x.shape[1] for x in xs])
        return flora_stack_group(xs, *a, **dict(k, backend="ref"))
    monkeypatch.setattr(ts, "flora_stack_group", plain_stack)
    got = ts.get_strategy("flora").with_options(
        stack_r_cap=cap).aggregate_tree_kernel(
            ts.stack_trees([port_tree(a) for a in adapters]),
            torch.as_tensor(np.array(weights)),
            torch.as_tensor(np.array(ranks)),
            None if prev is None else port_tree(prev), r_max=R_MAX)
    total = int(np.sum(ranks)) + prev_rank
    if total <= cap:
        assert calls == [[3] * 2 * len(SPECS)]
        assert_trees_close(got, want, msg=f"cap={cap} prev={prev_rank}")
        return
    assert calls == []
    for k in SPECS:
        assert got[k]["A"].shape == want[k]["A"].shape
        np.testing.assert_array_equal(got[k]["rank"].numpy(),
                                      np.asarray(want[k]["rank"]))
        for layer in range(3):
            assert_close(got[k]["B"][layer].double() @ got[k]["A"][layer].double(),
                         np.asarray(want[k]["B"][layer], np.float64)
                         @ np.asarray(want[k]["A"][layer], np.float64),
                         msg=f"{k}/{layer}")

def _segment_copies(plan, i):
    """Segment i of a stack plan as ``packed_stack``'s copy lists over its
    rank-row view: the cohort leaf as (n, layers * r_in, width), prev as
    (layers * r_prev, width), the output (layers * cap, width); scale 0 is
    1 (A rows), scale 1 + k contributor k's."""
    shape, col, cap = plan.shapes[i], plan.cols[i], plan.caps[i]
    layers = int(np.prod(shape[1:-2], dtype=np.int64))
    r_in = shape[-1] if col else shape[-2]
    pshape = plan.prev_shapes[i]
    r_prev = 0 if pshape is None else (pshape[-1] if col else pshape[-2])
    copies_x, copies_prev = [], []
    for layer in range(layers):
        off = layer * cap
        for k, (src, rows) in enumerate(plan.contribs[i]):
            si = 1 + k if plan.scales[i] == "mass" else 0
            if src < 0:
                copies_prev.append((layer * r_prev, off, rows, si))
            else:
                copies_x.append((src, layer * r_in, off, rows, si))
            off += rows
    return copies_x, copies_prev, layers * cap, r_in * layers, r_prev * layers


def _rows(a, col, lead_dims):
    """A leaf's rank-row view, its layers one after another: (..., rows,
    width), B transposed."""
    a = np.swapaxes(a, -1, -2) if col else a
    return a.reshape(a.shape[:lead_dims] + (-1, a.shape[-1]))


def test_flora_plan_tables_reproduce_the_plain_stack():
    """A real plan's segments: ``packed_stack_group``'s plain twin on each
    cohort leaf and prev where they lie equals the JAX stacking oracle
    (``packed_stack_ref``) on the same rows placed by the segment's copy
    lists, with the same fp32 scales; the kernel's per-row table of those
    copy lists reproduces it."""
    adapters, ranks, weights, prev = _cohort(1, 5)
    tround = ts.get_strategy("flora").with_options(stack_r_cap=4 * R_MAX).plan(
        None, tplan.build_cohort_spec(
            ts.stack_trees([port_tree(a) for a in adapters]), kind="ref",
            r_max=R_MAX, client_ranks=torch.as_tensor(np.array(ranks)),
            prev_tree=port_tree(prev)))
    plan = tround.stack_plan
    assert tround.n_kernel_launches == 1 and not tround.n_fallback_pairs
    assert len(plan.shapes) == 2 * len(SPECS)
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=s).astype(np.float32) for s in plan.shapes]
    prevs = [rng.normal(size=s).astype(np.float32) for s in plan.prev_shapes]
    w = rng.uniform(0.5, 2.0, plan.n).astype(np.float32)
    runtime.reset_counts()
    got = packed_stack_group_ref(plan, [torch.as_tensor(x) for x in xs],
                                 [torch.as_tensor(p) for p in prevs],
                                 torch.as_tensor(w))
    assert runtime.PLAIN_CALLS["packed_stack"] == 1
    for i, (x, p, g) in enumerate(zip(xs, prevs, got)):
        col = plan.cols[i]
        copies_x, copies_prev, out_rows, r_in, r_prev = _segment_copies(
            plan, i)
        mass = flora_mass_scales(torch.as_tensor(w), plan.contribs[i],
                                 plan.prev_weight, plan.eps)
        sc = np.asarray([1.0] + [float(v) for v in mass], np.float32)
        xr, pr = _rows(x, col, 1), _rows(p, col, 0)
        kw = dict(copies_x=tuple(copies_x), copies_prev=tuple(copies_prev),
                  out_rows=out_rows)
        want = np.asarray(jref.packed_stack_ref(
            jnp.asarray(xr), jnp.asarray(sc), jnp.asarray(pr), **kw))
        np.testing.assert_array_equal(_rows(g.numpy(), col, 0), want)
        np.testing.assert_array_equal(want, packed_stack_ref(
            torch.as_tensor(xr), torch.as_tensor(sc), torch.as_tensor(pr),
            **kw).numpy())
        table = stack_table(copies_x, copies_prev, out_rows=out_rows,
                            n=plan.n, r_in=r_in, r_prev=r_prev,
                            n_scales=len(sc))
        np.testing.assert_array_equal(_apply_table(table.rows, xr, pr, sc),
                                      want)


def _planned_and_per_pair(monkeypatch, adapters, weights, prev, cap):
    """One flora round through the port's plan (``ref`` backend: the plain
    twin) and through the per-pair round (``aggregate_tree_kernel``, its
    grouped call on the plain twin) on the same torch inputs."""
    stacked = ts.stack_trees([port_tree(a) for a in adapters])
    tprev = port_tree(prev)
    w = torch.as_tensor(np.asarray(weights, np.float32))
    strat = ts.get_strategy("flora").with_options(stack_r_cap=cap)
    round_ = strat.plan(None, tplan.build_cohort_spec(
        stacked, kind="ref", r_max=R_MAX, prev_tree=tprev))
    assert round_.kind == "packed" and round_.n_kernel_launches == 1
    runtime.reset_counts()
    planned = round_(stacked, w, tprev)
    assert runtime.PLAIN_CALLS["packed_stack"] == 1
    monkeypatch.setattr(ts, "flora_stack_group", lambda *a, **k: (
        flora_stack_group(*a, **dict(k, backend="ref"))))
    per_pair = strat.aggregate_tree_kernel(stacked, w, None, tprev,
                                           r_max=R_MAX)
    return planned, per_pair


@pytest.mark.parametrize("case", ["prev, one weight 0", "layer-stacked",
                                  "bf16"])
def test_planned_flora_round_is_the_per_pair_round_bit_for_bit(monkeypatch,
                                                               case):
    """The planned round (one ``packed_stack_group`` call) and the per-pair
    round (one ``flora_stack_group`` call) stack the same contributors
    with the same in-order fp32 scales: the same bits, ranks and dtypes,
    with a prev, a client of weight 0, a layer-stacked pair of uniform
    ranks and a bf16 cohort."""
    if case == "layer-stacked":
        adapters, _, weights, prev = _layered_cohort(4, prev_rank=5)
    else:
        adapters, _, weights, prev = _cohort(2, 5)
    weights = np.array(weights, np.float32)
    weights[1] = 0.0
    if case == "bf16":
        cast = lambda t: jax.tree.map(                         # noqa: E731
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32
            else x, t)
        adapters, prev = [cast(a) for a in adapters], cast(prev)
    planned, per_pair = _planned_and_per_pair(monkeypatch, adapters,
                                              weights, prev, 4 * R_MAX)
    for k in SPECS:
        for side in ("A", "B", "rank"):
            g, w = planned[k][side], per_pair[k][side]
            assert g.dtype == w.dtype and g.shape == w.shape, (k, side)
            assert torch.equal(g, w), (case, k, side)
    if case == "bf16":
        assert planned["fc1"]["A"].dtype == torch.bfloat16


def test_default_cap_never_stacks_the_quickstart_cohort():
    """At the default cap (2 r_max = 128) the quickstart cohort (ranks
    6..64, sum 352) plus a global at live rank 64 over-runs every round,
    so every pair re-projects and no stacking launch happens; at cap 512
    the first round stacks, and a global at live rank 416 over-runs it."""
    ranks = np.array([6, 13, 19, 26, 32, 38, 45, 51, 58, 64])
    specs = {"fc1": (6, 9), "fc2": (4, 6)}
    rng = np.random.default_rng(0)
    clients = [{k: {"A": rng.normal(size=(64, fi)).astype(np.float32),
                    "B": rng.normal(size=(fo, 64)).astype(np.float32),
                    "rank": np.int32(r)} for k, (fo, fi) in specs.items()}
               for r in ranks]

    def counts(cap, prev_rank):
        storage = cap if cap is not None else 128
        prev = {k: {"A": np.zeros((storage, fi), np.float32),
                    "B": np.zeros((fo, storage), np.float32),
                    "rank": np.int32(prev_rank)}
                for k, (fo, fi) in specs.items()}
        jround = js.get_strategy("flora").with_options(stack_r_cap=cap).plan(
            None, jplan.build_cohort_spec(
                js.stack_trees(jax.tree.map(jnp.asarray, clients)),
                kind="ref", r_max=64, prev_tree=jax.tree.map(jnp.asarray,
                                                             prev)))
        tround = ts.get_strategy("flora").with_options(stack_r_cap=cap).plan(
            None, tplan.build_cohort_spec(
                ts.stack_trees([port_tree(c) for c in clients]), kind="ref",
                r_max=64, prev_tree=port_tree(prev)))
        got = (tround.n_kernel_launches, tround.n_fallback_pairs)
        assert tround.n_kernel_launches == _port_launches(jround)
        assert tround.n_fallback_pairs == jround.n_fallback_pairs
        return got
    assert counts(None, 64) == (2, 2)
    assert counts(512, 64) == (1, 0)     # 64 + 352 = 416 <= 512: stacks
    assert counts(512, 416) == (2, 2)    # 416 + 352 = 768 > 512


def test_flora_rank_plumbing():
    flora = ts.get_strategy("flora")
    assert flora.server_storage_rank(64) == 128
    assert flora.with_options(stack_r_cap=512).server_storage_rank(64) == 512
    with pytest.raises(ValueError, match="r_max=64"):
        flora.with_options(stack_r_cap=32).server_storage_rank(64)
    assert "stack_r_cap" not in vars(flora)           # the singleton stays
    with pytest.raises(ValueError, match="no option"):
        run_simulation(FLConfig(method="rbla", stack_r_cap=16, rounds=1),
                       device="cpu")


# ------------------------------------------------------------- simulation --
CFG = dict(dataset="mnist", model="mlp", rounds=3, n_clients=4,
           n_per_class=20, n_test_per_class=10, local_epochs=1,
           batch_size=16, lr=0.01, r_max=8, seed=42)
#: client ranks 1, 2, 2, 8 (sum 13) and a global entering at live rank 8:
#: round 1 stacks 21 <= 24 rows, round 2 has 21 + 13 = 34 > 24 and
#: re-projects to 8 by SVD, round 3 stacks 21 again
CAP = 24


def test_three_rounds_alternate_and_match_reference(monkeypatch):
    """Per-round accuracy within one test example (0.01 of 100) in the
    re-projection round 2 and in round 3, which starts from it (two
    LAPACK builds' SVDs); identical in round 1, which only stacks."""
    jcfg = JConfig(method="flora", stack_r_cap=CAP, **CFG)
    params, adapters, idx = sim_reference_inputs(jcfg, r_storage=CAP)
    jseen = spy_states(monkeypatch, js.AggregationStrategy)
    jhist = j_run(jcfg)
    tseen = spy_states(monkeypatch, ts.AggregationStrategy)
    thist = run_simulation(
        FLConfig(method="flora", stack_r_cap=CAP, **CFG), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda rnd, ci: torch.as_tensor(idx[rnd, ci]))
    live = [[int(p["rank"]) for p in s.adapters.values()] for s in tseen]
    assert live == [[21] * 3, [8] * 3, [21] * 3]
    assert [[int(p["rank"]) for p in s.adapters.values()]
            for s in jseen] == live
    assert thist.test_acc[0] == jhist.test_acc[0]
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    for got, want in zip(tseen, jseen):
        g, w = _products(got.adapters), _products(want.adapters)
        for k in w:
            assert_close(g[k][0], w[k][0], tol=1e-3, msg=k)
