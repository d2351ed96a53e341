"""The grouped aggregation calls (``packed_agg_group``, ``packed_robust_group``
in ``repro_torch.kernels.rbla_agg``) on the CPU: their plain twins against
the per-bucket plain versions on the packed layout and against the JAX
package's Pallas kernels (interpreted, as ``tests/test_torch_rbla_agg.py``
and ``tests/test_torch_robust.py`` run them), and every mean-family and
robust strategy's planned round (one plain call) against the JAX
package's aggregate.

Inputs are made with numpy from a seed.  Tolerances follow
``tests/test_kernels.py``: 2e-5 in fp32 and 2e-2 in bf16, relative, and
absolute at that times max(1, max|want|) (``_torch_parity.assert_close``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _cohorts import R_MAX, hetero_cohort
from _torch_parity import (BF16_TOL, F32_TOL, assert_close,
                           assert_trees_close, group_cohort,
                           group_to_buckets, np32, port_tree)

from repro.core import codec as jcodec
from repro.core import strategy as js
from repro.kernels.rbla_agg import kernel as jkernel
from repro_torch.core import codec as tcodec
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import (packed_agg_group,
                                          packed_agg_group_ref, packed_agg_ref,
                                          packed_robust_group,
                                          packed_robust_ref)
from repro_torch.kernels.rbla_agg.ref import leaf_from_rank_rows

MEAN = [("mask", False), ("weight", False), ("mask", True)]
MODES = ["clipped", "trimmed", "median"]
KNOBS = dict(clip_norm=2.5, trim_frac=0.2)
MEAN_FAMILY = ["fedavg", "zeropad", "rbla", "rbla_ranked", "rbla_norm"]
ROBUST = ["rbla_clipped", "rbla_trimmed", "rbla_median"]


def _tol(kw):
    return BF16_TOL if kw["out_dtypes"][0] == torch.bfloat16 else F32_TOL


def _per_bucket(kw, plain):
    """Each segment's result from ``plain`` run once per packed bucket."""
    outs = [None] * len(kw["xs"])
    for x, m, prev, sc, where in group_to_buckets(kw):
        got = plain(x, m, kw["weights"], prev, sc)
        for i, start, rows in where:
            shape = (tuple(kw["xs"][i].shape[1:])
                     if isinstance(kw["xs"][i], torch.Tensor)
                     else tuple(kw["xs"][i][0].shape))
            outs[i] = leaf_from_rank_rows(got[start:start + rows], shape,
                                          kw["cols"][i])
    return outs


def _jax(t):
    if t is None:
        return None
    return jnp.asarray(np32(t))


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("norm_by,norm_restore", MEAN)
def test_agg_group_plain_matches_per_bucket_plain(norm_by, norm_restore,
                                                   dtype, with_prev, lead):
    """Stacked segments, with and without prev, layer-stacked with
    per-layer ranks: each equals the per-bucket plain version."""
    kw = group_cohort(1, dtype=dtype, lead=lead, with_prev=with_prev)
    runtime.reset_counts()
    got = packed_agg_group(**kw, norm_by=norm_by, norm_restore=norm_restore)
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    want = _per_bucket(kw, lambda x, m, w, p, s: packed_agg_ref(
        x, m, w, p, norm_by=norm_by, norm_restore=norm_restore, scales=s,
        out_dtype=kw["out_dtypes"][0]))
    for g, w, x in zip(got, want, kw["xs"]):
        assert g.shape == x.shape[1:] and g.dtype == kw["out_dtypes"][0]
        assert_close(g, w, _tol(kw))


@pytest.mark.parametrize("dtype", ["f32", "int8", "mixed"])
@pytest.mark.parametrize("norm_by,norm_restore", MEAN)
def test_agg_group_per_client_leaves(norm_by, norm_restore, dtype):
    """Per-client leaves in their wire dtypes (an encoded cohort, mixed
    codecs included): one plain call, equal to the dequantised buckets."""
    kw = group_cohort(2, n=6, dtype=dtype, per_client=True)
    runtime.reset_counts()
    got = packed_agg_group(**kw, norm_by=norm_by, norm_restore=norm_restore)
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    want = _per_bucket(kw, lambda x, m, w, p, s: packed_agg_ref(
        x, m, w, p, norm_by=norm_by, norm_restore=norm_restore, scales=s,
        out_dtype=torch.float32))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("norm_by,norm_restore", MEAN)
def test_agg_group_plain_matches_jax_kernel(norm_by, norm_restore,
                                            use_mask):
    """Against the Pallas kernel itself, interpreted, bucket by bucket:
    rank-0 clients, rows no one owns, ``use_mask=False``."""
    kw = group_cohort(3, use_mask=use_mask)
    got = packed_agg_group(**kw, norm_by=norm_by, norm_restore=norm_restore)
    want = _per_bucket(kw, lambda x, m, w, p, s: torch.as_tensor(np.array(
        jkernel.packed_agg_pallas(_jax(x), _jax(m), _jax(w), _jax(p),
                                  norm_by=norm_by, norm_restore=norm_restore,
                                  interpret=True))))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_agg_group_shares_mask_columns_and_keeps_prev():
    """Two segments may read the same mask columns (a pair's A and B);
    rank rows no client owns keep prev exactly."""
    kw = group_cohort(4, fans=(6,))
    kw["mask_offs"] = [0, 0]
    got = packed_agg_group(**kw)
    r = kw["xs"][0].shape[-2]
    unowned = (kw["masks"][:, :r].sum(0) == 0).nonzero().flatten()
    assert len(unowned) >= 2
    assert torch.equal(got[0][unowned], kw["prevs"][0][unowned])
    assert torch.equal(got[1][:, unowned], kw["prevs"][1][:, unowned])


def test_agg_group_counts_one_call_per_client_dtype_set():
    kw = group_cohort(5)
    bf = group_cohort(5, dtype="bf16")
    runtime.reset_counts()
    packed_agg_group(kw["xs"] + bf["xs"],
                     torch.cat([kw["masks"], bf["masks"]], 1), kw["weights"],
                     kw["prevs"] + bf["prevs"],
                     cols=kw["cols"] + bf["cols"])
    assert runtime.PLAIN_CALLS["packed_agg"] == 2
    assert runtime.LAUNCHES["packed_agg"] == 0


def test_agg_group_validation():
    kw = group_cohort(6)
    with pytest.raises(ValueError, match="exceed the masks"):
        packed_agg_group(kw["xs"], kw["masks"][:, :3], kw["weights"])
    with pytest.raises(ValueError, match="prev"):
        packed_agg_group(kw["xs"][:1], kw["masks"], kw["weights"],
                         [kw["prevs"][1]])
    with pytest.raises(ValueError, match="scales"):
        packed_agg_group(kw["xs"][:1], kw["masks"], kw["weights"],
                         scales=[torch.ones(5, 3)])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        packed_agg_group(**kw, backend="kernel")


@pytest.mark.parametrize("n", [1, 3, 10, 70])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_robust_group_plain_matches_per_bucket_plain(mode, dtype, n):
    kw = group_cohort(7 + n, n=n, dtype=dtype, lead=(2,) if n == 3 else ())
    runtime.reset_counts()
    got = packed_robust_group(**kw, mode=mode, **KNOBS)
    assert runtime.PLAIN_CALLS["packed_robust"] == 1
    want = _per_bucket(kw, lambda x, m, w, p, s: packed_robust_ref(
        x, m, w, p, mode=mode, scales=s, out_dtype=kw["out_dtypes"][0],
        **KNOBS))
    for g, w in zip(got, want):
        assert_close(g, w, _tol(kw))


@pytest.mark.parametrize("mode", MODES)
def test_robust_group_per_client_mixed(mode):
    kw = group_cohort(8, n=6, dtype="mixed", per_client=True)
    got = packed_robust_group(**kw, mode=mode, **KNOBS)
    want = _per_bucket(kw, lambda x, m, w, p, s: packed_robust_ref(
        x, m, w, p, mode=mode, **KNOBS))
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("n", [3, 10])
@pytest.mark.parametrize("mode", MODES)
def test_robust_group_plain_matches_jax_kernel(mode, n):
    kw = group_cohort(9, n=n)
    got = packed_robust_group(**kw, mode=mode, **KNOBS)
    want = _per_bucket(kw, lambda x, m, w, p, s: torch.as_tensor(np.array(
        jkernel.packed_robust_pallas(_jax(x), _jax(m), _jax(w), _jax(p),
                                     mode=mode, interpret=True, **KNOBS))))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_group_twin_is_the_plain_version_of_the_group():
    kw = group_cohort(10)
    got = packed_agg_group(**kw)
    want = packed_agg_group_ref(**kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------ strategies --
def _cohort(seed, layers=None):
    adapters, ranks, weights = hetero_cohort(n=5, seed=seed, r_lo=0,
                                             r_hi=R_MAX - 2)
    if layers:
        adapters = [jax.tree.map(lambda x: jnp.stack([x] * layers), a)
                    for a in adapters]
    return adapters, ranks, weights


@pytest.mark.parametrize("name,cohort", [
    (name, cohort) for name in MEAN_FAMILY + ROBUST
    for cohort in ("prev", "no_prev", "layers", "mixed")
    # rbla_norm refuses layer-stacked pairs in both packages
    if not (name == "rbla_norm" and cohort == "layers")])
def test_planned_round_is_one_call_and_matches_jax(name, cohort):
    """Every mean-family and robust strategy's planned round (one plain
    call) against the JAX aggregate: with and without prev, layer-stacked
    pairs, a mixed-codec encoded cohort; rank-0 clients and rank rows no
    client owns throughout."""
    adapters, ranks, w = _cohort(11, layers=3 if cohort == "layers" else None)
    kw = dict(r_max=R_MAX, client_ranks=ranks)
    prev = None
    if cohort != "no_prev":
        prev = hetero_cohort(n=1, seed=12, r_lo=R_MAX, r_hi=R_MAX)[0][0]
        if cohort == "layers":
            prev = jax.tree.map(lambda x: jnp.stack([x] * 3), prev)
    jin, tin = adapters, [port_tree(a) for a in adapters]
    if cohort == "mixed":
        codecs = ["int8", "bf16", "none", "int8", "bf16"]
        jin = [jcodec.encode_adapters(a, c) for a, c in zip(adapters, codecs)]
        tin = [tcodec.encode_adapters(t, c) for t, c in zip(tin, codecs)]
        kw["client_ranks"] = None
    jstr = js.get_strategy(name).with_options(**(
        KNOBS if name == "rbla_clipped" else {}))
    want = jstr.aggregate_adapters(jin, w, prev_global=prev, backend="ref",
                                   **kw)
    tstr = ts.get_strategy(name).with_options(**(
        KNOBS if name == "rbla_clipped" else {}))
    runtime.reset_counts()
    got = tstr.aggregate_adapters(
        tin, torch.as_tensor(np.asarray(w)),
        prev_global=None if prev is None else port_tree(prev),
        backend="ref", **{k: (torch.as_tensor(np.asarray(v))
                              if k == "client_ranks" and v is not None
                              else v) for k, v in kw.items()})
    (plan,) = tstr.__dict__["_plan_cache"].values()
    kernel = "packed_robust" if name in ROBUST else "packed_agg"
    assert plan.kind == "packed" and plan.n_kernel_launches == 1
    assert runtime.PLAIN_CALLS[kernel] == 1
    # each pair's leaves in the per-leaf path's order (tree_leaves zips them)
    assert all(list(p) == ["A", "B", "rank"] for p in got.values())
    assert_trees_close(got, jax.tree.map(np.asarray, want), msg=name)
