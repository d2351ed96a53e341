"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, the strategies' kernel paths against their ref paths, and the
serving store's stream rule on two streams.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it also runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (BF16_TOL, F32_TOL, assert_close, group_cohort,
                           need_cuda)

from repro_torch.core import strategy as ts
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import (axpy_fold, axpy_fold_group,
                                          axpy_fold_group_ref, axpy_fold_ref,
                                          flora_stack, flora_stack_ref,
                                          packed_agg, packed_agg_ref,
                                          packed_robust, packed_robust_ref,
                                          packed_stack, packed_stack_ref,
                                          rbla_agg, rbla_agg_ref)
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

WIDTHS = (10, 200, 784)
MODES = [(norm_by, prev, restore) for norm_by in ("mask", "weight")
         for prev in (False, True) for restore in (False, True)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _inputs(n, r, d, dtype, seed, with_prev):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, r, n)
    masks = torch.as_tensor(
        (np.arange(r)[None, :] < ranks[:, None]).astype(np.float32))
    weights = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32))
    scales = None
    if dtype == "int8":
        x = torch.as_tensor(rng.integers(-127, 128, (n, r, d)).astype(np.int8))
        scales = torch.as_tensor(
            rng.uniform(0.001, 0.02, (n, r)).astype(np.float32)).cuda()
    else:
        x = torch.as_tensor(rng.normal(size=(n, r, d)).astype(np.float32)).to(
            DTYPES[dtype])
    out_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    prev = (torch.as_tensor(rng.normal(size=(r, d)).astype(np.float32)).to(
        out_dtype).cuda() if with_prev else None)
    return x.cuda(), masks.cuda(), weights.cuda(), prev, scales, out_dtype


def _check_packed(x, masks, weights, prev, scales, out_dtype, **kw):
    kw = dict(kw, scales=scales, out_dtype=out_dtype)
    before = runtime.LAUNCHES["packed_agg"]
    got = packed_agg(x, masks, weights, prev, **kw)
    assert runtime.LAUNCHES["packed_agg"] == before + 1
    want = packed_agg_ref(x, masks, weights, prev, **kw)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == out_dtype
    assert_close(got, want, BF16_TOL if out_dtype == torch.bfloat16
                 else F32_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("norm_by,with_prev,restore", MODES)
def test_packed_agg_kernel_matches_plain(dtype, d, norm_by, with_prev,
                                         restore):
    need_cuda()
    _check_packed(*_inputs(10, 64, d, dtype, d, with_prev), norm_by=norm_by,
                  norm_restore=restore)


@pytest.mark.parametrize("restore", [False, True])
def test_packed_agg_kernel_large_and_misaligned(restore):
    """A large bucket (vector path) and the same data at a pointer 4 bytes
    off 16-byte alignment (scalar path) give the same answer."""
    need_cuda()
    x, masks, weights, prev, _, _ = _inputs(10, 512, 4096, "f32", 1, True)
    _check_packed(x, masks, weights, prev, None, torch.float32,
                  norm_restore=restore)
    flat = torch.empty(x.numel() + 1, device="cuda")
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _check_packed(shifted, masks, weights, prev, None, torch.float32,
                  norm_restore=restore)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("method", ["rbla", "zeropad"])
def test_rbla_agg_kernel_matches_plain(dtype, d, method):
    need_cuda()
    x, _, weights, _, _, _ = _inputs(10, 64, d, dtype, d, False)
    ranks = torch.as_tensor(np.random.default_rng(d).integers(
        1, 65, 10).astype(np.int32)).cuda()
    before = runtime.LAUNCHES["rbla_agg"]
    got = rbla_agg(x, ranks, weights, method=method)
    assert runtime.LAUNCHES["rbla_agg"] == before + 1
    want = rbla_agg_ref(x, ranks, weights,
                        norm_by="mask" if method == "rbla" else "weight")
    torch.cuda.synchronize()
    assert_close(got, want, BF16_TOL if dtype == "bf16" else F32_TOL)


def test_cuda_tensor_never_takes_the_plain_version():
    need_cuda()
    x = torch.randn(2, 3, 4, device="cuda")
    with pytest.raises(ValueError, match="always takes the kernel"):
        packed_agg(x, torch.ones(2, 3, device="cuda"),
                   torch.ones(2, device="cuda"), backend="ref")
    with pytest.raises(ValueError, match="is on cpu"):
        packed_agg(x, torch.ones(2, 3), torch.ones(2, device="cuda"))


def _cohort(seed, n=5, r_max=8, specs=(("fc1", 12, 16), ("fc2", 10, 12))):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, r_max, n)
    clients = []
    for rank in ranks:
        ad = {}
        for name, fo, fi in specs:
            a = rng.normal(size=(r_max, fi)).astype(np.float32)
            b = rng.normal(size=(fo, r_max)).astype(np.float32)
            a[rank:], b[:, rank:] = 0.0, 0.0
            ad[name] = {"A": torch.as_tensor(a), "B": torch.as_tensor(b),
                        "rank": torch.tensor(int(rank), dtype=torch.int32)}
        clients.append(ad)
    prev = {name: {"A": torch.randn(r_max, fi), "B": torch.randn(fo, r_max),
                   "rank": torch.tensor(r_max, dtype=torch.int32)}
            for name, fo, fi in specs}
    weights = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32))
    return clients, torch.as_tensor(ranks.astype(np.int32)), weights, prev


@pytest.mark.parametrize("name", ["fedavg", "zeropad", "rbla", "rbla_ranked",
                                  "rbla_norm"])
def test_strategy_kernel_paths_match_ref(name):
    need_cuda()
    clients, ranks, weights, prev = _cohort(0)
    strat = ts.get_strategy(name)
    want = strat.aggregate_adapters(clients, weights, r_max=8,
                                    client_ranks=ranks, prev_global=prev,
                                    backend="ref")
    cuda = lambda t: t.cuda()                                 # noqa: E731
    cclients = [tree_map(cuda, c) for c in clients]
    runtime.reset_counts()
    for use_plan in (True, False):
        got = strat.aggregate_adapters(cclients, weights.cuda(), r_max=8,
                                       client_ranks=ranks.cuda(),
                                       prev_global=tree_map(cuda, prev),
                                       use_plan=use_plan)
        for k in want:
            for side in ("A", "B"):
                assert got[k][side].is_cuda
                assert_close(got[k][side], want[k][side])
    assert runtime.PLAIN_CALLS == dict.fromkeys(runtime.KERNELS, 0)
    # the plan's round is one grouped launch; rbla_norm's per-pair path one
    # more per pair (the others take rbla_agg there)
    want_launches = 1 + (len(want) if name == "rbla_norm" else 0)
    assert runtime.LAUNCHES["packed_agg"] == want_launches
    # the others' per-pair round: one grouped rbla_agg launch
    assert runtime.LAUNCHES["rbla_agg"] == (name != "rbla_norm")


def test_simulation_kernel_rounds_match_plain_rounds():
    need_cuda()
    kw = dict(rounds=2, n_clients=4, n_per_class=20, n_test_per_class=10,
              batch_size=16, lr=0.01, r_max=8)
    runtime.reset_counts()
    got = run_simulation(FLConfig(**kw))
    assert runtime.LAUNCHES["packed_agg"] == 2 * 1       # one a round
    assert runtime.PLAIN_CALLS["packed_agg"] == 0
    want = run_simulation(FLConfig(agg_backend="ref", **kw))
    np.testing.assert_allclose(got.test_acc, want.test_acc, atol=0.01)
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-3)


# ------------------------------------------------------------ packed_robust --
ROBUST_KNOBS = dict(clip_norm=2.5, trim_frac=0.2)


def _robust_inputs(n, r, d, dtype, seed, with_prev):
    """Like ``_inputs``, with rank-0 clients, unowned rows and a column of
    ties across clients."""
    x, masks, weights, prev, scales, out_dtype = _inputs(n, r, d, dtype, seed,
                                                         with_prev)
    masks[0] = 0.0
    x[:, :, min(1, d - 1)] = 7 if dtype == "int8" else 0.5
    return x, masks, weights, prev, scales, out_dtype


def _check_robust(x, masks, weights, prev, scales, out_dtype, mode):
    kw = dict(mode=mode, scales=scales, out_dtype=out_dtype, **ROBUST_KNOBS)
    before = runtime.LAUNCHES["packed_robust"]
    got = packed_robust(x, masks, weights, prev, **kw)
    assert runtime.LAUNCHES["packed_robust"] == before + 1
    want = packed_robust_ref(x, masks, weights, prev, **kw)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == out_dtype
    assert_close(got, want, BF16_TOL if out_dtype == torch.bfloat16
                 else F32_TOL)


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("n", [1, 10, 33, 70])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["clipped", "trimmed", "median"])
def test_packed_robust_kernel_matches_plain(mode, dtype, d, n, with_prev):
    """Every mode and input type, at the register networks for 8 and 64
    clients and at 70 (selection by counting)."""
    need_cuda()
    _check_robust(*_robust_inputs(n, 64, d, dtype, n + d, with_prev), mode)


@pytest.mark.parametrize("mode", ["clipped", "trimmed", "median"])
def test_packed_robust_kernel_large_misaligned_and_nan(mode):
    need_cuda()
    x, masks, weights, prev, _, _ = _robust_inputs(10, 512, 4096, "f32", 2,
                                                   True)
    _check_robust(x, masks, weights, prev, None, torch.float32, mode)
    flat = torch.empty(x.numel() + 1, device="cuda")
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    _check_robust(shifted, masks, weights, prev, None, torch.float32, mode)
    owner = int(masks[:, 3].argmax())
    x[owner, 3, 5] = float("nan")
    got = packed_robust(x, masks, weights, prev, mode=mode, **ROBUST_KNOBS)
    want = packed_robust_ref(x, masks, weights, prev, mode=mode,
                             **ROBUST_KNOBS)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[3]).any())


def test_packed_robust_kernel_refuses_too_many_clients():
    need_cuda()
    x = torch.zeros(2049, 2, 3, device="cuda")
    with pytest.raises(ValueError, match="2048"):
        packed_robust(x, torch.ones(2049, 2, device="cuda"),
                      torch.ones(2049, device="cuda"), mode="median")


# ------------------------------------------ grouped packed_agg / robust --
GROUP_FANS = (10, 200, 784, 4099)


def _on_card(kw):
    """``group_cohort``'s arguments with every tensor on the card."""
    def move(v):
        if v is None or isinstance(v, torch.Tensor):
            return None if v is None else v.cuda()
        return [move(t) for t in v]
    out = dict(kw)
    for k in ("xs", "prevs", "scales"):
        out[k] = [move(v) for v in kw[k]]
    out["masks"], out["weights"] = kw["masks"].cuda(), kw["weights"].cuda()
    return out


def _one_segment(kw, i, fn, **extra):
    """Segment i through the one-segment form ``fn`` (packed_agg or
    packed_robust) on its rank rows packed by hand (per-client leaves
    dequantised in fp32 first, as the kernel dequantises on the load)."""
    from repro_torch.kernels.rbla_agg.ref import (leaf_from_rank_rows,
                                                  leaf_rank_rows)
    x, col, off = kw["xs"][i], kw["cols"][i], kw["mask_offs"][i]
    sc = kw["scales"][i]
    if isinstance(x, torch.Tensor):
        shape, xr = tuple(x.shape[1:]), leaf_rank_rows(x, col).contiguous()
        sc = None if sc is None else sc.reshape(xr.shape[0], -1)
    else:
        shape, clients = tuple(x[0].shape), []
        for t, s in zip(x, sc or [None] * len(x)):
            tr = leaf_rank_rows(t[None].float(), col)[0]
            clients.append(tr if s is None else s.reshape(-1)[:, None] * tr)
        xr, sc = torch.stack(clients), None
    m = kw["masks"][:, off:off + xr.shape[1]].contiguous()
    prev = kw["prevs"][i]
    pr = None if prev is None else leaf_rank_rows(prev[None], col)[0]
    out = fn(xr, m, kw["weights"], pr, scales=sc,
             out_dtype=kw["out_dtypes"][i], **extra)
    return leaf_from_rank_rows(out, shape, col)


def _check_agg_group(kw, group, group_ref, one, exact, name, **extra):
    """The grouped kernel in one launch against its plain twin (within the
    fp32/bf16 tolerance), against a second run (bit for bit) and against
    the one-segment form on the hand-packed cohort: bit for bit where
    ``exact``; else (row norms: a rank column of B sums in another order
    than the packed row) within 1e-6 of max|want| in fp32, and in bf16
    within one bf16 rounding of the element more."""
    before = runtime.LAUNCHES[name]
    got = group(**kw, **extra)
    assert runtime.LAUNCHES[name] == before + 1
    again = group(**kw, **extra)
    want = group_ref(**kw, **extra)
    torch.cuda.synchronize()
    tol = BF16_TOL if kw["out_dtypes"][0] == torch.bfloat16 else F32_TOL
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert g.is_cuda and g.dtype == kw["out_dtypes"][i]
        assert torch.equal(g, a), f"segment {i}: two runs differ"
        assert_close(g, w, tol, f"segment {i}")
        o = _one_segment(kw, i, one, **extra)
        if exact:
            assert torch.equal(g, o), f"segment {i}: not the one-segment bits"
        else:
            diff = (g.float() - o.float()).abs()
            bound = 1e-6 * max(float(o.float().abs().max()), 1e-30)
            if g.dtype == torch.bfloat16:
                bound = bound + 2.0 ** -7 * o.float().abs()
            assert bool((diff <= bound).all()), f"segment {i}"


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "mixed"])
@pytest.mark.parametrize("norm_by,restore", [("mask", False),
                                             ("weight", False),
                                             ("mask", True)])
def test_packed_agg_group_kernel_matches_plain_and_one_segment(
        norm_by, restore, dtype, lead):
    """Every pair side of a round, ragged widths, rank-0 clients and rows no
    one owns, stacked or per-client (mixed wire dtypes): one launch."""
    from repro_torch.kernels.rbla_agg import (packed_agg_group,
                                              packed_agg_group_ref)
    need_cuda()
    kw = _on_card(group_cohort(20 + len(lead), n=10, dtype=dtype,
                               fans=GROUP_FANS, r=16, lead=lead,
                               per_client=dtype == "mixed"))
    _check_agg_group(kw, packed_agg_group, packed_agg_group_ref, packed_agg,
                     not restore, "packed_agg", norm_by=norm_by,
                     norm_restore=restore)


@pytest.mark.parametrize("n", [1, 10, 33, 70])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "mixed"])
@pytest.mark.parametrize("mode", ["clipped", "trimmed", "median"])
def test_packed_robust_group_kernel_matches_plain_and_one_segment(
        mode, dtype, n):
    """Exact networks (N = 1, 10), the 64-slot one (33) and selection by
    counting (70), over every dtype and a mixed per-client cohort."""
    from repro_torch.kernels.rbla_agg import (packed_robust_group,
                                              packed_robust_group_ref)
    need_cuda()
    kw = _on_card(group_cohort(30 + n, n=n, dtype=dtype, fans=GROUP_FANS,
                               r=16, lead=(2,) if n == 10 else (),
                               per_client=dtype == "mixed"))
    _check_agg_group(kw, packed_robust_group, packed_robust_group_ref,
                     packed_robust, mode != "clipped", "packed_robust",
                     mode=mode, **ROBUST_KNOBS)


@pytest.mark.parametrize("kernel", ["packed_agg", "packed_robust"])
def test_group_kernel_takes_a_table_too_long_for_the_parameters(kernel):
    """20 segments (the parameter space holds 16): the table goes to the
    card by one async copy, still one launch, the same bits as each
    segment alone."""
    from repro_torch.kernels.rbla_agg import (packed_agg_group,
                                              packed_agg_group_ref,
                                              packed_robust_group,
                                              packed_robust_group_ref)
    need_cuda()
    kw = _on_card(group_cohort(40, n=10, fans=tuple(range(3, 13)), r=8))
    assert len(kw["xs"]) == 20
    if kernel == "packed_agg":
        _check_agg_group(kw, packed_agg_group, packed_agg_group_ref,
                         packed_agg, True, kernel)
    else:
        _check_agg_group(kw, packed_robust_group, packed_robust_group_ref,
                         packed_robust, True, kernel, mode="median",
                         **ROBUST_KNOBS)


def test_group_kernel_nan_follows_the_plain_version():
    """A NaN or inf among a row's owned values: the flagged element gives
    the plain version's NaN or infinity; its neighbours stay finite."""
    from repro_torch.kernels.rbla_agg import (packed_robust_group,
                                              packed_robust_group_ref)
    need_cuda()
    kw = _on_card(group_cohort(41, n=10, fans=(200,), r=16))
    owner = int(kw["masks"][:, 2].argmax())
    kw["xs"][0][owner, 2, 5] = float("nan")
    kw["xs"][1][owner, 7, 2] = float("inf")     # B: rank column 2
    for mode in ("trimmed", "median"):
        got = packed_robust_group(**kw, mode=mode, **ROBUST_KNOBS)
        want = packed_robust_group_ref(**kw, mode=mode, **ROBUST_KNOBS)
        for g, w in zip(got, want):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert torch.equal(torch.isinf(g), torch.isinf(w))
            fin = torch.isfinite(w)
            assert_close(g[fin], w[fin])
        assert bool(torch.isnan(got[0][2, 5])) and \
            bool(torch.isfinite(got[0][2, 4]))


def test_rbla_round_on_the_card_runs_the_grouped_kernel_alone():
    """One rbla CompiledRound call: the grouped kernel is the only device
    kernel (torch.profiler), and no PyTorch operation concatenates,
    stacks, copies or casts leaf data."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import plan as tplan
    need_cuda()
    clients, ranks, weights, prev = _cohort(0)
    cuda = lambda t: t.cuda()                                 # noqa: E731
    stacked = ts.stack_trees([tree_map(cuda, c) for c in clients])
    cprev, w = tree_map(cuda, prev), weights.cuda()
    round_ = ts.get_strategy("rbla").plan(None, tplan.build_cohort_spec(
        stacked, kind="kernel", r_max=8, client_ranks=ranks.cuda(),
        prev_tree=cprev))
    assert round_.n_kernel_launches == 1
    round_(stacked, w, cprev)
    torch.cuda.synchronize()

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    before = runtime.LAUNCHES["packed_agg"]
    with Ops() as ops:
        round_(stacked, w, cprev)
    assert runtime.LAUNCHES["packed_agg"] == before + 1
    moved = {"cat", "stack", "copy_", "_to_copy", "clone", "index_select",
             "gather", "mul", "add"}
    assert not moved & set(ops.names), ops.names
    # a warm-up step, then the counted one (records of the first launches
    # after the profiler starts may be lost)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            round_(stacked, w, cprev)
            torch.cuda.synchronize()
            prof.step()
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            kernels += [ev.key] * ev.count
    assert len(kernels) == 1 and "stream_kernel" in kernels[0], kernels


# ------------------------------------------------- per-pair grouped rounds --
#: (fan_out, fan_in) of a per-pair round's pairs: the paper MLP's and a
#: ragged one
PAIR_FANS = ((200, 784), (200, 200), (10, 200), (7, 4099))


def _off_by_4_bytes(t):
    """``t``'s values in a contiguous tensor 4 bytes off 16-byte alignment
    (the scalar path)."""
    flat = torch.empty(t.numel() * t.element_size() // 2 + 2,
                       dtype=torch.bfloat16, device="cuda")
    out = flat[2:2 + t.numel() * t.element_size() // 2].view(t.dtype).view(
        t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def _pair_round(seed, dtype=torch.float32, shared=True, misaligned=False,
                n=10, r=64):
    """A per-pair round on the card: each pair's A (n, r, fan_in) and B (n,
    fan_out, r), client 0 at rank 0 and no client above r - 2 (rank rows
    no one owns), a previous global, positive weights; the ranks one column
    for every pair or one a pair, and the same owners as float masks with
    their offsets (packed_agg_group's arguments)."""
    rng = np.random.default_rng(seed)
    cols = 1 if shared else len(PAIR_FANS)
    ranks = rng.integers(0, r - 1, (n, cols)).astype(np.int32)
    ranks[0] = 0
    xs, prevs = [], []
    for fo, fi in PAIR_FANS:
        for shape in ((r, fi), (fo, r)):
            x = torch.as_tensor(rng.normal(size=(n,) + shape).astype(
                np.float32)).to(dtype).cuda()
            xs.append(_off_by_4_bytes(x) if misaligned else x)
            prevs.append(torch.as_tensor(rng.normal(size=shape).astype(
                np.float32)).to(dtype).cuda())
    rank_cols = [0 if shared else i // 2 for i in range(len(xs))]
    masks = torch.cat([ts.stacked_rank_masks(r, torch.as_tensor(ranks[:, c]))
                       for c in range(cols)], 1).cuda()
    return dict(xs=xs, ranks=torch.as_tensor(ranks).cuda(),
                weights=torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(
                    np.float32)).cuda(),
                prevs=prevs, cols=[i % 2 == 1 for i in range(len(xs))],
                rank_cols=rank_cols, masks=masks,
                mask_offs=[c * r for c in rank_cols])


def _rbla_group(kw, method="rbla"):
    from repro_torch.kernels.rbla_agg import rbla_agg_group
    return rbla_agg_group(kw["xs"], kw["ranks"], kw["weights"], kw["prevs"],
                          cols=kw["cols"], rank_cols=kw["rank_cols"],
                          method=method)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["rbla", "zeropad"])
def test_rbla_agg_group_kernel_is_packed_agg_group_on_rank_masks(
        method, dtype, shared, misaligned):
    """One launch for every pair side of a round, ragged and misaligned
    widths: the bits of ``packed_agg_group`` fed ``stacked_rank_masks`` (one
    mean body; with positive weights the two prev rules agree), within the
    fp32/bf16 tolerance of the plain twin, the same bits twice."""
    from repro_torch.kernels.rbla_agg import (packed_agg_group,
                                              rbla_agg_group_ref)
    need_cuda()
    kw = _pair_round(50, dtype, shared, misaligned)
    before = runtime.LAUNCHES["rbla_agg"]
    got = _rbla_group(kw, method)
    assert runtime.LAUNCHES["rbla_agg"] == before + 1
    again = _rbla_group(kw, method)
    want = packed_agg_group(
        kw["xs"], kw["masks"], kw["weights"], kw["prevs"], cols=kw["cols"],
        mask_offs=kw["mask_offs"],
        norm_by="mask" if method == "rbla" else "weight")
    plain = rbla_agg_group_ref(
        kw["xs"], kw["ranks"], kw["weights"], kw["prevs"], cols=kw["cols"],
        rank_cols=kw["rank_cols"],
        norm_by="mask" if method == "rbla" else "weight")
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for i, (g, a, w, p) in enumerate(zip(got, again, want, plain)):
        assert g.dtype == dtype and g.shape == kw["xs"][i].shape[1:]
        assert torch.equal(g, a) and torch.equal(g, w), f"segment {i}"
        assert_close(g, p, tol, f"segment {i}")


def test_rbla_agg_group_kernel_prev_rule_and_nan():
    """A client of weight 0 alone at the top rank rows: 0 there, prev only
    where no client owns a rank row; a NaN in a rank row its client does
    not own reaches the result where another client owns it, as in the
    plain twin."""
    from repro_torch.kernels.rbla_agg import rbla_agg_group_ref
    need_cuda()
    kw = _pair_round(51, n=3)
    kw["ranks"][:, 0] = torch.tensor([2, 5, 40], dtype=torch.int32)
    kw["weights"][2] = 0.0
    kw["xs"][0][0, 4, 3] = float("nan")          # client 0 owns rows 0..1
    kw["xs"][1][0, 7, 4] = float("inf")          # B: rank column 4
    got = _rbla_group(kw)
    want = rbla_agg_group_ref(kw["xs"], kw["ranks"], kw["weights"],
                              kw["prevs"], cols=kw["cols"],
                              rank_cols=kw["rank_cols"])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        fin = torch.isfinite(w)
        assert_close(g[fin], w[fin])
    a, b = got[0], got[1]
    assert bool(a[4, 3].isnan()) and bool(a[4, 2].isfinite())
    assert bool(b[7, 4].isnan()) and bool(b[7, 3].isfinite())
    assert bool((a[5:40] == 0).all()) and bool((b[:, 5:40] == 0).all())
    assert torch.equal(a[40:], kw["prevs"][0][40:])
    assert torch.equal(b[:, 40:], kw["prevs"][1][:, 40:])


def test_rbla_agg_group_kernel_takes_a_table_too_long_for_the_parameters():
    """Twenty pair sides (the parameter space holds 16): the table goes to
    the card by one async copy, still one launch, the same bits."""
    from repro_torch.kernels.rbla_agg import packed_agg_group
    need_cuda()
    kw = _pair_round(52)
    for k in ("xs", "prevs", "cols", "rank_cols", "mask_offs"):
        kw[k] = (kw[k] * 3)[:20]
    before = runtime.LAUNCHES["rbla_agg"]
    got = _rbla_group(kw)
    assert runtime.LAUNCHES["rbla_agg"] == before + 1
    want = packed_agg_group(kw["xs"], kw["masks"], kw["weights"],
                            kw["prevs"], cols=kw["cols"],
                            mask_offs=kw["mask_offs"])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _flora_round(seed, dtype=torch.float32, lead=(), misaligned=False,
                 n=10, r=64, cap=512):
    """A per-pair flora round's segments on the card: the cohort's A and B
    at storage r with staircase-like ranks (client 3 at rank 0), a global
    at storage cap and live rank r first, flora's mass scales on B."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, r + 1, n)
    ranks[3] = 0
    con = ((-1, r),) + tuple((i, int(k)) for i, k in enumerate(ranks) if k)
    xs, prevs, cols = [], [], []
    for fo, fi in PAIR_FANS:
        for col, shape, pshape in ((False, (r, fi), (cap, fi)),
                                   (True, (fo, r), (fo, cap))):
            x = torch.as_tensor(rng.normal(size=(n,) + lead + shape).astype(
                np.float32)).to(dtype).cuda()
            xs.append(_off_by_4_bytes(x) if misaligned else x)
            prevs.append(torch.as_tensor(rng.normal(size=lead + pshape).astype(
                np.float32)).to(dtype).cuda())
            cols.append(col)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32)).cuda()
    return dict(xs=xs, contribs=[con] * len(xs), prevs=prevs, cap=cap,
                cols=cols, scales=[None, "mass"] * len(PAIR_FANS),
                weights=w, prev_weight=1.0)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flora_stack_group_kernel_matches_plain_bit_for_bit(dtype, lead,
                                                            misaligned):
    """Every pair side of a flora round in one launch, ragged and
    misaligned widths, layer-stacked pairs, bf16: the plain twin's bits
    (one fp32 multiply per element, rounded once)."""
    from repro_torch.kernels.rbla_agg import (flora_stack_group,
                                              flora_stack_group_ref)
    need_cuda()
    kw = _flora_round(60, dtype, lead, misaligned)
    before = runtime.LAUNCHES["flora_stack"]
    got = flora_stack_group(**kw)
    assert runtime.LAUNCHES["flora_stack"] == before + 1
    caps = [kw["cap"]] * len(kw["xs"])
    want = flora_stack_group_ref(
        kw["xs"], kw["contribs"], kw["prevs"], cols=kw["cols"], caps=caps,
        scales=kw["scales"], weights=kw["weights"], out_dtypes=[dtype] * 8)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w), f"segment {i}"


def test_flora_stack_group_kernel_takes_a_table_too_long_for_the_parameters():
    """Twenty segments and 300 contributors (the parameter space holds 16
    and 256): one launch from the device copy, the plain twin's bits."""
    from repro_torch.kernels.rbla_agg import (flora_stack_group,
                                              flora_stack_group_ref)
    need_cuda()
    kw = _flora_round(61, n=40, r=8, cap=400)
    kw["xs"], kw["prevs"] = (kw["xs"] * 3)[:20], (kw["prevs"] * 3)[:20]
    kw["cols"], kw["scales"] = (kw["cols"] * 3)[:20], (kw["scales"] * 3)[:20]
    con = kw["contribs"][0]
    kw["contribs"] = [((-1, 1 + j % 8),) + tuple(
        (i, max(1, min(r, 8 - (i + j) % 5))) for i, r in con[1:])
        for j in range(20)]
    assert sum(len(c) for c in {tuple(c) for c in kw["contribs"]}) > 256
    before = runtime.LAUNCHES["flora_stack"]
    got = flora_stack_group(**kw)
    assert runtime.LAUNCHES["flora_stack"] == before + 1
    want = flora_stack_group_ref(
        kw["xs"], kw["contribs"], kw["prevs"], cols=kw["cols"],
        caps=[kw["cap"]] * 20, scales=kw["scales"], weights=kw["weights"],
        out_dtypes=[torch.float32] * 20)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flora_per_pair_round_is_the_old_composition_bit_for_bit(dtype):
    """The per-pair flora round on the card gives the bits of the
    composition it replaced -- each pair's contributors cast to fp32,
    padded, B transposed, concatenated, stacked by the plain version and
    cast back -- fed the same fp32 scales."""
    from repro_torch.kernels.rbla_agg import flora_stack_ref
    from repro_torch.kernels.rbla_agg.ref import flora_mass_scales
    need_cuda()
    clients, ranks, weights, prev = _cohort(3)
    cuda = lambda t: t.to(dtype).cuda() if t.is_floating_point() \
        else t.cuda()                                         # noqa: E731
    stacked = ts.stack_trees([tree_map(cuda, c) for c in clients])
    cprev, w = tree_map(cuda, prev), weights.cuda()
    strat = ts.get_strategy("flora").with_options(stack_r_cap=64)
    runtime.reset_counts()
    got = strat.aggregate_tree_kernel(stacked, w, ranks, cprev, r_max=8)
    assert runtime.LAUNCHES["flora_stack"] == 1
    live = [i for i, r in enumerate(ranks.tolist()) if r > 0]
    con = ((-1, 8),) + tuple((i, int(ranks[i])) for i in live)
    scales = torch.tensor([float(v) for v in flora_mass_scales(
        w, con, 1.0, 1e-12)], device="cuda")
    for k, pair in stacked.items():
        parts = {"A": [cprev[k]["A"][:8].float()],
                 "B": [cprev[k]["B"][:, :8].T.float()]}
        for i in live:
            parts["A"].append(pair["A"][i].float())
            parts["B"].append(pair["B"][i].T.float())
        for side, sc in (("A", torch.ones_like(scales)), ("B", scales)):
            stack = torch.stack([ts.pad_to_rank(t, 0, 8) for t in parts[side]])
            old = flora_stack_ref(stack, sc, [r for _, r in con], 64)
            old = (old.T if side == "B" else old).to(dtype)
            assert torch.equal(got[k][side], old), f"{k} {side}"
        assert int(got[k]["rank"]) == sum(r for _, r in con)


def _kernels_and_copies(fn):
    """The device events of one call of ``fn`` (torch.profiler, a warm-up
    step then the counted one): kernel names, and memory copies."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    kernels, copies = [], []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            (copies if ev.key.startswith("Memcpy") else kernels).extend(
                [ev.key] * ev.count)
    return kernels, copies


@pytest.mark.parametrize("name", ["rbla", "zeropad", "flora"])
def test_per_pair_round_on_the_card_runs_the_grouped_kernel_alone(name):
    """One per-pair round (``aggregate_tree_kernel``): the grouped kernel is
    its only device kernel; the mean family also moves nothing, flora
    reads only the live ranks its host-side offsets need (prev's)."""
    need_cuda()
    clients, ranks, weights, prev = _cohort(4)
    cuda = lambda t: t.cuda()                                 # noqa: E731
    stacked = ts.stack_trees([tree_map(cuda, c) for c in clients])
    cprev, w = tree_map(cuda, prev), weights.cuda()
    strat = ts.get_strategy(name).with_options(
        **(dict(stack_r_cap=64) if name == "flora" else {}))
    given = ranks if name == "flora" else ranks.cuda()
    kernels, copies = _kernels_and_copies(
        lambda: strat.aggregate_tree_kernel(stacked, w, given, cprev,
                                            r_max=8))
    want = "stack_group_kernel" if name == "flora" else "stream_kernel"
    assert len(kernels) == 1 and want in kernels[0], kernels
    if name == "flora":
        assert all("DtoH" in c for c in copies), copies
    else:
        assert not copies, copies


# ----------------------------------------------------------- stack kernels --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS + (4096,))
def test_flora_stack_kernel_matches_plain(d, dtype):
    need_cuda()
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.normal(size=(11, 64, d)).astype(np.float32)).to(
        dtype).cuda()
    scales = torch.as_tensor(rng.uniform(0.1, 3.0, 11).astype(np.float32))
    segs = (64, 0, 13, 19, 26, 32, 38, 45, 51, 58, 64)
    before = runtime.LAUNCHES["flora_stack"]
    got = flora_stack(x, scales.cuda(), segs=segs, out_rows=512)
    assert runtime.LAUNCHES["flora_stack"] == before + 1
    want = flora_stack_ref(x, scales.cuda(), segs, 512)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_packed_stack_kernel_matches_plain(d, misaligned):
    """Overlapping x and prev copies (the later one wins), zero rows, and a
    pointer off 16-byte alignment (the scalar path)."""
    need_cuda()
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.normal(size=(3, 6, d)).astype(np.float32)).cuda()
    if misaligned:
        flat = torch.empty(x.numel() + 1, device="cuda")
        x = flat[1:].view(x.shape).copy_(x)
    prev = torch.as_tensor(rng.normal(size=(4, d)).astype(np.float32)).cuda()
    scales = torch.tensor([0.5, 2.0, 3.0], device="cuda")
    kw = dict(copies_x=((0, 1, 0, 2, 1), (2, 0, 4, 3, 2), (1, 2, 5, 2, 0)),
              copies_prev=((0, 8, 2, 1), (1, 3, 2, 2)), out_rows=11)
    before = runtime.LAUNCHES["packed_stack"]
    got = packed_stack(x, scales, prev, **kw)
    assert runtime.LAUNCHES["packed_stack"] == before + 1
    want = packed_stack_ref(x, scales, prev, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


#: the main path's pairs (fan_out, fan_in) and its staircase cohort's ranks
MLP_PAIRS = ((200, 784), (200, 200), (10, 200))
STAIRCASE = (6, 13, 19, 26, 32, 38, 45, 51, 58, 64)


def _stack_group_case(case, dtype, seed):
    """A grouped stack round's plan and its inputs on the card.  "mlp": the
    flora plan's round on the main path (the MLP's pairs at storage 64,
    the staircase cohort, a global at storage 512 and live rank 64 first,
    cap 512); "large": 10 contributors x 200 rank rows into a 2048-row cap
    at width 4096, an A by rank row and a B by rank column, no prev."""
    from repro_torch.kernels.rbla_agg import stack_plan
    rng = np.random.default_rng(seed)
    if case == "mlp":
        con = ((-1, 64),) + tuple(enumerate(STAIRCASE))
        shapes, prev_shapes = [], []
        for fo, fi in MLP_PAIRS:
            shapes += [(10, 64, fi), (10, fo, 64)]
            prev_shapes += [(512, fi), (fo, 512)]
        cap = 512
    else:
        con = tuple((i, 200) for i in range(10))
        shapes, prev_shapes, cap = [(10, 256, 4096), (10, 4096, 256)], None, 2048
    k = len(shapes)
    plan = stack_plan(shapes, [con] * k, cap=cap, dtypes=[dtype] * k,
                      cols=[False, True] * (k // 2), prev_shapes=prev_shapes,
                      prev_dtypes=None if prev_shapes is None else [dtype] * k,
                      scales=[None, "mass"] * (k // 2))
    make = lambda shape: torch.as_tensor(rng.normal(size=shape).astype(
        np.float32)).to(dtype).cuda()                             # noqa: E731
    xs = [make(sh) for sh in shapes]
    prevs = None if prev_shapes is None else [make(sh) for sh in prev_shapes]
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 10).astype(np.float32)).cuda()
    return plan, xs, prevs, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mlp", "large"])
def test_packed_stack_group_kernel_matches_plain_bit_for_bit(case, dtype):
    """The flora plan's round as one grouped stack launch, counted as
    packed_stack: the plain twin's bits in every segment, each output in
    its leaf's layout and dtype."""
    from repro_torch.kernels.rbla_agg import (packed_stack_group,
                                              packed_stack_group_ref)
    need_cuda()
    plan, xs, prevs, w = _stack_group_case(case, dtype, 70)
    runtime.reset_counts()
    got = packed_stack_group(plan, xs, prevs, w)
    assert runtime.LAUNCHES["packed_stack"] == 1
    assert not any(runtime.PLAIN_CALLS.values())
    want = packed_stack_group_ref(plan, xs, prevs, w)
    torch.cuda.synchronize()
    for i, (g, wt) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == wt.shape
        assert torch.equal(g, wt), f"segment {i}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flora_plan_round_on_the_card_is_one_kernel(dtype):
    """A planned flora round (``CompiledRound``) on the card: one
    ``stack_group_kernel`` and no other device event (no packing, cast,
    concatenation, rank read or copy), and the bits of the same round on
    the plain twin."""
    from repro_torch.core import plan as tplan
    need_cuda()
    clients, ranks, weights, prev = _cohort(5)
    cuda = lambda t: t.to(dtype).cuda() if t.is_floating_point() \
        else t.cuda()                                         # noqa: E731
    stacked = ts.stack_trees([tree_map(cuda, c) for c in clients])
    cprev, w = tree_map(cuda, prev), weights.cuda()
    strat = ts.get_strategy("flora").with_options(stack_r_cap=64)

    def round_for(kind):
        return strat.plan(None, tplan.build_cohort_spec(
            stacked, kind=kind, r_max=8, prev_tree=cprev))
    round_ = round_for("kernel")
    assert round_.n_kernel_launches == 1
    runtime.reset_counts()
    got = round_(stacked, w, cprev)
    assert runtime.LAUNCHES["packed_stack"] == 1
    assert not any(runtime.PLAIN_CALLS.values())
    want = round_for("ref")(stacked, w, cprev)
    torch.cuda.synchronize()
    for k in got:
        for side in ("A", "B", "rank"):
            assert torch.equal(got[k][side], want[k][side]), (k, side)
    kernels, copies = _kernels_and_copies(lambda: round_(stacked, w, cprev))
    assert len(kernels) == 1 and "stack_group_kernel" in kernels[0], kernels
    assert not copies, copies


# ------------------------------------------- strategies of the later slice --
def _products(tree):
    return {k: (p["B"].float() @ p["A"].float(), int(p["rank"]))
            for k, p in tree.items()}


@pytest.mark.parametrize("name,options", [
    ("rbla_clipped", dict(clip_norm=2.5)), ("rbla_trimmed", {}),
    ("rbla_median", {}), ("svd", {}), ("flora", dict(stack_r_cap=64)),
    ("flora", dict(stack_r_cap=16))])
def test_later_strategy_kernel_paths_match_ref(name, options):
    """Plan and per-pair kernel paths against the ref backend on the
    card: robust and stacking factors within fp32 tolerance, svd and
    flora's re-projection in product space."""
    need_cuda()
    clients, ranks, weights, prev = _cohort(0)
    strat = ts.get_strategy(name).with_options(**options)
    want = strat.aggregate_adapters(clients, weights, r_max=8,
                                    client_ranks=ranks, prev_global=prev,
                                    backend="ref")
    cuda = lambda t: t.cuda()                                 # noqa: E731
    cclients = [tree_map(cuda, c) for c in clients]
    runtime.reset_counts()
    for use_plan in (True, False):
        got = strat.aggregate_adapters(cclients, weights.cuda(), r_max=8,
                                       client_ranks=ranks.cuda(),
                                       prev_global=tree_map(cuda, prev),
                                       use_plan=use_plan)
        g, w = _products(got), _products(want)
        for k in want:
            assert got[k]["A"].is_cuda and g[k][1] == w[k][1]
            assert_close(g[k][0], w[k][0], msg=f"{k} plan={use_plan}")
            if name.startswith("rbla") or g[k][1] > 8:
                for side in ("A", "B"):
                    assert_close(got[k][side], want[k][side])
    assert not any(runtime.PLAIN_CALLS.values()), runtime.PLAIN_CALLS
    kernel = {"rbla_clipped": "packed_robust", "rbla_trimmed":
              "packed_robust", "rbla_median": "packed_robust"}.get(name)
    if name == "flora" and options["stack_r_cap"] == 64:
        assert runtime.LAUNCHES["packed_stack"] == 1     # the planned round
        assert runtime.LAUNCHES["flora_stack"] == 1     # the per-pair round
    if kernel:      # the plan's one grouped launch, then one per pair
        assert runtime.LAUNCHES[kernel] == 1 + len(want)


def _layered(t, layers=3):
    """A scalar-rank cohort tree as a layer-stacked one: every leaf
    repeated over a leading layer axis (ranks uniform over the layers)."""
    return tree_map(lambda x: torch.stack([x] * layers), t)


@pytest.mark.parametrize("cap", [64, 16])
def test_flora_per_pair_kernel_stacks_layer_stacked_pairs(cap):
    """A layer-stacked cohort through the per-pair path on the card: within
    the cap one ``flora_stack`` launch for every pair side, equal to the
    ref path's stack; over it the SVD re-projection, in product space."""
    need_cuda()
    clients, ranks, weights, prev = _cohort(1)
    clients = [_layered(c) for c in clients]
    prev = _layered(prev)
    strat = ts.get_strategy("flora").with_options(stack_r_cap=cap)
    want = strat.aggregate_adapters(clients, weights, r_max=8,
                                    client_ranks=ranks, prev_global=prev,
                                    backend="ref", use_plan=False)
    cuda = lambda t: t.cuda()                                 # noqa: E731
    runtime.reset_counts()
    got = strat.aggregate_adapters([tree_map(cuda, c) for c in clients],
                                   weights.cuda(), r_max=8,
                                   client_ranks=ranks.cuda(),
                                   prev_global=tree_map(cuda, prev),
                                   use_plan=False)
    torch.cuda.synchronize()
    assert not any(runtime.PLAIN_CALLS.values()), runtime.PLAIN_CALLS
    within = int(ranks.sum()) + 8 <= cap
    assert runtime.LAUNCHES["flora_stack"] == (1 if within else 0)
    for k in want:
        assert got[k]["A"].is_cuda and got[k]["A"].shape == want[k]["A"].shape
        assert torch.equal(got[k]["rank"].cpu(), want[k]["rank"])
        if within:
            for side in ("A", "B"):
                assert_close(got[k][side], want[k][side])
        else:
            assert_close(got[k]["B"].double() @ got[k]["A"].double(),
                         want[k]["B"].double() @ want[k]["A"].double())


# -------------------------------------------------------------- axpy_fold --
def _fold_inputs(r, d, seed, y_dtype=torch.float32, x_dtype=None):
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.normal(size=(r, d)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(r, d)).astype(np.float32))
    alpha = rng.uniform(0.05, 1.0, r).astype(np.float32)
    alpha[rng.random(r) < 0.3] = 0.0                   # rows the client lacks
    return (y.to(y_dtype).cuda(), x.to(x_dtype or y_dtype).cuda(),
            torch.as_tensor(alpha).cuda())


def _check_fold(y, x, alpha, **kw):
    y_before = y.clone()
    before = runtime.LAUNCHES["axpy_fold"]
    got = axpy_fold(y, x, alpha, **kw)
    assert runtime.LAUNCHES["axpy_fold"] == before + 1
    want = axpy_fold_ref(y, x, alpha)
    torch.cuda.synchronize()
    assert got.dtype == y.dtype and got.shape == y.shape and got.is_cuda
    assert torch.equal(y, y_before)                   # y is never written
    # the kernel rounds each of its three fp32 operations as the plain
    # version does, so both agree bit for bit
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("dtypes", [("f32", "f32"), ("bf16", "bf16"),
                                    ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("r,d", [(64, 784), (256, 200), (64, 10), (7, 1),
                                 (512, 1024), (33, 4099)])
def test_axpy_fold_kernel_matches_plain(r, d, dtypes):
    need_cuda()
    y, x, alpha = _fold_inputs(r, d, r + d, DTYPES[dtypes[0]],
                               DTYPES[dtypes[1]])
    got = _check_fold(y, x, alpha)
    zero = alpha == 0
    assert torch.equal(got[zero], y[zero])            # unowned rows pass


def test_axpy_fold_kernel_scalar_alpha_leaves_and_views():
    need_cuda()
    y, x, _ = _fold_inputs(200, 1, 3)
    _check_fold(y[:, 0], x[:, 0], 0.25)               # a 1-D bias leaf
    _check_fold(y[0, 0], x[0, 0], 0.25)               # a 0-d leaf
    _check_fold(y, x, torch.tensor(0.5, device="cuda"))
    y, x, alpha = _fold_inputs(784, 64, 4)
    _check_fold(y.T, x.T, alpha[:64])                 # transposed views
    flat = torch.empty(y.numel() + 1, device="cuda")
    shifted = flat[1:].view(y.shape).copy_(y)          # scalar path
    assert shifted.data_ptr() % 16 != 0
    _check_fold(shifted, x, alpha)


def test_axpy_fold_kernel_nan_and_refusals():
    need_cuda()
    y, x, alpha = _fold_inputs(8, 40, 5)
    x[2, 3] = float("nan")
    alpha[2] = 0.0
    got = axpy_fold(y, x, alpha)
    want = axpy_fold_ref(y, x, alpha)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[2, 3]))
    with pytest.raises(ValueError, match="always takes the kernel"):
        axpy_fold(y, x, alpha, backend="ref")
    with pytest.raises(ValueError, match="alpha"):
        axpy_fold(y, x, alpha[:3])
    with pytest.raises(ValueError, match="is on cpu"):
        axpy_fold(y, x, alpha.cpu())


def test_axpy_fold_kernel_stochastic_rounding_to_bf16():
    """With a generator a bf16 fold is computed in fp32 and rounded
    stochastically: determinism under one seed, bf16 values as fixed
    points, and an unbiased mean over many draws."""
    need_cuda()
    y, x, alpha = _fold_inputs(64, 784, 6, torch.bfloat16)
    exact = axpy_fold_ref(y, x, alpha, out_dtype=torch.float32)

    def draw(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return axpy_fold(y, x, alpha, generator=gen)
    a, b = draw(1), draw(1)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not torch.equal(a, draw(2))
    one_ulp = 2.0 ** -7 * exact.abs() + 1e-30
    assert bool(((a.float() - exact).abs() <= one_ulp).all())
    zero = alpha == 0
    assert torch.equal(a[zero], y[zero])              # fixed points
    mean = torch.stack([draw(s).float() for s in range(64)]).mean(0)
    # unbiased: the mean of 64 draws is off by at most ulp / 16 standard
    # deviations (about 0.27 ulp at the largest of 50176 elements)
    assert bool(((mean - exact).abs() <= 0.5 * one_ulp).all())


# -------------------------------------------------------- axpy_fold_group --
#: (y shape, rate kind) of one grouped fold: the MLP's A and B sides at
#: r_max 64 (B in its own layout, "col"), a ragged width, a layered pair,
#: its biases at one rate ("value"), a 0-d rate ("first")
GROUP_SEGMENTS = [((64, 784), "row"), ((200, 64), "col"), ((64, 200), "row"),
                  ((200, 64), "col"), ((64, 10), "row"), ((10, 64), "col"),
                  ((33, 4099), "row"), ((3, 8, 12), "row2"),
                  ((3, 10, 8), "col"), ((200,), "value"), ((10,), "first"),
                  ((), "value")]


def _group_inputs(seed, dtype=torch.float32, x_dtype=None,
                  segments=GROUP_SEGMENTS):
    rng = np.random.default_rng(seed)
    ys, xs, alphas, cols = [], [], [], []
    for shape, kind in segments:
        ys.append(torch.as_tensor(rng.normal(size=shape).astype(
            np.float32)).to(dtype).cuda())
        xs.append(torch.as_tensor(rng.normal(size=shape).astype(
            np.float32)).to(x_dtype or dtype).cuda())
        if kind in ("value", "first"):
            a = np.float32(rng.uniform(0.05, 1.0))
            alphas.append(float(a) if kind == "value"
                          else torch.tensor(a, device="cuda"))
        else:
            ashape = {"row": shape[:1], "row2": shape[:2],
                      "col": shape[:-2] + shape[-1:]}[kind]
            a = rng.uniform(0.05, 1.0, ashape).astype(np.float32)
            a[rng.random(ashape) < 0.3] = 0.0
            alphas.append(torch.as_tensor(a).cuda())
        cols.append(kind == "col")
    return ys, xs, alphas, cols


def _check_group(ys, xs, alphas, cols, launches):
    before = [y.clone() for y in ys]
    runtime.reset_counts()
    got = axpy_fold_group(ys, xs, alphas, cols=cols)
    assert runtime.LAUNCHES["axpy_fold"] == launches
    assert runtime.PLAIN_CALLS["axpy_fold"] == 0
    want = axpy_fold_group_ref(ys, xs, alphas, cols=cols)
    torch.cuda.synchronize()
    for g, w, y, b in zip(got, want, ys, before):
        assert g.is_cuda and g.dtype == y.dtype and g.shape == y.shape
        assert torch.equal(y, b)                      # y is never written
        if y.dtype == torch.float32:
            assert torch.equal(g, w)
        else:                                         # one bf16 ulp
            ulp = 2.0 ** -7 * w.float().abs() + 1e-30
            assert bool(((g.float() - w.float()).abs() <= ulp).all())
    return got


@pytest.mark.parametrize("dtypes", [("f32", "f32"), ("bf16", "f32"),
                                    ("bf16", "bf16")])
def test_axpy_fold_group_kernel_matches_plain(dtypes):
    """A whole fold's segments in one launch, against the plain grouped
    fold: to the bit in fp32, within one bf16 ulp in bf16."""
    need_cuda()
    y_dtype, x_dtype = DTYPES[dtypes[0]], DTYPES[dtypes[1]]
    _check_group(*_group_inputs(1, y_dtype, x_dtype), launches=1)


def test_axpy_fold_group_kernel_splits_dtypes_and_takes_views():
    """A mixed fold launches once per dtype triple; a misaligned view takes
    the scalar path, a transposed one is copied first."""
    need_cuda()
    f32 = _group_inputs(2)
    bf = _group_inputs(3, torch.bfloat16, segments=GROUP_SEGMENTS[:3])
    flat = torch.empty(64 * 784 + 1, device="cuda")
    shifted = flat[1:].view(64, 784).copy_(f32[0][0])
    assert shifted.data_ptr() % 16 != 0
    ys = f32[0] + bf[0] + [shifted, f32[0][0].T]
    xs = f32[1] + bf[1] + [f32[1][0], f32[1][0].T]
    alphas = f32[2] + bf[2] + [f32[2][0], 0.25]
    cols = f32[3] + bf[3] + [False, False]
    _check_group(ys, xs, alphas, cols, launches=2)


def test_axpy_fold_group_kernel_device_table_and_no_host_sync():
    """Past the segments one launch carries in its parameters the table
    goes to the card by one async copy: still one launch, the same bits,
    and neither path synchronises with the host."""
    need_cuda()
    small = _group_inputs(4)
    big = _group_inputs(5, segments=GROUP_SEGMENTS * 4)
    assert len(big[0]) > 32
    _check_group(*small, launches=1)
    _check_group(*big, launches=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        axpy_fold_group(*small[:3], cols=small[3])
        axpy_fold_group(*big[:3], cols=big[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_axpy_fold_group_kernel_nan_and_refusals():
    need_cuda()
    ys, xs, alphas, cols = _group_inputs(6, segments=GROUP_SEGMENTS[:2])
    xs[1][5, 3] = float("nan")
    alphas[1][3] = 0.0
    got = axpy_fold_group(ys, xs, alphas, cols=cols)
    want = axpy_fold_group_ref(ys, xs, alphas, cols=cols)
    assert torch.equal(torch.isnan(got[1]), torch.isnan(want[1]))
    assert bool(torch.isnan(got[1][5, 3]))
    with pytest.raises(ValueError, match="always takes the kernel"):
        axpy_fold_group(ys, xs, alphas, cols=cols, backend="ref")
    with pytest.raises(ValueError, match="is on cpu"):
        axpy_fold_group(ys, xs, [alphas[0].cpu(), alphas[1]], cols=cols)
    with pytest.raises(ValueError, match="column-mode alpha"):
        axpy_fold_group(ys[1:], xs[1:], [alphas[0].new_zeros(200)],
                        cols=[True])


# ------------------------------------------- the async slice on the card --
def _fold_cohort(seed, n=4, layers=None, storage=8):
    """A state (adapters at ``storage`` rank rows) and ``n`` uploads."""
    from repro_torch.core.masks import pad_to_rank
    clients, ranks, weights, prev = _cohort(seed, n=n)
    prev = {k: dict(p, A=pad_to_rank(p["A"], -2, storage),
                    B=pad_to_rank(p["B"], -1, storage))
            for k, p in prev.items()}
    if layers:
        clients = [_layered(c, layers) for c in clients]
        prev = _layered(prev, layers)
    state = ts.ServerState(adapters=prev,
                           base_trainable={"b": torch.zeros(4)}, r_max=8)
    ups = [ts.ClientUpdate(adapters=c, base_trainable={"b": torch.randn(4)},
                           n_examples=float(w), rank=int(r))
           for c, w, r in zip(clients, weights, ranks)]
    return state, ups


def _to_cuda_state(state):
    cuda = lambda t: t.cuda()                                 # noqa: E731
    return ts.ServerState(adapters=tree_map(cuda, state.adapters),
                          base_trainable=tree_map(cuda, state.base_trainable),
                          r_max=state.r_max)


def _to_cuda_update(u):
    cuda = lambda t: t.cuda()                                 # noqa: E731
    return ts.ClientUpdate(adapters=tree_map(cuda, u.adapters),
                           base_trainable=tree_map(cuda, u.base_trainable),
                           n_examples=u.n_examples, rank=u.rank)


@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("name", ["rbla", "rbla_ranked", "fedavg", "zeropad",
                                  "flora"])
def test_fold_kernel_paths_match_ref(name, layers):
    """Every incremental strategy's fold on the card against its ref fold:
    the planned fold and the per-pair fold (the same bits), the default
    fold (packed_agg + axpy_fold) and flora's stack within its cap
    (axpy_fold for the base leaf); every fold is one grouped axpy_fold
    launch."""
    need_cuda()
    from repro_torch.tree import tree_leaves
    strat = ts.get_strategy(name)
    storage = 8
    if name == "flora":
        strat, storage = strat.with_options(stack_r_cap=64), 64
    state, ups = _fold_cohort(2, layers=layers, storage=storage)
    want, fs = state, strat.init_fold(state)
    for u in ups:
        want, fs = strat.fold(want, u, fold_state=fs, backend="ref")
    cstate = _to_cuda_state(state)
    # the rbla family can decline its packed path (two launches a pair)
    declines = ({}, {"use_plan": False}) if isinstance(
        strat, ts.RBLAStrategy) else ({},)
    for decline in declines:
        use_plan = not decline
        runtime.reset_counts()
        got, fs = cstate, strat.init_fold(cstate)
        for u in ups:
            got, fs = strat.fold(got, _to_cuda_update(u), fold_state=fs,
                                 **decline)
        torch.cuda.synchronize()
        assert not any(runtime.PLAIN_CALLS.values()), runtime.PLAIN_CALLS
        assert runtime.LAUNCHES["axpy_fold"] > 0
        for a, b in zip(tree_leaves((got.adapters, got.base_trainable)),
                        tree_leaves((want.adapters, want.base_trainable))):
            assert a.is_cuda
            if a.is_floating_point():
                assert_close(a, b)
            else:
                assert torch.equal(a.cpu(), b)
        if name == "rbla" and not layers:
            # one grouped launch per fold: every leaf is fp32
            assert runtime.LAUNCHES["axpy_fold"] == len(ups)


def test_fold_never_writes_the_state_on_the_card():
    need_cuda()
    state, ups = _fold_cohort(3)
    cstate = _to_cuda_state(state)
    before = tree_map(torch.clone, cstate.adapters)
    strat = ts.get_strategy("rbla")
    for use_plan in (True, False):
        a, _ = strat.fold(cstate, _to_cuda_update(ups[0]), use_plan=use_plan)
        strat.fold(cstate, _to_cuda_update(ups[1]), use_plan=use_plan)
    torch.cuda.synchronize()
    from repro_torch.tree import tree_leaves
    for x, y in zip(tree_leaves(before), tree_leaves(cstate.adapters)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mix", ["int8", "bf16", "mixed"])
@pytest.mark.parametrize("name", ["rbla", "zeropad", "rbla_norm",
                                  "rbla_trimmed"])
def test_encoded_plan_kernel_matches_ref(name, mix):
    """An encoded cohort on the card: one grouped kernel launch a round,
    each upload read in its wire dtype with the int8 scales dequantised in
    the kernel, against the ref plan."""
    need_cuda()
    from repro_torch.core import codec as tcodec
    clients, ranks, weights, prev = _cohort(4)
    codecs = {"int8": ["int8"] * 5, "bf16": ["bf16"] * 5,
              "mixed": ["int8", "bf16", "none", "int8", "bf16"]}[mix]
    enc = [tcodec.encode_adapters(c, k) for c, k in zip(clients, codecs)]
    strat = ts.get_strategy(name)
    want = strat.aggregate_adapters(enc, weights, r_max=8, prev_global=prev,
                                    backend="ref")
    cuda = lambda t: t.cuda()                                 # noqa: E731
    runtime.reset_counts()
    got = strat.aggregate_adapters([tree_map(cuda, e) for e in enc],
                                   weights.cuda(), r_max=8,
                                   prev_global=tree_map(cuda, prev))
    torch.cuda.synchronize()
    kernel = "packed_robust" if name == "rbla_trimmed" else "packed_agg"
    assert runtime.LAUNCHES[kernel] == 1
    assert not any(runtime.PLAIN_CALLS.values())
    for k in want:
        for side in ("A", "B"):
            assert_close(got[k][side], want[k][side])


@pytest.mark.parametrize("buffer_size", [1, 3])
def test_async_service_on_the_card_matches_ref(buffer_size):
    need_cuda()
    from repro_torch.fl import AsyncAggregator
    state, ups = _fold_cohort(5, n=5)
    kw = dict(buffer_size=buffer_size, staleness="polynomial",
              server_momentum=0.5)
    want = AsyncAggregator("rbla", state, backend="ref", **kw)
    got = AsyncAggregator("rbla", _to_cuda_state(state), **kw)
    for i, u in enumerate(ups):
        want.submit(u, model_version=max(0, want.version - 1))
        got.submit(_to_cuda_update(u), model_version=max(0, got.version - 1))
    got.flush()
    want.flush()
    torch.cuda.synchronize()
    assert got.version == want.version
    for k in want.state.adapters:
        for side in ("A", "B"):
            assert_close(got.state.adapters[k][side],
                         want.state.adapters[k][side])


def test_async_simulation_kernel_folds_match_plain_folds():
    need_cuda()
    from repro_torch.fl import AsyncFLConfig, run_async_simulation
    kw = dict(n_clients=4, n_per_class=20, n_test_per_class=10,
              batch_size=16, lr=0.01, r_max=8, total_updates=8,
              eval_every=4)
    runtime.reset_counts()
    got = run_async_simulation(AsyncFLConfig(**kw))
    assert runtime.LAUNCHES["axpy_fold"] == 8             # one a fold
    assert not any(runtime.PLAIN_CALLS.values())
    want = run_async_simulation(AsyncFLConfig(agg_backend="ref", **kw))
    assert got.test_acc == want.test_acc
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-5)


# --------------------------------------------------------- durable service --
def test_checkpoint_roundtrips_card_tensors_and_a_cuda_generator(tmp_path):
    """fp32, bf16 and int8 card tensors and a CUDA generator's state through
    save/restore and the blob codec: back on the card, bit for bit, and
    the restored generator draws the same stream."""
    need_cuda()
    from repro_torch.checkpoint import (GeneratorState, load_blob, restore,
                                        save, save_blob)
    gen = torch.Generator(device="cuda").manual_seed(11)
    torch.rand(7, device="cuda", generator=gen)     # move the offset
    tree = {"f32": torch.randn(64, 200, device="cuda"),
            "bf16": torch.randn(200, 64, device="cuda").bfloat16(),
            "i8": torch.randint(-127, 128, (64, 10), device="cuda",
                                dtype=torch.int8),
            "rank": torch.tensor(6, dtype=torch.int32, device="cuda"),
            "gen": gen, "n": 3}
    save(str(tmp_path / "ck"), tree)
    back = restore(str(tmp_path / "ck"), tree)
    save_blob(str(tmp_path / "b.bin"), tree)
    blob = load_blob(str(tmp_path / "b.bin"))
    for k in ("f32", "bf16", "i8", "rank"):
        assert back[k].is_cuda and back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k]), k
        assert torch.equal(blob[k].cuda(), tree[k]), k
    assert back["n"] == 3 and isinstance(blob["gen"], GeneratorState)
    assert back["gen"].device.type == "cuda"
    ref = torch.Generator(device="cuda").manual_seed(11)
    torch.rand(7, device="cuda", generator=ref)
    want = torch.rand(5, device="cuda", generator=ref)
    for g in (back["gen"], blob["gen"].generator("cuda")):
        assert torch.equal(torch.rand(5, device="cuda", generator=g), want)


def test_durable_recovery_on_the_card_is_bit_identical(tmp_path):
    """bf16 accumulators stochastically rounded from the card's generator,
    momentum and a buffer: crash after 4 uploads, recover from the
    checkpoint and WAL on the card, finish -- bit for bit the run that
    never crashed; the replay folds with the kernels, no plain call."""
    need_cuda()
    from repro_torch.fl import AsyncAggregator, DurableAggregator
    state, ups = _fold_cohort(9, n=7)
    state, ups = _to_cuda_state(state), [_to_cuda_update(u) for u in ups]
    kw = dict(accum_dtype="bfloat16", seed=5, server_momentum=0.5)
    for buffer_size in (1, 2):
        d = str(tmp_path / f"b{buffer_size}")
        oracle = AsyncAggregator("rbla", state, buffer_size=buffer_size,
                                 **kw)
        first = DurableAggregator("rbla", state, dir=d, checkpoint_every=3,
                                  wal_fsync=False, buffer_size=buffer_size,
                                  **kw)
        for i, u in enumerate(ups[:4]):
            oracle.submit(u, now=float(i), update_id=f"u{i}")
            first.submit(u, now=float(i), update_id=f"u{i}")
        first.close()
        runtime.reset_counts()
        second = DurableAggregator("rbla", state, dir=d, checkpoint_every=3,
                                   wal_fsync=False, buffer_size=buffer_size,
                                   **kw)
        torch.cuda.synchronize()
        assert second.n_replayed == 1
        assert not any(runtime.PLAIN_CALLS.values())
        # the WAL tail is one upload: one fold, or the flush it completes
        kernel = "axpy_fold" if buffer_size == 1 else "packed_agg"
        assert runtime.LAUNCHES[kernel] == 1
        for i, u in enumerate(ups[4:], start=4):
            oracle.submit(u, now=float(i), update_id=f"u{i}")
            second.submit(u, now=float(i), update_id=f"u{i}")
        oracle.flush(now=9.0)
        second.flush(now=9.0)
        torch.cuda.synchronize()
        assert second.state.adapters["fc1"]["A"].dtype == torch.bfloat16
        for k in oracle.state.adapters:
            for side in ("A", "B"):
                got = second.state.adapters[k][side]
                assert got.is_cuda
                assert torch.equal(got, oracle.state.adapters[k][side])
        assert torch.equal(second.state.base_trainable["b"],
                           oracle.state.base_trainable["b"])
        assert torch.equal(second._generator.get_state(),
                           oracle._generator.get_state())
        second.close()


def test_snapshot_reads_the_card_on_the_service_stream():
    """The stream rule for snapshots: a fold held back on the service's
    stream by a sleep, then ``state_dict()`` requested at once from a
    side stream -- the snapshot still reads the folded values."""
    need_cuda()
    from repro_torch.fl import AsyncAggregator
    state, ups = _fold_cohort(4, n=2)
    agg = AsyncAggregator("rbla", _to_cuda_state(state))
    agg.submit(_to_cuda_update(ups[0]))
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)                  # the service's stream
    agg.submit(_to_cuda_update(ups[1]))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        sd = agg.state_dict()
    torch.cuda.synchronize()
    for k, pair in agg.state.adapters.items():
        for side_name in ("A", "B"):
            got = sd["state"]["adapters"][k][side_name]
            assert got.device.type == "cpu"
            assert torch.equal(got, pair[side_name].cpu()), (k, side_name)
    assert torch.equal(sd["state"]["base_trainable"]["b"],
                       agg.state.base_trainable["b"].cpu())


# ------------------------------------------------------------ lora_matmul --
LORA_WIDTHS = (10, 200, 784, 512)
SLEEP_CYCLES = 300_000_000          # ~0.15 s at the H100's boost clock


def _serve_case(m, k, n, dtype, seed, slots=11, r_max=64):
    """Packed buffers with a null slot and an evicted slot (rank 0), ids
    naming every slot but one, and NaN/Inf in every row outside the live
    segments; all on the card."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    a_rows = rng.normal(size=(slots * r_max, k)).astype(np.float32)
    b_rows = rng.normal(size=(slots * r_max, n)).astype(np.float32)
    off = (np.arange(slots) * r_max).astype(np.int32)
    rank = rng.integers(1, r_max + 1, slots).astype(np.int32)
    rank[0] = rank[3] = 0
    scale = (16.0 / np.maximum(rank, 1)).astype(np.float32)
    ids = rng.integers(0, slots - 1, m).astype(np.int32)   # slot 10 unused
    live = np.zeros(slots * r_max, bool)
    for t in np.unique(ids):
        live[off[t]:off[t] + rank[t]] = True
    a_rows[~live] = np.nan
    b_rows[~live] = np.inf
    b_rows[np.flatnonzero(~live)[::2]] = np.nan
    td = DTYPES[dtype]
    return tuple(torch.as_tensor(v).to(td).cuda()
                 for v in (x, w, a_rows, b_rows)) + tuple(
        torch.as_tensor(v).cuda() for v in (ids, off, rank, scale))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", LORA_WIDTHS)
@pytest.mark.parametrize("k", LORA_WIDTHS)
def test_batched_lora_matmul_kernel_matches_plain(k, n, dtype):
    from repro_torch.kernels.lora_matmul import (batched_lora_matmul,
                                                 batched_lora_matmul_ref,
                                                 batched_lora_matmul_segments)
    need_cuda()
    x, w, a_rows, b_rows, ids, off, rank, scale = _serve_case(
        37, k, n, dtype, k + n)
    runtime.reset_counts()
    got = batched_lora_matmul(x, w, a_rows, b_rows, ids, off, rank, scale)
    assert runtime.LAUNCHES["batched_lora_matmul"] == 1
    assert not any(runtime.PLAIN_CALLS.values())
    idx = ids.long()
    seg = (off[idx], rank[idx], scale[idx])
    want = batched_lora_matmul_segments(x, w, a_rows, b_rows, *seg)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and torch.isfinite(got.float()).all()
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    assert_close(got, want, tol)
    assert_close(got, batched_lora_matmul_ref(x, w, a_rows, b_rows, *seg),
                 tol)
    base = (x.float() @ w.float()).to(x.dtype)
    zero = rank[idx] == 0
    assert_close(got[zero], base[zero], tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 8, 64])
@pytest.mark.parametrize("k,n", [(784, 200), (200, 200), (200, 10),
                                 (512, 512), (10, 784)])
def test_lora_matmul_kernel_matches_plain(k, n, r, dtype):
    from repro_torch.kernels.lora_matmul import (lora_dense_apply,
                                                 lora_matmul, lora_matmul_ref)
    need_cuda()
    rng = np.random.default_rng(k * n + r)
    td = DTYPES[dtype]
    x, w, a, b = (torch.as_tensor(v.astype(np.float32)).to(td).cuda()
                  for v in (rng.normal(size=(3, 41, k)),
                            rng.normal(size=(k, n)) / np.sqrt(k),
                            rng.normal(size=(r, k)), rng.normal(size=(n, r))))
    scale = torch.tensor(16.0 / r, device="cuda")
    runtime.reset_counts()
    got = lora_matmul(x, w, a, b, scale)
    assert runtime.LAUNCHES["lora_matmul"] == 1
    want = lora_matmul_ref(x.reshape(-1, k), w, a, b, scale).reshape(
        3, 41, n)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    assert got.shape == (3, 41, n) and got.dtype == x.dtype
    assert_close(got, want, tol)
    pair = {"A": a, "B": b, "rank": torch.tensor(r, device="cuda")}
    p = {"w": w, "b": torch.ones(n, device="cuda").to(td)}
    assert_close(lora_dense_apply(p, x, pair), want.float() + 1.0, tol)


#: (label, m, k, n, slots, r_max): bench_serve's case, the MLP's three
#: layers at its test set, ragged edges under both tile shapes (K not a
#: multiple of bf16's 16-byte vector, N and M of neither tile), and 4096^3
LORA_SHAPES = [("serve", 512, 512, 512, 128, 8),
               ("mlp fc1", 500, 784, 200, 11, 64),
               ("mlp fc2", 500, 200, 200, 11, 64),
               ("mlp out", 500, 200, 10, 11, 64),
               ("ragged small", 333, 300, 136, 11, 64),
               ("ragged large", 1500, 520, 1544, 16, 64),
               ("large", 4096, 4096, 4096, 32, 64)]


def _tenant_case(m, k, n, dtype, seed, slots, r_max):
    """Packed buffers with rank-0 slots 0 and 3, ids that also leave the
    tables (-1 names the last slot, counted from the end; -slots - 3 and
    slots + 5 clamp to the ends), and NaN/Inf in every row outside the
    segments the resolved ids name; all on the card."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    a_rows = rng.normal(size=(slots * r_max, k)).astype(np.float32)
    b_rows = rng.normal(size=(slots * r_max, n)).astype(np.float32)
    off = (np.arange(slots) * r_max).astype(np.int32)
    rank = rng.integers(1, r_max + 1, slots).astype(np.int32)
    rank[0] = rank[3] = 0
    scale = (16.0 / np.maximum(rank, 1)).astype(np.float32)
    ids = rng.integers(0, slots, m).astype(np.int32)
    wild = np.array([-1, -slots - 3, slots, slots + 5], np.int32)
    ids[::7] = wild[np.arange(len(ids[::7])) % len(wild)]
    resolved = np.clip(np.where(ids < 0, ids + slots, ids), 0, slots - 1)
    live = np.zeros(slots * r_max, bool)
    for t in np.unique(resolved):
        live[off[t]:off[t] + rank[t]] = True
    a_rows[~live] = np.nan
    b_rows[~live] = np.inf
    b_rows[np.flatnonzero(~live)[::2]] = np.nan
    td = DTYPES[dtype]
    return tuple(torch.as_tensor(v).to(td).cuda()
                 for v in (x, w, a_rows, b_rows)) + tuple(
        torch.as_tensor(v).cuda() for v in (ids, off, rank, scale))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("label,m,k,n,slots,r_max", LORA_SHAPES)
def test_batched_lora_matmul_kernel_at_serving_shapes(label, m, k, n, slots,
                                                      r_max, dtype):
    """The kernel resolves ids in its blocks: out-of-range ids, rank-0
    tenants and NaN/Inf outside the live segments, at every tile shape,
    against the segment lowering on resolve_segments' gather; one
    launch a call."""
    from repro_torch.kernels.lora_matmul import (batched_lora_matmul,
                                                 batched_lora_matmul_segments,
                                                 resolve_segments)
    need_cuda()
    x, w, a_rows, b_rows, ids, off, rank, scale = _tenant_case(
        m, k, n, dtype, m + k + n, slots, r_max)
    runtime.reset_counts()
    got = batched_lora_matmul(x, w, a_rows, b_rows, ids, off, rank, scale)
    assert runtime.LAUNCHES["batched_lora_matmul"] == 1
    assert not any(runtime.PLAIN_CALLS.values())
    seg = resolve_segments(ids, off, rank, scale)
    want = batched_lora_matmul_segments(x, w, a_rows, b_rows, *seg)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and torch.isfinite(got.float()).all()
    assert_close(got, want, BF16_TOL if dtype == "bf16" else F32_TOL, label)
    zero = seg[1] == 0
    assert zero.any()
    assert_close(got[zero], (x[zero].float() @ w.float()).to(x.dtype),
                 BF16_TOL if dtype == "bf16" else F32_TOL, "rank 0")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n,r", [(4096, 4096, 4096, 64),
                                     (1500, 520, 1544, 8)])
def test_lora_matmul_kernel_on_the_tensor_core_body(m, k, n, r, dtype):
    """lora_matmul at the large and ragged large shapes, which take the
    128 x 128 tiles, against lora_matmul_ref."""
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    need_cuda()
    rng = np.random.default_rng(m + r)
    td = DTYPES[dtype]
    x, w, a, b = (torch.as_tensor(v.astype(np.float32)).to(td).cuda()
                  for v in (rng.normal(size=(m, k)),
                            rng.normal(size=(k, n)) / np.sqrt(k),
                            rng.normal(size=(r, k)), rng.normal(size=(n, r))))
    scale = torch.tensor(16.0 / r, device="cuda")
    runtime.reset_counts()
    got = lora_matmul(x, w, a, b, scale)
    assert runtime.LAUNCHES["lora_matmul"] == 1
    want = lora_matmul_ref(x, w, a, b, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert_close(got, want, BF16_TOL if dtype == "bf16" else F32_TOL)


def _off_by_one_element(t):
    """``t``'s values in a contiguous view one element into a larger
    buffer: for fp32 and bf16, an address off 16-byte alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
    out = flat[1:].view(t.shape).copy_(t)
    assert out.is_contiguous() and (out.data_ptr() % 16 or not t.numel())
    return out


@pytest.mark.parametrize("k", [520, 37])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [10, 200, 1544])
@pytest.mark.parametrize("r", [0, 1, 7, 64])
def test_lora_matmul_single_kernel_at_ranks_and_widths(r, n, dtype,
                                                       misaligned, k):
    """The single-adapter kernel (u = s x A^T on the tensor cores, K split
    where its tiles leave SMs idle, then u B^T as more depth of the GEMM)
    at rank 0 (no down launch, no tail), ragged rank chunks (1, 7) and two
    chunks (64), N of neither tile, K = 520 (not a multiple of 16) and 37
    (odd: x's element-wise loads in bf16), and B one element off alignment
    (its scalar staging path), against lora_matmul_ref within 2e-5 (fp32)
    and 2e-2 (bf16) of max|y|; one launch counted."""
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    need_cuda()
    rng = np.random.default_rng(r * 7 + n + k)
    td = DTYPES[dtype]
    x, w, a, b = (torch.as_tensor(v.astype(np.float32)).to(td).cuda()
                  for v in (rng.normal(size=(300, k)),
                            rng.normal(size=(k, n)) / np.sqrt(k),
                            rng.normal(size=(r, k)), rng.normal(size=(n, r))))
    if misaligned:
        b = _off_by_one_element(b)
    scale = torch.tensor(16.0 / max(r, 1), device="cuda")
    runtime.reset_counts()
    got = lora_matmul(x, w, a, b, scale)
    assert runtime.LAUNCHES["lora_matmul"] == 1
    assert not any(runtime.PLAIN_CALLS.values())
    want = lora_matmul_ref(x, w, a, b, scale)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and torch.isfinite(got.float()).all()
    assert_close(got, want, BF16_TOL if dtype == "bf16" else F32_TOL,
                 f"r={r} n={n}")


def test_lora_matmul_card_path_makes_only_its_outputs():
    """With a 0-d fp32 scale on the card the wrapper makes no small kernel:
    the only PyTorch operations of a call are its two allocations (the
    scratch u and y) and views."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels.lora_matmul import lora_matmul
    need_cuda()
    rng = np.random.default_rng(5)
    x, w, a, b = (torch.as_tensor(v.astype(np.float32)).cuda()
                  for v in (rng.normal(size=(4, 16, 200)),
                            rng.normal(size=(200, 10)),
                            rng.normal(size=(8, 200)),
                            rng.normal(size=(10, 8))))
    scale = torch.tensor(2.0, device="cuda")
    lora_matmul(x, w, a, b, scale)                  # build and load first

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Ops() as ops:
        lora_matmul(x, w, a, b, scale)
    assert ops.names.count("empty") == 2, ops.names
    assert set(ops.names) <= {"empty", "view", "_unsafe_view"}, ops.names


def test_batched_lora_matmul_card_path_makes_only_its_outputs():
    """With int32 ids and tables and fp32 scales the wrapper passes them
    as they are: the only PyTorch operations of a call are the two
    allocations (the scratch u and y) and views; no clamp, gather or
    cast runs on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels.lora_matmul import batched_lora_matmul
    need_cuda()
    case = _tenant_case(64, 512, 512, "f32", 3, 16, 8)
    batched_lora_matmul(*case)                      # build and load first

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Ops() as ops:
        batched_lora_matmul(case[0].reshape(4, 16, 512), *case[1:4],
                            case[4].reshape(4, 16), *case[5:])
    assert ops.names.count("empty") == 2, ops.names
    assert set(ops.names) <= {"empty", "view", "_unsafe_view"}, ops.names


def test_batched_lora_matmul_makes_no_host_sync():
    """Ids, offsets, counts and scales stay on the card: neither the
    wrapper nor the engine's apply synchronises with the host."""
    from repro_torch.kernels.lora_matmul import batched_lora_matmul
    need_cuda()
    case = _serve_case(64, 512, 512, "f32", 1)
    store, engine, x, ids, _ = _serving_rig()
    batched_lora_matmul(*case[:4], *case[4:])       # build and load first
    engine.apply("proj", x, ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batched_lora_matmul(*case[:4], *case[4:])
        engine.apply("proj", x, ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_lora_kernels_raise_rather_than_fall_back():
    from repro_torch.kernels.lora_matmul import (batched_lora_matmul,
                                                 lora_matmul)
    need_cuda()
    x, w, a_rows, b_rows, ids, off, rank, scale = _serve_case(
        8, 200, 200, "f32", 2)
    tables = (ids, off, rank, scale)
    with pytest.raises(TypeError, match="dtype"):
        batched_lora_matmul(x.half(), w.half(), a_rows.half(),
                            b_rows.half(), *tables)
    with pytest.raises(TypeError, match="one dtype"):
        batched_lora_matmul(x, w.bfloat16(), a_rows, b_rows, *tables)
    with pytest.raises(ValueError, match="contiguous"):
        batched_lora_matmul(x, w.T, a_rows, b_rows, *tables)
    with pytest.raises(ValueError, match="contiguous"):
        batched_lora_matmul(x.T.contiguous().T, w, a_rows, b_rows, *tables)
    with pytest.raises(ValueError, match="always takes the kernel"):
        batched_lora_matmul(x, w, a_rows, b_rows, *tables, impl="xla")
    with pytest.raises(ValueError, match="no hidden transfer"):
        batched_lora_matmul(x, w, a_rows, b_rows, ids.cpu(), off, rank,
                            scale)
    with pytest.raises(ValueError, match="contiguous"):
        lora_matmul(x, w, a_rows[:4], b_rows[:4].T, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        lora_matmul(x.double(), w.double(), a_rows[:4].double(),
                    b_rows[:4].T.contiguous().double(), 1.0)


# ------------------------------------------------- serving and the stream rule --
def _serving_rig(n_tenants=16, width=512, r_max=8, batch=256, seed=0):
    """A store whose pages are all taken (the next registration grows
    it), an engine, a mixed batch on the card, and a second global with
    host rank leaves (so publishing it reads no rank back from the card)."""
    from repro_torch.serving import AdapterStore, ServingEngine
    rng = np.random.default_rng(seed)
    specs = {"proj": (width, width)}
    store = AdapterStore(specs, r_max=r_max, init_pages=n_tenants,
                         init_tenant_capacity=2 * n_tenants)
    w = torch.as_tensor(rng.normal(size=(width, width)) * 0.05,
                        dtype=torch.float32).cuda()
    engine = ServingEngine({"proj": w}, store)
    for t in range(n_tenants):
        store.register(f"t{t}", rank=int(rng.integers(1, r_max + 1)))

    def glob(s):
        g = np.random.default_rng(s)
        return {"proj": {
            "A": torch.as_tensor(g.normal(size=(r_max, width)),
                                 dtype=torch.float32).cuda(),
            "B": torch.as_tensor(g.normal(size=(width, r_max)),
                                 dtype=torch.float32).cuda(),
            "rank": torch.tensor(r_max, dtype=torch.int32)}}
    engine.publish(glob(seed + 1))
    x = torch.as_tensor(rng.normal(size=(batch, width)),
                        dtype=torch.float32).cuda()
    ids = torch.as_tensor(rng.integers(1, n_tenants + 1, batch),
                          dtype=torch.int32).cuda()
    return store, engine, x, ids, glob


def _buffer_ptr(store):
    snap = store.snapshot()
    return snap.pair_buffers("proj")[0].data_ptr()


def test_stream_rule_write_after_read():
    """A batch queued on a side stream (held back by a sleep), its
    snapshot dropped, then an in-place publish on the default stream: the
    publish waits for the batch, which reads the old version bit for bit."""
    need_cuda()
    store, engine, x, ids, glob = _serving_rig()
    ref = engine.apply("proj", x, ids)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        y = engine.apply("proj", x, ids)
    ptr = _buffer_ptr(store)
    assert store.pinned_snapshots == 0
    engine.publish(glob(7))
    assert _buffer_ptr(store) == ptr            # written in place
    torch.cuda.synchronize()
    assert torch.equal(y, ref)
    assert not torch.equal(engine.apply("proj", x, ids), ref)


def test_stream_rule_read_after_write():
    """A publish held back on the default stream, then a batch on a side
    stream with a fresh snapshot: the batch waits and sees the new
    version."""
    from repro_torch.serving import merged_reference
    need_cuda()
    store, engine, x, ids, glob = _serving_rig()
    old = engine.apply("proj", x, ids)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    engine.publish(glob(7))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = engine.apply("proj", x, ids)
    torch.cuda.synchronize()
    want = merged_reference(engine, "proj", x, ids)
    assert_close(y, want)
    assert not torch.allclose(y, old)


def test_stream_rule_free_while_read():
    """A batch on a side stream (held back), its snapshot dropped, then
    capacity growth replaces the buffers it reads and fresh allocations
    on the default stream are filled with NaN: the old buffers are not
    handed out while the batch reads them, and it reads the old version
    bit for bit."""
    need_cuda()
    store, engine, x, ids, glob = _serving_rig()
    ref = engine.apply("proj", x, ids)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        y = engine.apply("proj", x, ids)
    shape = store.snapshot().pair_buffers("proj")[0].shape
    ptr = _buffer_ptr(store)
    store.register("grows", rank=4)             # the free list was empty
    assert _buffer_ptr(store) != ptr
    junk = [torch.full(shape, float("nan"), device="cuda") for _ in range(8)]
    engine.publish(glob(9))
    torch.cuda.synchronize()
    assert torch.equal(y, ref)
    del junk


# ---------------------------------------------------------------- ssd_scan --
# (b, l, h, p, n, chunk, dta scale): tests/test_kernels.py's SSD_SHAPES, one
# mamba2-1.3b layer at batch 1, L = 2000 (Q 250), a prime L (Q 1), and a
# decay that takes a_cs past -100 within a chunk
SSD_CASES = [
    (1, 32, 2, 8, 16, 8, 0.5),
    (2, 64, 4, 16, 32, 16, 0.5),
    (1, 128, 2, 64, 128, 32, 0.5),
    (2, 48, 3, 8, 8, 16, 0.5),
    (1, 2048, 64, 64, 128, 256, 0.05),
    (1, 2000, 8, 64, 128, 256, 0.05),
    (2, 127, 3, 16, 32, 32, 0.5),
    (1, 512, 4, 64, 128, 256, 8.0),
]


def _ssd_inputs(b, l, h, p, n, scale, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xdt = torch.randn(b, l, h, p, generator=gen, device="cuda") * 0.5
    dta = -torch.randn(b, l, h, generator=gen, device="cuda").abs() * scale
    bm = torch.randn(b, l, n, generator=gen, device="cuda") * 0.5
    cm = torch.randn(b, l, n, generator=gen, device="cuda") * 0.5
    return xdt, dta, bm, cm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk,scale", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(b, l, h, p, n, chunk, scale, dtype):
    """fp32 within the reference's 2e-3 of max|want|; bf16 operands
    against the plain version on their fp32 upcast within 2e-2."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    need_cuda()
    xdt, dta, bm, cm = _ssd_inputs(b, l, h, p, n, scale, l + h)
    if dtype == "bf16":
        xdt, bm, cm = xdt.bfloat16(), bm.bfloat16(), cm.bfloat16()
    runtime.reset_counts()
    y, hl = ssd_scan(xdt, dta, bm, cm, chunk)
    assert runtime.LAUNCHES["ssd_scan"] == 1
    want_y, want_h = ssd_scan_ref(xdt.float(), dta, bm.float(), cm.float(),
                                  chunk)
    torch.cuda.synchronize()
    assert y.dtype == xdt.dtype and hl.dtype == xdt.dtype
    assert hl.shape == (b, h, p, n)
    assert torch.isfinite(y.float()).all() and torch.isfinite(hl.float()).all()
    tol = BF16_TOL if dtype == "bf16" else 2e-3
    assert_close(y, want_y, tol, "y")
    assert_close(hl, want_h, tol, "h_final")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_kernel_at_mamba_batch_4(dtype):
    """The main path's shape (one mamba2-1.3b layer of a batch-4 prefill,
    L 2048, Q 256): one launch, fp32 within 2e-3 of max|want|, bf16
    against the fp32-upcast plain version within 2e-2."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    need_cuda()
    xdt, dta, bm, cm = _ssd_inputs(4, 2048, 64, 64, 128, 0.7, 4)
    if dtype == "bf16":
        xdt, bm, cm = xdt.bfloat16(), bm.bfloat16(), cm.bfloat16()
    runtime.reset_counts()
    y, hl = ssd_scan(xdt, dta, bm, cm, 256)
    assert runtime.LAUNCHES["ssd_scan"] == 1
    want_y, want_h = ssd_scan_ref(xdt.float(), dta, bm.float(), cm.float(),
                                  256)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == "bf16" else 2e-3
    assert_close(y, want_y, tol, "y")
    assert_close(hl, want_h, tol, "h_final")


def test_ssd_scan_raises_rather_than_falls_back():
    from repro_torch.kernels.ssd_scan import ssd_scan
    need_cuda()
    xdt, dta, bm, cm = _ssd_inputs(1, 64, 2, 16, 32, 0.5, 0)
    with pytest.raises(ValueError, match="always takes the kernel"):
        ssd_scan(xdt, dta, bm, cm, 16, backend="ref")
    with pytest.raises(TypeError, match="dta"):
        ssd_scan(xdt, dta.bfloat16(), bm, cm, 16)
    with pytest.raises(TypeError, match="bm"):
        ssd_scan(xdt, dta, bm.bfloat16(), cm, 16)
    with pytest.raises(TypeError, match="dtype"):
        ssd_scan(xdt.half(), dta, bm.half(), cm.half(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xdt, dta, bm.transpose(1, 2).contiguous().transpose(1, 2),
                 cm, 16)
    with pytest.raises(ValueError, match="is on"):
        ssd_scan(xdt, dta, bm.cpu(), cm, 16)


def _reduced_mamba(layers=2):
    from repro_torch.configs import BlockSpec, Stage, get_config
    from repro_torch.models.model import make_model
    cfg = get_config("mamba2-1.3b").reduced(stages=(Stage(
        unit=(BlockSpec(kind="mamba", ffn="none"),), repeat=layers),))
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    adapters = model.init_adapters(
        torch.Generator(device="cuda").manual_seed(1), rank=4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(2))
    return cfg, model, params, adapters, tokens


def test_reduced_prefill_on_the_card_launches_once_a_layer():
    from repro_torch.models.model import make_model
    need_cuda()
    cfg, model, params, adapters, tokens = _reduced_mamba()
    runtime.reset_counts()
    last, caches = model.prefill(params, adapters, {"tokens": tokens})
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["ssd_scan"] == 2
    assert runtime.PLAIN_CALLS["ssd_scan"] == 0
    assert last.shape == (2, cfg.vocab_size) and torch.isfinite(last).all()
    ref = make_model(cfg, remat=False, scan_backend="ref")
    want, want_caches = ref.prefill(params, adapters, {"tokens": tokens})
    assert runtime.LAUNCHES["ssd_scan"] == 2
    assert runtime.PLAIN_CALLS["ssd_scan"] == 2
    assert_close(last, want, 2e-3, "prefill logits")
    assert_close(caches[0]["b0"]["ssm"], want_caches[0]["b0"]["ssm"], 2e-3,
                 "ssm cache")


def test_prefill_makes_no_host_sync():
    """Neither the scan's wrapper nor a whole reduced prefill on the card
    synchronises with the host."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    need_cuda()
    xdt, dta, bm, cm = _ssd_inputs(1, 256, 8, 64, 128, 0.5, 3)
    _, model, params, adapters, tokens = _reduced_mamba()
    ssd_scan(xdt, dta, bm, cm, 256)                 # build and load first
    model.prefill(params, adapters, {"tokens": tokens})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ssd_scan(xdt, dta, bm, cm, 256)
        model.prefill(params, adapters, {"tokens": tokens})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ------------------------------------------------------------ distributed --
DIST_CHILD = Path(__file__).resolve().parent / "_dist_child.py"


def _dist_world(tmp_path, cases, world, backend):
    """Run ``cases`` in ``world`` ranks of ``tests/_dist_child.py`` on
    ``cuda:0`` (a ``FileStore`` under ``tmp_path``, 120 s a rank); returns
    each rank's ``(arrays, meta)``."""
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    procs = [subprocess.Popen(
        [sys.executable, str(DIST_CHILD), str(tmp_path / "inputs.pkl"),
         str(tmp_path / "store"), str(k), str(world),
         str(tmp_path / f"out{k}.npz"), backend, "cuda:0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(world)]
    errs = []
    try:
        for k, p in enumerate(procs):
            _, err = p.communicate(timeout=120)
            if p.returncode:
                errs.append(f"rank {k} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, "\n".join(errs)
    outs = []
    for k in range(world):
        with open(tmp_path / f"out{k}.npz.meta", "rb") as f:
            outs.append((dict(np.load(tmp_path / f"out{k}.npz")),
                         pickle.load(f)))
    return outs


def _dist_case(name, method, seed, **options):
    clients, ranks, weights, prev = _cohort(seed, n=6)
    as_np = lambda t: t.numpy()                               # noqa: E731
    return dict(name=name, kind="agg", method=method, options=options,
                adapters=[tree_map(as_np, c) for c in clients],
                weights=weights.numpy(), ranks=ranks.numpy(), r_max=8,
                prev=tree_map(as_np, prev) if method == "rbla" else None)


def _dist_want(case):
    """The case's round on the kernel path in this process."""
    cuda = lambda t: torch.as_tensor(t).cuda()                # noqa: E731
    strat = ts.get_strategy(case["method"]).with_options(**case["options"])
    return strat.aggregate_adapters(
        [tree_map(cuda, a) for a in case["adapters"]],
        cuda(case["weights"]), r_max=8, client_ranks=cuda(case["ranks"]),
        prev_global=(None if case["prev"] is None
                     else tree_map(cuda, case["prev"])), backend="kernel")


def _dist_check(arrays, case, want, products):
    for k in want:
        got = {f: arrays[f"{case}|{k}|{f}"] for f in ("A", "B")}
        if products:
            assert_close(got["B"] @ got["A"], want[k]["B"] @ want[k]["A"],
                         msg=f"{case}/{k}")
        else:
            for f in ("A", "B"):
                assert_close(got[f], want[k][f], msg=f"{case}/{k}/{f}")


def test_distributed_rounds_in_a_one_rank_nccl_group(tmp_path):
    """A one-rank NCCL group on the card: rbla's round is one all_reduce
    and no kernel, agreeing with the packed_agg round; flora's gathered
    round is one all_gather and one flora_stack_group launch."""
    need_cuda()
    cases = [_dist_case("rbla", "rbla", 0),
             _dist_case("flora", "flora", 1, stack_r_cap=64)]
    ((arrays, meta),) = _dist_world(tmp_path, cases, 1, "nccl")
    assert meta["rbla"]["collectives"] == {"all_reduce": 1, "all_gather": 0,
                                           "all_to_all": 0}
    assert meta["rbla"]["launches"] == {}
    assert meta["flora"]["collectives"] == {"all_reduce": 0, "all_gather": 1,
                                            "all_to_all": 0}
    assert meta["flora"]["launches"] == {"flora_stack": 1}
    _dist_check(arrays, "rbla", _dist_want(cases[0]), products=False)
    _dist_check(arrays, "flora", _dist_want(cases[1]), products=True)


def test_distributed_round_of_two_gloo_ranks_on_one_card(tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one device):
    each rank's rbla round agrees with the single-process packed_agg
    round, through one all_reduce of CUDA tensors."""
    need_cuda()
    case = _dist_case("rbla", "rbla", 2)
    want = _dist_want(case)
    for arrays, meta in _dist_world(tmp_path, [case], 2, "gloo"):
        assert meta["rbla"]["collectives"] == {"all_reduce": 1,
                                               "all_gather": 0,
                                               "all_to_all": 0}
        _dist_check(arrays, "rbla", want, products=False)
