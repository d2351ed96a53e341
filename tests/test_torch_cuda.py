"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the strategies' kernel paths against their ref paths.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it also runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import BF16_TOL, F32_TOL, assert_close, need_cuda

from repro_torch.core import strategy as ts
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import (packed_agg, packed_agg_ref,
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
    assert runtime.PLAIN_CALLS == {"packed_agg": 0, "rbla_agg": 0}
    assert runtime.LAUNCHES["packed_agg"] >= 3


def test_simulation_kernel_rounds_match_plain_rounds():
    need_cuda()
    kw = dict(rounds=2, n_clients=4, n_per_class=20, n_test_per_class=10,
              batch_size=16, lr=0.01, r_max=8)
    runtime.reset_counts()
    got = run_simulation(FLConfig(**kw))
    assert runtime.LAUNCHES["packed_agg"] == 2 * 3
    assert runtime.PLAIN_CALLS["packed_agg"] == 0
    want = run_simulation(FLConfig(agg_backend="ref", **kw))
    np.testing.assert_allclose(got.test_acc, want.test_acc, atol=0.01)
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-3)
