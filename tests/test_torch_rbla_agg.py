"""The port's aggregation kernels (``repro_torch.kernels.rbla_agg``).

On the CPU the wrappers run their plain versions, which are held against
the JAX package's Pallas kernels (interpret mode) and its jnp oracles over
every mode: norm_by mask/weight, with and without prev, with and without
norm_restore, fp32 / bf16 / int8 with scales, at the paper MLP's bucket
widths 10, 200 and 784.  The tests marked ``cuda`` hold each CUDA kernel
against its plain version on the card and skip elsewhere.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import BF16_TOL, F32_TOL, assert_close

from repro.kernels.rbla_agg import ops as jops
from repro.kernels.rbla_agg import ref as jref
from repro_torch.kernels import runtime
from repro_torch.kernels.rbla_agg import packed_agg, rbla_agg

WIDTHS = (10, 200, 784)
MODES = [(norm_by, prev, restore) for norm_by in ("mask", "weight")
         for prev in (False, True) for restore in (False, True)]


def _packed_inputs(n, r, d, dtype, seed, with_prev):
    """numpy inputs: x of ``dtype`` ("f32"|"bf16"|"int8"), 0/1 owner masks
    from random ranks (some rows unowned), weights, prev, scales."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, r, n)
    masks = (np.arange(r)[None, :] < ranks[:, None]).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    scales = None
    if dtype == "int8":
        x = rng.integers(-127, 128, (n, r, d)).astype(np.int8)
        scales = rng.uniform(0.001, 0.02, (n, r)).astype(np.float32)
    else:
        x = rng.normal(size=(n, r, d)).astype(np.float32)
        if dtype == "bf16":
            x = x.astype(ml_dtypes.bfloat16)
    out_np = ml_dtypes.bfloat16 if dtype == "bf16" else np.float32
    prev = (rng.normal(size=(r, d)).astype(out_np) if with_prev else None)
    return x, masks, weights, prev, scales


def _t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _run_both(dtype, d, norm_by, with_prev, restore, seed, n=4, r=12):
    x, masks, weights, prev, scales = _packed_inputs(n, r, d, dtype, seed,
                                                     with_prev)
    out_dtype = "float32" if dtype == "int8" else None
    kw = dict(norm_by=norm_by, norm_restore=restore)
    got = packed_agg(_t(x), _t(masks), _t(weights), _t(prev), scales=_t(scales),
                     out_dtype=torch.float32 if out_dtype else None, **kw)
    jargs = (_j(x), _j(masks), _j(weights), _j(prev))
    jkw = dict(kw, scales=_j(scales),
               out_dtype=jnp.float32 if out_dtype else None)
    return got, jargs, jkw


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("norm_by,with_prev,restore", MODES)
def test_packed_agg_plain_matches_jax_ref(dtype, norm_by, with_prev,
                                          restore):
    got, jargs, jkw = _run_both(dtype, 200, norm_by, with_prev, restore,
                                seed=MODES.index((norm_by, with_prev,
                                                  restore)))
    want = jref.packed_agg_ref(*jargs, **jkw)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert_close(got, want, BF16_TOL if dtype == "bf16" else F32_TOL)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("norm_by,with_prev,restore",
                         [("mask", True, False), ("mask", False, True),
                          ("weight", False, False)])
def test_packed_agg_plain_matches_jax_kernel(d, norm_by, with_prev, restore):
    """Against the Pallas kernel itself (interpret mode) at the MLP's
    bucket widths: rbla with prev, rbla_norm, zeropad/fedavg."""
    got, jargs, jkw = _run_both("f32", d, norm_by, with_prev, restore,
                                seed=d)
    want = jops.packed_agg(*jargs, **jkw, interpret=True)
    assert_close(got, want)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("method", ["rbla", "zeropad"])
def test_rbla_agg_plain_matches_jax(d, method):
    rng = np.random.default_rng(d)
    n, r = 5, 16
    ranks = rng.integers(1, r + 1, n).astype(np.int32)
    x = rng.normal(size=(n, r, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    got = rbla_agg(_t(x), _t(ranks), _t(w), method=method)
    assert_close(got, jops.rbla_agg(_j(x), _j(ranks), _j(w), method=method,
                                    interpret=True))
    assert_close(got, jref.rbla_agg_ref(_j(x), _j(ranks), _j(w),
                                        method=method))


def test_rbla_agg_bf16_and_trailing_dims():
    """(N, R, out, r2) layouts flatten and restore; bf16 stays bf16."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 16, 8, 6)).astype(ml_dtypes.bfloat16)
    ranks = np.array([4, 8, 16, 2], np.int32)
    got = rbla_agg(_t(x), _t(ranks), torch.ones(4))
    assert got.shape == (16, 8, 6) and got.dtype == torch.bfloat16
    want = jops.rbla_agg(_j(x), _j(ranks), jnp.ones(4), interpret=True)
    assert_close(got, want, BF16_TOL)


def test_packed_agg_unowned_rows_keep_prev_exactly():
    x, masks, weights, prev, _ = _packed_inputs(3, 10, 10, "f32", 1, True)
    masks[:, 6:] = 0.0
    got = packed_agg(_t(x), _t(masks), _t(weights), _t(prev))
    assert torch.equal(got[6:], _t(prev)[6:])


def test_plain_calls_are_counted():
    runtime.reset_counts()
    x = torch.randn(2, 3, 4)
    packed_agg(x, torch.ones(2, 3), torch.ones(2))
    rbla_agg(x, torch.tensor([1, 3]), torch.ones(2))
    assert runtime.PLAIN_CALLS == {k: int(k in ("packed_agg", "rbla_agg"))
                                   for k in runtime.KERNELS}
    assert runtime.LAUNCHES == dict.fromkeys(runtime.KERNELS, 0)


@pytest.mark.parametrize("backend", ["kernel", "pallas"])
def test_kernel_backend_on_cpu_tensor_raises(backend):
    x = torch.randn(2, 3, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        packed_agg(x, torch.ones(2, 3), torch.ones(2), backend=backend)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rbla_agg(x, torch.tensor([1, 3]), torch.ones(2), backend=backend)


def test_shape_errors():
    x = torch.randn(2, 3, 4)
    with pytest.raises(ValueError, match="masks"):
        packed_agg(x, torch.ones(3, 2), torch.ones(2))
    with pytest.raises(ValueError, match="prev"):
        packed_agg(x, torch.ones(2, 3), torch.ones(2), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="unknown kernel method"):
        rbla_agg(x, torch.tensor([1, 3]), torch.ones(2), method="median")
