"""The port's fused LoRA matmuls on the CPU against the JAX package's: the
plain versions (``lora_matmul_ref``, the per-request loop
``batched_lora_matmul_ref`` and the segment lowering
``batched_lora_matmul_segments``, the port's CPU serving path) held against
``repro.kernels.lora_matmul`` run in interpret mode (``impl="pallas"``),
through its XLA segment lowering (``impl="xla"``) and its loop oracle, in
fp32 and bf16 on the same numpy inputs; then the port's own guarantees:
garbage outside the live segments never reaches the output, ids resolve
per request row, and the backend rule.

The kernel resolves tenant ids itself; :func:`resolve_segments` is its
rule written once in PyTorch (negative ids counted from the end, as JAX
indexes, then clamped) and is held against JAX's gather.
:func:`matmul_3xtf32` writes out the fp32 arithmetic of the kernel's
tensor-core body (TF32 hi/lo splits, three products) and is held to the
fp32 tolerance of the plain fp32 product.

Tolerances as ``_torch_parity.py``: 2e-5 in fp32, 2e-2 in bf16 (of
max(1, max|want|)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import BF16_TOL, F32_TOL, assert_close

from repro.kernels import batched_lora_matmul_inline as j_batched
from repro.kernels import batched_lora_matmul_ref as j_batched_ref
from repro.kernels import lora_dense_apply as j_dense
from repro.kernels import lora_matmul as j_lora
from repro.kernels import lora_matmul_ref as j_lora_ref
from repro.kernels.lora_matmul.ops import batched_lora_matmul as j_batched_jit
from repro_torch.kernels import runtime
from repro_torch.kernels.lora_matmul import (batched_lora_matmul,
                                             batched_lora_matmul_ref,
                                             batched_lora_matmul_segments,
                                             lora_dense_apply, lora_matmul,
                                             lora_matmul_ref, matmul_3xtf32,
                                             resolve_impl, resolve_segments,
                                             tf32_split)

DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
ALPHA = 16.0


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(np.asarray(a)).to(td)


def packed_case(m=12, k=16, n=10, n_slots=6, r_max=4, seed=0):
    """Packed buffers, tables and a mixed id batch as numpy.  Slot 0 has
    rank 0 (the null adapter); rows outside live segments hold finite
    garbage (the JAX lowerings multiply them by zero)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
    a_rows = rng.normal(size=(n_slots * r_max, k)).astype(np.float32)
    b_rows = rng.normal(size=(n_slots * r_max, n)).astype(np.float32)
    off = np.arange(n_slots, dtype=np.int32) * r_max
    rank = rng.integers(1, r_max + 1, n_slots).astype(np.int32)
    rank[0] = 0
    scale = (ALPHA / np.maximum(rank, 1)).astype(np.float32)
    ids = rng.integers(0, n_slots, m).astype(np.int32)
    return x, w, a_rows, b_rows, off, rank, scale, ids


def _port_batched(case, dtype, **kw):
    x, w, a_rows, b_rows, off, rank, scale, ids = case
    return batched_lora_matmul(
        _both(x, dtype)[1], _both(w, dtype)[1], _both(a_rows, dtype)[1],
        _both(b_rows, dtype)[1], torch.as_tensor(ids), torch.as_tensor(off),
        torch.as_tensor(rank), torch.as_tensor(scale), **kw)


# ----------------------------------------------------------------- single --
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,k,n,r", [((8,), 16, 10, 4), ((2, 3), 24, 7, 1),
                                        ((5,), 200, 10, 64)])
def test_lora_matmul_matches_jax(dtype, lead, k, n, r):
    rng = np.random.default_rng(k + n + r)
    x = rng.normal(size=lead + (k,)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
    a = rng.normal(size=(r, k)).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    scale = ALPHA / r
    jx, tx = _both(x, dtype)
    jw, tw = _both(w, dtype)
    ja, ta = _both(a, dtype)
    jb, tb = _both(b, dtype)
    tol = DTYPES[dtype][2]
    got = lora_matmul(tx, tw, ta, tb, scale)
    assert got.dtype == tx.dtype and got.shape == lead + (n,)
    assert_close(got, j_lora(jx, jw, ja, jb, scale, interpret=True), tol,
                 "lora_matmul vs JAX kernel (interpret)")
    assert_close(lora_matmul_ref(tx.reshape(-1, k), tw, ta, tb,
                                 torch.tensor(scale)),
                 j_lora_ref(jx.reshape(-1, k), jw, ja, jb, scale), tol,
                 "lora_matmul_ref vs JAX ref")


@pytest.mark.parametrize("with_bias", [False, True])
def test_lora_dense_apply_matches_jax(with_bias):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 20)).astype(np.float32)
    p = {"w": (rng.normal(size=(20, 9)) * 0.3).astype(np.float32)}
    if with_bias:
        p["b"] = rng.normal(size=(9,)).astype(np.float32)
    pair = {"A": rng.normal(size=(8, 20)).astype(np.float32),
            "B": rng.normal(size=(9, 8)).astype(np.float32),
            "rank": np.int32(5)}
    want = j_dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                   {k: jnp.asarray(v) for k, v in pair.items()},
                   interpret=True)
    got = lora_dense_apply({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x),
                           {k: torch.as_tensor(v) for k, v in pair.items()})
    assert_close(got, want, F32_TOL, "lora_dense_apply")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rank", [0, 1, 7, 64])
def test_lora_dense_apply_matches_jax_at_ranks(rank, dtype):
    """``lora_dense_apply`` against the JAX package's at the ranks the
    kernel treats apart (0: an adapter whose one stored rank row is zero;
    1 and 7: one ragged rank chunk; 64: two), with a bias, K not a
    multiple of 16 and N of neither tile, in fp32 and bf16; the scale is
    ``alpha / max(rank, 1)``."""
    rng = np.random.default_rng(40 + rank)
    k, n, r_st = 37, 10, max(rank, 1)
    x = rng.normal(size=(2, 9, k)).astype(np.float32)
    p = {"w": (rng.normal(size=(k, n)) * 0.3).astype(np.float32),
         "b": rng.normal(size=(n,)).astype(np.float32)}
    a = rng.normal(size=(r_st, k)).astype(np.float32)
    b = rng.normal(size=(n, r_st)).astype(np.float32)
    a[rank:], b[:, rank:] = 0.0, 0.0
    jp = {key: _both(v, dtype)[0] for key, v in p.items()}
    tp = {key: _both(v, dtype)[1] for key, v in p.items()}
    want = j_dense(jp, _both(x, dtype)[0],
                   {"A": _both(a, dtype)[0], "B": _both(b, dtype)[0],
                    "rank": jnp.int32(rank)}, interpret=True)
    got = lora_dense_apply(tp, _both(x, dtype)[1],
                           {"A": _both(a, dtype)[1], "B": _both(b, dtype)[1],
                            "rank": torch.tensor(rank, dtype=torch.int32)})
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 9, n)
    assert_close(got, want, DTYPES[dtype][2], f"rank {rank}")


# ---------------------------------------------------------------- batched --
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_batched_matches_jax(dtype, jax_impl):
    case = packed_case(seed=1)
    x, w, a_rows, b_rows, off, rank, scale, ids = case
    tol = DTYPES[dtype][2]
    js = [_both(v, dtype)[0] for v in (x, w, a_rows, b_rows)]
    want = j_batched(*js, jnp.asarray(ids), jnp.asarray(off),
                     jnp.asarray(rank), jnp.asarray(scale), impl=jax_impl,
                     interpret=True)
    got = _port_batched(case, dtype)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got, want, tol, f"batched (segments) vs JAX {jax_impl}")
    loop = batched_lora_matmul_ref(
        *[_both(v, dtype)[1] for v in (x, w, a_rows, b_rows)],
        off[ids], rank[ids], scale[ids])
    assert_close(loop, j_batched_ref(*js, off[ids], rank[ids], scale[ids]),
                 tol, "loop oracle vs JAX loop oracle")
    assert_close(loop, want, tol, f"loop oracle vs JAX {jax_impl}")


def test_garbage_outside_segments_never_reaches_the_output():
    """NaN and Inf in every row outside the live segments (the null slot's
    page, the tails of short segments, a page no request names): the
    port's plain versions give what the JAX package gives with those rows
    zeroed."""
    x, w, a_rows, b_rows, off, rank, scale, ids = packed_case(seed=2)
    ids[:3] = 0                                # cnt = 0 rows
    ids[ids == 5] = 4                          # slot 5's page unused
    live = np.zeros(a_rows.shape[0], bool)
    for t in np.unique(ids):
        live[off[t]:off[t] + rank[t]] = True
    a_bad, b_bad = a_rows.copy(), b_rows.copy()
    a_bad[~live] = np.nan
    b_bad[~live] = np.inf
    b_bad[np.flatnonzero(~live)[::2]] = np.nan
    a_zero = np.where(live[:, None], a_rows, 0.0).astype(np.float32)
    b_zero = np.where(live[:, None], b_rows, 0.0).astype(np.float32)
    want = j_batched(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a_zero),
                     jnp.asarray(b_zero), jnp.asarray(ids), jnp.asarray(off),
                     jnp.asarray(rank), jnp.asarray(scale), impl="xla")
    got = _port_batched((x, w, a_bad, b_bad, off, rank, scale, ids), "f32")
    assert torch.isfinite(got).all()
    assert_close(got, want, F32_TOL, "segments with garbage")
    loop = batched_lora_matmul_ref(
        *map(torch.as_tensor, (x, w, a_bad, b_bad)), off[ids], rank[ids],
        scale[ids])
    assert_close(loop, want, F32_TOL, "loop oracle with garbage")
    np.testing.assert_allclose(got[:3].numpy(), x[:3] @ w, rtol=1e-5,
                               atol=1e-5)


def test_adapter_id_permutation_equivariance():
    """Permuting (rows, ids) together permutes the output -- adapter
    resolution is strictly per request row."""
    case = packed_case(seed=3)
    perm = np.random.default_rng(7).permutation(case[0].shape[0])
    y = _port_batched(case, "f32")
    permuted = (case[0][perm],) + case[1:7] + (case[7][perm],)
    assert_close(_port_batched(permuted, "f32"), y[perm], 1e-6,
                 "permuted batch")


def test_ids_outside_the_tables_clamp_as_jax_gathers():
    case = packed_case(seed=4)
    x, w, a_rows, b_rows, off, rank, scale, ids = case
    ids = ids.copy()
    ids[::3] = len(off) + 2
    want = j_batched(*map(jnp.asarray, (x, w, a_rows, b_rows, ids, off, rank,
                                        scale)), impl="xla")
    got = _port_batched(case[:7] + (ids,), "f32")
    assert_close(got, want, F32_TOL, "clamped ids")


def test_batched_keeps_leading_dims_and_counts_plain_calls():
    x, w, a_rows, b_rows, off, rank, scale, ids = packed_case(m=12, seed=5)
    before = dict(runtime.PLAIN_CALLS)
    y = batched_lora_matmul(
        torch.as_tensor(x).reshape(3, 4, -1), torch.as_tensor(w),
        torch.as_tensor(a_rows), torch.as_tensor(b_rows),
        torch.as_tensor(ids).reshape(3, 4), off, rank, scale)
    assert y.shape == (3, 4, w.shape[1])
    assert runtime.PLAIN_CALLS["batched_lora_matmul"] == \
        before["batched_lora_matmul"] + 1
    assert runtime.LAUNCHES["batched_lora_matmul"] == 0
    assert_close(y.reshape(12, -1), _port_batched(
        (x, w, a_rows, b_rows, off, rank, scale, ids), "f32"), 0.0)


def test_resolve_impl():
    assert resolve_impl("auto", "cpu") == "xla"
    assert resolve_impl(None, "cpu") == "xla"
    assert resolve_impl("auto", "cuda") == "kernel"
    assert resolve_impl("xla") == "xla"
    assert resolve_impl("pallas") == "kernel"
    assert resolve_impl("kernel", "cuda") == "kernel"
    with pytest.raises(ValueError, match="unknown batched"):
        resolve_impl("tpu")


def test_a_cpu_tensor_never_asks_for_the_kernel():
    x, w, a_rows, b_rows, off, rank, scale, ids = map(
        torch.as_tensor, packed_case(seed=6))
    for impl in ("pallas", "kernel"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            batched_lora_matmul(x, w, a_rows, b_rows, ids, off, rank, scale,
                                impl=impl)
    with pytest.raises(ValueError, match="unknown batched"):
        batched_lora_matmul(x, w, a_rows, b_rows, ids, off, rank, scale,
                            impl="tpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        lora_matmul(x, w, a_rows[:4], b_rows[:4].T, 1.0, backend="kernel")


def test_shape_checks():
    x, w, a_rows, b_rows, off, rank, scale, ids = map(
        torch.as_tensor, packed_case(seed=7))
    with pytest.raises(ValueError, match="needs w"):
        batched_lora_matmul(x, w, a_rows, b_rows.T, ids, off, rank, scale)
    with pytest.raises(ValueError, match="needs w"):
        lora_matmul(x, w[:-1], a_rows, b_rows.T, 1.0)
    with pytest.raises(ValueError, match="adapter ids"):
        batched_lora_matmul(x, w, a_rows, b_rows, ids[:-1], off, rank, scale)


def test_segments_lowering_equals_the_loop_oracle_on_clipped_segments():
    """Segments reaching past the packed rows, or starting before them,
    count only rows that exist (the TPU kernel's iota mask)."""
    x, w, a_rows, b_rows, _, _, scale, _ = map(torch.as_tensor,
                                               packed_case(m=5, seed=8))
    r = a_rows.shape[0]
    off = torch.tensor([r - 2, -3, 0, r, 4], dtype=torch.int32)
    cnt = torch.tensor([4, 5, 0, 3, 2], dtype=torch.int32)
    sc = scale[:5]
    assert_close(batched_lora_matmul_segments(x, w, a_rows, b_rows, off, cnt,
                                              sc),
                 batched_lora_matmul_ref(x, w, a_rows, b_rows, off, cnt, sc),
                 F32_TOL, "clipped segments")


# ------------------------------------------------- the kernel's id rule --
def _wild_ids(n_slots, m, seed):
    """Ids in and out of the tables: every slot, -1 .. -n_slots (counted
    from the end), below -n_slots and at or above n_slots (clamped)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3 * n_slots, 3 * n_slots, m).astype(np.int32)
    ids[:4] = (-1, -n_slots, -n_slots - 1, n_slots)
    return ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_segments_matches_the_jax_gather(seed):
    _, _, _, _, off, rank, scale, _ = packed_case(seed=seed)
    ids = _wild_ids(len(off), 40, seed)
    got = resolve_segments(*map(torch.as_tensor, (ids, off, rank, scale)))
    want = [np.asarray(jnp.asarray(t)[jnp.asarray(ids)])
            for t in (off, rank, scale)]
    assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                      torch.float32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_batched_with_ids_outside_the_tables_matches_jax(dtype, jax_impl):
    """Ids below 0 and at or above T, rank-0 tenants (slot 0 and slot 3)
    and NaN/Inf in every row outside the segments the ids name: the port
    gives what ``repro.kernels.lora_matmul.ops.batched_lora_matmul``
    gives with those rows zeroed (its lowerings multiply them by 0)."""
    x, w, a_rows, b_rows, off, rank, scale, _ = packed_case(m=24, seed=9)
    rank[3] = 0
    ids = _wild_ids(len(off), 24, 9)
    t = np.clip(np.where(ids < 0, ids + len(off), ids), 0, len(off) - 1)
    live = np.zeros(a_rows.shape[0], bool)
    for slot in np.unique(t):
        live[off[slot]:off[slot] + rank[slot]] = True
    assert (~live).any() and (rank[t] == 0).any()
    a_bad, b_bad = a_rows.copy(), b_rows.copy()
    a_bad[~live] = np.nan
    b_bad[~live] = np.inf
    b_bad[np.flatnonzero(~live)[::2]] = np.nan
    a_zero = np.where(live[:, None], a_rows, 0.0).astype(np.float32)
    b_zero = np.where(live[:, None], b_rows, 0.0).astype(np.float32)
    js = [_both(v, dtype)[0] for v in (x, w, a_zero, b_zero)]
    want = j_batched_jit(*js, jnp.asarray(ids), jnp.asarray(off),
                         jnp.asarray(rank), jnp.asarray(scale),
                         impl=jax_impl, interpret=True)
    got = _port_batched((x, w, a_bad, b_bad, off, rank, scale, ids), dtype)
    assert torch.isfinite(got.float()).all()
    assert_close(got, want, DTYPES[dtype][2], f"wild ids vs JAX {jax_impl}")
    base = (_both(x, dtype)[1].float() @ _both(w, dtype)[1].float()).to(
        got.dtype)
    zero = torch.as_tensor(rank[t] == 0)
    assert_close(got[zero], base[zero], DTYPES[dtype][2], "rank 0")


def test_empty_or_mismatched_tables_raise():
    x, w, a_rows, b_rows, off, rank, scale, ids = map(
        torch.as_tensor, packed_case(seed=10))
    with pytest.raises(ValueError, match="T >= 1"):
        batched_lora_matmul(x, w, a_rows, b_rows, ids, off[:0], rank[:0],
                            scale[:0])
    with pytest.raises(ValueError, match="T >= 1"):
        batched_lora_matmul(x, w, a_rows, b_rows, ids, off, rank[:-1], scale)
    with pytest.raises(ValueError, match="empty"):
        resolve_segments(ids, off[:0], rank[:0], scale[:0])


# ------------------------------------- the kernel's fp32 arithmetic (3xTF32) --
def _tf32_numpy(v, away: bool):
    """An independent TF32 rounding in float64: |v| to 11 significant bits,
    to nearest with ties away from zero (``away``) or toward zero."""
    v = np.asarray(v, np.float64)
    e = np.floor(np.log2(np.abs(np.where(v == 0, 1.0, v))))
    step = 2.0 ** (e - 10)
    mag = np.floor(np.abs(v) / step + (0.5 if away else 0.0)) * step
    return np.where(v == 0, v, np.sign(v) * mag)


def test_tf32_split_rounds_hi_to_nearest_away_and_truncates_lo():
    rng = np.random.default_rng(11)
    v = np.concatenate([
        rng.normal(size=2000) * 10.0 ** rng.integers(-6, 6, 2000),
        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 0.0, 3.0]]
    ).astype(np.float32)
    hi, lo = tf32_split(torch.as_tensor(v))
    np.testing.assert_array_equal(hi.numpy(), _tf32_numpy(v, away=True))
    rest = v.astype(np.float64) - hi.numpy()
    assert np.array_equal(rest.astype(np.float32), rest)   # x - hi is exact
    np.testing.assert_array_equal(lo.numpy(), _tf32_numpy(rest, away=False))
    assert not (hi.numpy().view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy()[-5:],
                                  [1 + 2 ** -10, -(1 + 2 ** -10),
                                   1 + 2 ** -9, 0.0, 3.0])


@pytest.mark.parametrize("m,k,n", [(64, 4096, 64), (512, 512, 512),
                                   (500, 784, 200), (500, 200, 200),
                                   (500, 200, 10)])
def test_3xtf32_emulation_within_the_fp32_tolerance(m, k, n):
    """The kernel's fp32 product (3xTF32: TF32 hi/lo splits, three
    products) within 2e-5 of max|want| of the fp32 product at K = 4096,
    the serve shape and the MLP's layers; one TF32 product alone (hi hi)
    is not."""
    rng = np.random.default_rng(m + k + n)
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.as_tensor((rng.normal(size=(k, n)) / np.sqrt(k)).astype(
        np.float32))
    want = x @ w
    bound = F32_TOL * float(want.abs().max())
    assert float((matmul_3xtf32(x, w) - want).abs().max()) <= bound
    xh, wh = tf32_split(x)[0], tf32_split(w)[0]
    assert float((xh @ wh - want).abs().max()) > bound
