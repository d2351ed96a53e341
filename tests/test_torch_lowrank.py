"""The port's factored low-rank engine (``repro_torch.core.lowrank``)
against the JAX package's ``repro.core.lowrank``.

Singular vectors carry arbitrary signs (and any basis of a repeated
singular value), so two SVDs are compared in product space: ``U S Vt`` or
``B_out @ A_out``, within 2e-5 of max|want| for the exact paths (fp32 QR
and SVD of two LAPACK builds), and against the spectrum's tail for the
randomized ones.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.core import lowrank as jlr
from repro_torch.core import lowrank as tlr

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _factors(seed, lead=(), m=12, k=6, n=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (m, k)).astype(np.float32),
            rng.normal(size=lead + (k, n)).astype(np.float32))


def _usv(u, s, vt):
    u, s, vt = (np.asarray(t, np.float32) for t in (u, s, vt))
    return (u * s[..., None, :]) @ vt


@pytest.mark.parametrize("r_out", [3, 6, 9])
@pytest.mark.parametrize("fn", ["factored_svd", "dense_svd"])
def test_exact_svds_match_jax_in_product_space(fn, r_out):
    """r_out 9 exceeds the factored rank 6: both pad with zero triplets."""
    B, A = _factors(r_out)
    got = getattr(tlr, fn)(torch.as_tensor(B), torch.as_tensor(A), r_out)
    want = getattr(jlr, fn)(jnp.asarray(B), jnp.asarray(A), r_out)
    assert tuple(got[1].shape) == (r_out,)
    assert_close(_usv(*got), _usv(*want))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-5, atol=2e-5 * float(want[1].max()))


def test_factored_svd_batches_over_leading_dims():
    B, A = _factors(3, lead=(2, 3))
    got = tlr.factored_svd(torch.as_tensor(B), torch.as_tensor(A), 4)
    want = jlr.factored_svd(jnp.asarray(B), jnp.asarray(A), 4)
    assert tuple(got[0].shape) == (2, 3, 12, 4)
    assert_close(_usv(*got), _usv(*want))


def test_lossless_truncation_reconstructs_the_product():
    B, A = _factors(4)
    u, s, vt = tlr.factored_svd(torch.as_tensor(B), torch.as_tensor(A))
    assert_close(_usv(u, s, vt), B @ A)


@pytest.mark.parametrize("k,want_method", [(6, "factored"), (14, "dense")])
def test_truncated_svd_product_routes_like_jax(k, want_method, monkeypatch):
    """"auto" takes the factored path while k <= min(m, n), dense beyond."""
    B, A = _factors(5, k=k)
    called = []
    orig = getattr(tlr, f"{want_method}_svd")
    monkeypatch.setattr(tlr, f"{want_method}_svd",
                        lambda *a: called.append(1) or orig(*a))
    got = tlr.truncated_svd_product(torch.as_tensor(B), torch.as_tensor(A), 3)
    want = jlr.truncated_svd_product(jnp.asarray(B), jnp.asarray(A), 3)
    assert called
    assert_close(_usv(*got), _usv(*want))
    with pytest.raises(ValueError, match="unknown svd method"):
        tlr.truncated_svd_product(torch.as_tensor(B), torch.as_tensor(A), 3,
                                  method="lanczos")


def test_product_factors_match_jax_and_are_balanced():
    B, A = _factors(6)
    Bo, Ao = tlr.product_factors(torch.as_tensor(B), torch.as_tensor(A), 4)
    jB, jA = jlr.product_factors(jnp.asarray(B), jnp.asarray(A), 4)
    assert_close(Bo @ Ao, np.asarray(jB) @ np.asarray(jA))
    np.testing.assert_allclose(Bo.norm(dim=0).numpy(),
                               Ao.norm(dim=1).numpy(), rtol=1e-4, atol=1e-5)


def test_randomized_svd_error_bounded_by_spectrum_tail():
    """As the JAX gate: on a decaying spectrum the rank-r error stays
    within 1.5x of the optimal (Frobenius tail) error."""
    rng = np.random.default_rng(5)
    m, n, r = 60, 40, 8
    u, _ = np.linalg.qr(rng.normal(size=(m, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    spectrum = 0.7 ** np.arange(n)
    M = (u * spectrum) @ v.T
    U, S, Vt = tlr.randomized_svd(
        torch.as_tensor(M, dtype=torch.float32), r, oversample=8,
        power_iters=2, generator=torch.Generator().manual_seed(7))
    err = np.linalg.norm(M - _usv(U, S, Vt))
    opt = np.linalg.norm(spectrum[r:])
    assert err <= 1.5 * opt + 1e-4, (err, opt)


def test_randomized_product_sketch_is_accurate_and_seeded():
    """Factored-form range finder: exact on a rank-6 product, the same
    result for the same generator seed, and close to JAX's sketch."""
    B, A = _factors(8)
    tb, ta = torch.as_tensor(B), torch.as_tensor(A)
    got = tlr.randomized_svd_product(tb, ta, 6)
    assert_close(_usv(*got), B @ A, tol=1e-4)
    again = tlr.randomized_svd_product(tb, ta, 6)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = jlr.randomized_svd_product(jnp.asarray(B), jnp.asarray(A), 6,
                                      key=jax.random.PRNGKey(0))
    assert_close(_usv(*got), _usv(*want), tol=1e-4)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_svd_project_stacked_matches_jax(lead):
    rng = np.random.default_rng(9)
    n, r_st = 4, 5
    B = rng.normal(size=(n,) + lead + (12, r_st)).astype(np.float32)
    A = rng.normal(size=(n,) + lead + (r_st, 10)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    sc = rng.uniform(1.0, 3.0, (n,) + lead).astype(np.float32)
    got = tlr.svd_project_stacked(torch.as_tensor(B), torch.as_tensor(A),
                                  torch.as_tensor(w), 6,
                                  scales=torch.as_tensor(sc))
    want = jlr.svd_project_stacked(jnp.asarray(B), jnp.asarray(A),
                                   jnp.asarray(w), 6, scales=jnp.asarray(sc))
    assert_close(got[0] @ got[1], np.asarray(want[0]) @ np.asarray(want[1]))


def test_no_dense_svd_call_sites_outside_lowrank():
    """Only ``repro_torch/core/lowrank.py`` may call ``torch.linalg.svd``
    (its dense fallback and the small core SVDs)."""
    offenders = [str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                 if p.name != "lowrank.py"
                 and re.search(r"linalg\.svd", p.read_text())]
    assert not offenders, offenders
