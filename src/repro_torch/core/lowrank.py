"""Batched low-rank factorisation engine: SVD without the dense detour.

Every SVD the aggregation server runs -- the ``svd`` strategy's
product-space truncation and flora's over-cap re-projection -- factors a
matrix that is already a product of low-rank factors::

    Delta = B @ A,   B: (..., m, k),  A: (..., k, n),  k = sum(r_i)

so ``rank(Delta) <= k`` and the SVD lives in a k-dimensional subspace:

* :func:`factored_svd` -- the exact truncated SVD in factored form: QR the
  B columns and the A rows, SVD only the small ``(k x k)`` core; cost
  ``O((m + n) k^2 + k^3)`` and no ``m x n`` intermediate.
* :func:`randomized_svd` / :func:`randomized_svd_product` -- the
  Halko-Martinsson-Tropp range finder (dense input, and factored input
  with every product associated through the factors).  The Gaussian
  sketch comes from an explicit ``torch.Generator`` (seed 0 when none is
  given), in place of the JAX package's PRNG key.
* :func:`truncated_svd_product` -- the dispatcher: ``"auto"`` is factored
  while ``k <= min(m, n)`` and dense beyond.  The dense branch
  (:func:`dense_svd`) is the only place in ``repro_torch`` that runs
  ``torch.linalg.svd`` on a materialised product.

Every entry point batches over leading dims (``torch.linalg.qr`` and
``torch.linalg.svd`` batch natively).  Computation is float32; callers
cast the factors back.
"""
from __future__ import annotations

import torch

from .aggregation import _EPS
from .masks import pad_to_rank


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _truncate(u, s, vt, r_out: int):
    """The leading ``r_out`` triplets, zero-padded when the factored rank
    is smaller (callers embed ``r_out`` in fixed buffers)."""
    k = s.shape[-1]
    if k >= r_out:
        return u[..., :, :r_out], s[..., :r_out], vt[..., :r_out, :]
    return (pad_to_rank(u, -1, r_out), pad_to_rank(s, -1, r_out),
            pad_to_rank(vt, -2, r_out))


def factored_svd(B, A, r_out: int | None = None):
    """Exact truncated SVD of ``B @ A`` without materialising the product.

    ``B``: (..., m, k); ``A``: (..., k, n) -> ``(U, S, Vt)`` of shapes
    (..., m, r), (..., r), (..., r, n) with ``r = r_out`` (or the full
    core rank when ``r_out`` is None)."""
    Qb, Rb = torch.linalg.qr(_f32(B))
    Qa, Ra = torch.linalg.qr(_f32(A).transpose(-1, -2))
    core = Rb @ Ra.transpose(-1, -2)                   # (..., kb, ka): small
    u, s, vt = torch.linalg.svd(core, full_matrices=False)
    if r_out is not None:
        u, s, vt = _truncate(u, s, vt, r_out)
    return Qb @ u, s, vt @ Qa.transpose(-1, -2)


def dense_svd(B, A, r_out: int | None = None):
    """Materialise ``B @ A`` and SVD it: for ``k > min(m, n)`` (where the
    factored path would do more work) and as the cost baseline."""
    delta = _f32(B) @ _f32(A)
    u, s, vt = torch.linalg.svd(delta, full_matrices=False)
    if r_out is not None:
        u, s, vt = _truncate(u, s, vt, r_out)
    return u, s, vt


def _sketch(shape, like: torch.Tensor, generator: torch.Generator | None):
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=like.device)


def randomized_svd(M, r_out: int, *, oversample: int = 8,
                   power_iters: int = 2,
                   generator: torch.Generator | None = None):
    """Randomized range-finder SVD (Halko et al., 2011) of a dense ``M``:
    a Gaussian sketch of width ``min(r_out + oversample, min(m, n))``,
    ``power_iters`` rounds of QR-stabilised subspace iteration, then the
    SVD of the small projected matrix.  Batches over leading dims."""
    M = _f32(M)
    m, n = M.shape[-2], M.shape[-1]
    k = min(r_out + int(oversample), min(m, n))
    omega = _sketch(M.shape[:-2] + (n, k), M, generator)
    Mt = M.transpose(-1, -2)
    Q, _ = torch.linalg.qr(M @ omega)                  # (..., m, k)
    for _ in range(int(power_iters)):
        Z, _ = torch.linalg.qr(Mt @ Q)
        Q, _ = torch.linalg.qr(M @ Z)
    small = Q.transpose(-1, -2) @ M                    # (..., k, n)
    u, s, vt = torch.linalg.svd(small, full_matrices=False)
    return _truncate(Q @ u, s, vt, r_out)


def randomized_svd_product(B, A, r_out: int, *, oversample: int = 8,
                           power_iters: int = 2,
                           generator: torch.Generator | None = None):
    """The range-finder SVD of ``B @ A`` in factored form: every sketch and
    projection associates through the factors, so the dense product is
    never formed."""
    B, A = _f32(B), _f32(A)
    m, n = B.shape[-2], A.shape[-1]
    k = min(r_out + int(oversample), min(m, n))
    omega = _sketch(A.shape[:-2] + (n, k), A, generator)
    Bt, At = B.transpose(-1, -2), A.transpose(-1, -2)
    Q, _ = torch.linalg.qr(B @ (A @ omega))            # (..., m, k)
    for _ in range(int(power_iters)):
        Z, _ = torch.linalg.qr(At @ (Bt @ Q))
        Q, _ = torch.linalg.qr(B @ (A @ Z))
    small = (Q.transpose(-1, -2) @ B) @ A              # (..., k, n)
    u, s, vt = torch.linalg.svd(small, full_matrices=False)
    return _truncate(Q @ u, s, vt, r_out)


def truncated_svd_product(B, A, r_out: int, *, method: str = "auto",
                          oversample: int = 8, power_iters: int = 2,
                          generator: torch.Generator | None = None):
    """Truncated SVD of ``B @ A``: ``"auto"`` (factored while ``k <=
    min(m, n)``, dense beyond), ``"factored"``, ``"dense"`` or
    ``"randomized"`` (the factored-form sketch, an approximation)."""
    m, k, n = B.shape[-2], B.shape[-1], A.shape[-1]
    if method == "auto":
        method = "factored" if k <= min(m, n) else "dense"
    if method == "factored":
        return factored_svd(B, A, r_out)
    if method == "dense":
        return dense_svd(B, A, r_out)
    if method == "randomized":
        return randomized_svd_product(B, A, r_out, oversample=oversample,
                                      power_iters=power_iters,
                                      generator=generator)
    raise ValueError(f"unknown svd method {method!r}; options: "
                     "auto | factored | dense | randomized")


def product_factors(B, A, r_out: int, *, method: str = "auto",
                    oversample: int = 8, power_iters: int = 2,
                    generator: torch.Generator | None = None):
    """Re-factor ``B @ A`` into a rank-``r_out`` LoRA pair ``(B_out,
    A_out) = (U sqrt(S), sqrt(S) Vt)``, the balanced split every
    re-projection uses."""
    u, s, vt = truncated_svd_product(B, A, r_out, method=method,
                                     oversample=oversample,
                                     power_iters=power_iters,
                                     generator=generator)
    sq = s.sqrt()
    return u * sq[..., None, :], sq[..., :, None] * vt


def svd_project_stacked(stacked_B, stacked_A, weights, r_out: int, *,
                        scales=None, method: str = "auto",
                        oversample: int = 8, power_iters: int = 2,
                        generator: torch.Generator | None = None):
    """Product-space aggregation of stacked LoRA pairs in factored form.

    ``stacked_B``: (n, ..., out, r_st); ``stacked_A``: (n, ..., r_st, in).
    The weighted mean ``sum_i (w_i s_i / sum(w)) B_i @ A_i`` is itself a
    product of concatenated factors (each client's scaled B columns side
    by side, its A rows stacked below), so the whole aggregation is one
    rank-``n * r_st`` factored SVD.  ``scales`` broadcasts against
    ``weights`` over (n, *leading rank dims), aligned with the trailing
    leading dims.  Returns float32 ``(B_out, A_out)`` of inner dim
    ``r_out``."""
    n, r_st = stacked_A.shape[0], stacked_A.shape[-2]
    lead_ndim = stacked_B.ndim - 3
    wf = _f32(torch.as_tensor(weights, device=stacked_B.device))
    w = (wf / (wf.sum() + _EPS)).reshape((n,) + (1,) * lead_ndim)
    if scales is not None:
        sc = _f32(torch.as_tensor(scales, device=stacked_B.device))
        mid = lead_ndim - (sc.ndim - 1)
        w = w * sc.reshape(sc.shape[:1] + (1,) * mid + sc.shape[1:])
    Bw = _f32(stacked_B) * w[..., None, None]
    Bc = torch.movedim(Bw, 0, -2)                      # (..., out, n, r_st)
    Bc = Bc.reshape(Bc.shape[:-2] + (n * r_st,))
    Ac = torch.movedim(_f32(stacked_A), 0, -3)         # (..., n, r_st, in)
    Ac = Ac.reshape(Ac.shape[:-3] + (n * r_st,) + Ac.shape[-1:])
    return product_factors(Bc, Ac, r_out, method=method,
                           oversample=oversample, power_iters=power_iters,
                           generator=generator)


__all__ = [
    "factored_svd", "dense_svd", "randomized_svd",
    "randomized_svd_product", "truncated_svd_product",
    "product_factors", "svd_project_stacked",
]
