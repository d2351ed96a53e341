"""Server-side aggregation leaves (the paper's core contribution).

* ``rbla``    -- Rank-Based LoRA Aggregation (Eq. 7 / Alg. 1): per rank-row
                 weighted mean over the clients that own the row; rows no
                 participant owns keep ``prev``.
* ``zeropad`` -- the HetLoRA-style baseline (Eq. 1-5): masked values over
                 the total weight mass; missing rows dilute toward zero.
* ``fedavg``  -- plain weighted mean (non-LoRA leaves, the FFT baseline).

Each takes a stacked leaf ``(n_clients, *leaf_shape)``; a mask of ``None``
means a fully shared leaf.  Arithmetic is fp32; results keep the leaf dtype.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _bcast_weights(weights: torch.Tensor, ndim: int) -> torch.Tensor:
    return weights.reshape(weights.shape + (1,) * (ndim - 1))


def fedavg_leaf(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain weighted mean over the client axis (axis 0)."""
    wf = weights.float()
    num = (_bcast_weights(wf, stacked.ndim) * stacked.float()).sum(0)
    return (num / (wf.sum() + _EPS)).to(stacked.dtype)


def zeropad_leaf(stacked: torch.Tensor, mask: torch.Tensor | None,
                 weights: torch.Tensor) -> torch.Tensor:
    """Mask the values, normalise by the *total* weight mass -- the
    dilution the paper criticises (Eq. 3/5)."""
    x = stacked.float()
    if mask is not None:
        x = x * mask.float()
    wf = weights.float()
    num = (_bcast_weights(wf, stacked.ndim) * x).sum(0)
    return (num / (wf.sum() + _EPS)).to(stacked.dtype)


def rbla_leaf(stacked: torch.Tensor, mask: torch.Tensor | None,
              weights: torch.Tensor,
              prev: torch.Tensor | None = None) -> torch.Tensor:
    """RBLA (paper Eq. 7): C_r = sum_i d_ir w_i A_ir / sum_i d_ir w_i.

    Where no participant owns an element (denominator 0) the output is
    ``prev`` when given, else 0: a round whose clients are all low-rank
    must not wipe the high-rank rows the server already holds."""
    x = stacked.float()
    w = _bcast_weights(weights.float(), stacked.ndim)
    m = (torch.ones_like(x) if mask is None
         else torch.broadcast_to(mask.float(), x.shape))
    num = (w * m * x).sum(0)
    den = (w * m).sum(0)
    fallback = torch.zeros_like(num) if prev is None else prev.float()
    return torch.where(den > 0, num / (den + _EPS),
                       fallback).to(stacked.dtype)
