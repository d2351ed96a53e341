"""Plain PyTorch versions of the aggregation kernels.

Each function computes exactly what its CUDA kernel in
``csrc/rbla_agg.cu`` computes (no epsilon where a denominator is known to be
positive, ``num / wtot`` for ``norm_by="weight"``), in fp32.  The CPU path
of the wrappers and the strategies' ``ref`` backend run these; on the card
they are the oracle the kernels are held against.
"""
from __future__ import annotations

import torch

from .. import runtime


def _finish(num, den, wtot, norm_by: str, prev):
    if norm_by == "weight":
        return num / wtot
    if norm_by != "mask":
        raise ValueError(f"unknown norm_by {norm_by!r}; options: "
                         "['mask', 'weight']")
    fb = (prev.float() if prev is not None else torch.zeros_like(num))
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), fb)


def packed_agg_ref(x, masks, weights, prev=None, *, norm_by: str = "mask",
                   norm_restore: bool = False, scales=None, out_dtype=None):
    """x (N, R, D); masks (N, R); weights (N,); prev (R, D) or None;
    scales (N, R) or None -> (R, D) in ``out_dtype`` (default x's).

    Per row r: ``sum_n w_n m_nr s_nr x_nr / sum_n w_n m_nr`` where that
    owner mass is positive, else ``prev`` (or 0); ``norm_by="weight"``
    divides by ``sum_n w_n`` instead.  ``norm_restore`` rescales each
    output row to the owners' weighted mean row norm."""
    runtime.PLAIN_CALLS["packed_agg"] += 1
    xf = x.float()
    if scales is not None:
        xf = scales.float()[:, :, None] * xf
    m = masks.float()
    w = weights.float()
    wm = w[:, None] * m                                    # (N, R)
    num = (wm[:, :, None] * xf).sum(0)
    out = _finish(num, wm.sum(0)[:, None], w.sum(), norm_by, prev)
    if norm_restore:
        xm = m[:, :, None] * xf
        row_norms = xm.square().sum(-1).sqrt()             # (N, R)
        own = (m > 0).float() * w[:, None]
        target = (own * row_norms).sum(0) / (own.sum(0) + 1e-12)
        agg = out.square().sum(1).sqrt()
        out = out * torch.where(agg > 1e-12, target / (agg + 1e-12),
                                1.0)[:, None]
    return out.to(out_dtype or x.dtype)


def rbla_agg_ref(x, ranks, weights, *, norm_by: str = "mask"):
    """x (N, R, D); ranks (N,) int; weights (N,) -> (R, D) in x's dtype.

    Paper Eq. 7 with the owner mask ``[r < ranks[n]]``; rows no client
    owns are 0; ``norm_by="weight"`` divides by the total mass."""
    runtime.PLAIN_CALLS["rbla_agg"] += 1
    r = x.shape[1]
    m = (torch.arange(r, device=x.device)[None, :]
         < ranks.to(x.device)[:, None]).float()
    w = weights.float()
    wm = w[:, None] * m
    num = (wm[:, :, None] * x.float()).sum(0)
    return _finish(num, wm.sum(0)[:, None], w.sum(), norm_by,
                   None).to(x.dtype)
