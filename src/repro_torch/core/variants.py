"""Beyond-paper variants (see the JAX package's ``repro.core.variants``):
rank-proportional client weights (rbla_ranked), per-row norm restoration
(rbla_norm) and product-space aggregation of a pair (svd)."""
from __future__ import annotations

import torch

from .aggregation import _EPS, rbla_leaf


def rank_proportional_weights(weights: torch.Tensor, ranks: torch.Tensor,
                              alpha: float = 1.0) -> torch.Tensor:
    """w_i <- w_i * (rank_i / max rank)^alpha, renormalised."""
    ranks = ranks.float()
    wf = weights.float()
    scaled = wf * (ranks / ranks.max()) ** alpha
    return scaled * (wf.sum() / (scaled.sum() + _EPS))


def rbla_norm_leaf(stacked: torch.Tensor, mask: torch.Tensor | None,
                   weights: torch.Tensor, row_axis: int = 0) -> torch.Tensor:
    """RBLA, then rescale each row (along ``row_axis`` of the leaf) so its
    L2 norm equals the owners' weighted mean row norm."""
    agg = rbla_leaf(stacked, mask, weights).float()
    x = stacked.float()
    m = (torch.ones_like(x) if mask is None
         else torch.broadcast_to(mask.float(), x.shape))
    leaf_row_axis = row_axis % agg.ndim
    reduce_axes = tuple(a for a in range(1, x.ndim) if a != leaf_row_axis + 1)
    row_norms = (m * x).square().sum(reduce_axes).sqrt()           # (n, rows)
    owns = (m.amax(reduce_axes) > 0).float()                       # (n, rows)
    w_rows = owns * weights.float()[:, None]
    target = (w_rows * row_norms).sum(0) / (w_rows.sum(0) + _EPS)
    agg_norms = agg.square().sum(tuple(a - 1 for a in reduce_axes)).sqrt()
    scale = torch.where(agg_norms > _EPS, target / (agg_norms + _EPS), 1.0)
    shape = [1] * agg.ndim
    shape[leaf_row_axis] = agg.shape[leaf_row_axis]
    return (agg * scale.reshape(shape)).to(stacked.dtype)


def svd_project_pair(stacked_B: torch.Tensor, stacked_A: torch.Tensor,
                     ranks: torch.Tensor, weights: torch.Tensor, r_out: int,
                     scales: torch.Tensor | None = None):
    """Aggregate stacked LoRA pairs in product space and re-factor by a
    truncated SVD: stacked_B (n, out, r_max), stacked_A (n, r_max, in) ->
    (B, A) of inner dim ``r_out`` in the inputs' dtypes.  Row masking is
    implicit (padded rows are zero); the truncation runs through the
    factored engine (``repro_torch.core.lowrank``), so no dense (out, in)
    product is formed."""
    from .lowrank import svd_project_stacked
    B, A = svd_project_stacked(stacked_B, stacked_A, weights, r_out,
                               scales=scales)
    return B.to(stacked_B.dtype), A.to(stacked_A.dtype)
