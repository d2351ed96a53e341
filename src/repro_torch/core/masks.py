"""Rank-row indicator masks (the paper's delta function, Eq. 6).

Adapters are stored padded to ``r_max``; the raggedness lives in these
masks: ``delta_{i,r} = 1`` iff client i's adapter holds row r (r < rank_i).
"""
from __future__ import annotations

import torch


def _rank_tensor(rank, device) -> torch.Tensor:
    return torch.as_tensor(rank, dtype=torch.int32, device=device)


def rank_mask(r_max: int, rank, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """``(r_max,)`` vector: 1 for rows < rank, 0 beyond (delta_{i,r})."""
    rank = _rank_tensor(rank, device)
    return (torch.arange(r_max, device=rank.device) < rank).to(dtype)


def axis_mask(shape: tuple[int, ...], axis: int, rank, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Broadcastable mask of ``shape`` that is 1 where ``index[axis] < rank``
    (axis 0 for LoRA ``A`` (r_max, fan_in), -1 for ``B`` (fan_out, r_max))."""
    axis = axis % len(shape)
    rank = _rank_tensor(rank, device)
    view = [1] * len(shape)
    view[axis] = shape[axis]
    iota = torch.arange(shape[axis], device=rank.device).reshape(view)
    return (iota < rank).to(dtype).expand(shape)


def stacked_rank_masks(r_max: int, ranks, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """``(n_clients, r_max)`` matrix of delta_{i,r} for stacked clients."""
    ranks = _rank_tensor(ranks, device)
    iota = torch.arange(r_max, device=ranks.device)[None, :]
    return (iota < ranks[:, None]).to(dtype)


def pad_to_rank(x: torch.Tensor, axis: int, r_max: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to size ``r_max``."""
    axis = axis % x.ndim
    cur = x.shape[axis]
    if cur > r_max:
        raise ValueError(f"cannot pad axis of size {cur} down to {r_max}")
    if cur == r_max:
        return x
    shape = list(x.shape)
    shape[axis] = r_max - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def slice_to_rank(x: torch.Tensor, axis: int, rank: int) -> torch.Tensor:
    """Client-side Alg. 2: the leading ``rank`` rows along ``axis``."""
    return x.narrow(axis % x.ndim, 0, rank)
