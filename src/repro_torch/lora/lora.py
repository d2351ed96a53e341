"""LoRA adapter substrate with heterogeneous-rank support.

Adapters are nested dicts of tensors:

    pair = {"A": (r_max, fan_in), "B": (fan_out, r_max), "rank": () int32}

Storage is padded to ``r_max``; the live rank is an int32 tensor.  Rows of
``A`` / columns of ``B`` at index >= rank are zero and are re-zeroed after
every optimizer step.  The effective update is ``(alpha / rank) * B @ A``.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from repro_torch.core.masks import pad_to_rank
from repro_torch.tree import tree_leaves

PyTree = Any

DEFAULT_ALPHA = 16.0


def init_pair(gen: torch.Generator, fan_out: int, fan_in: int, r_max: int,
              rank, dtype=torch.float32, init_scale: float = 0.01,
              leading: tuple[int, ...] = ()) -> dict:
    """A ~ N(0, init_scale) on live rows, B = 0 (standard LoRA init), on
    ``gen``'s device.  ``leading`` adds stacked axes; the rank is then
    ``(leading[0],)``."""
    device = gen.device
    a = torch.randn(leading + (r_max, fan_in), generator=gen, dtype=dtype,
                    device=device) * init_scale
    rank_arr = torch.full(leading[:1], int(rank), dtype=torch.int32,
                          device=device)
    return mask_pair({"A": a,
                      "B": torch.zeros(leading + (fan_out, r_max),
                                       dtype=dtype, device=device),
                      "rank": rank_arr})


def is_pair(node: Any) -> bool:
    return (isinstance(node, Mapping) and "A" in node and "B" in node
            and "rank" in node)


def pair_scale(pair: Mapping, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    return alpha / pair["rank"].float().clamp(min=1.0)


def apply_pair(x: torch.Tensor, pair: Mapping,
               alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """``(alpha/rank) * (x @ A^T) @ B^T``: (..., fan_in) -> (..., fan_out)."""
    y = (x @ pair["A"].to(x.dtype).T) @ pair["B"].to(x.dtype).T
    return y * pair_scale(pair, alpha).to(x.dtype)


def merge_pair(w: torch.Tensor, pair: Mapping,
               alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """``W + (alpha/rank) B A`` (serving-time merged weights)."""
    delta = pair["B"].float() @ pair["A"].float()
    return (w.float() + pair_scale(pair, alpha) * delta).to(w.dtype)


def _pair_row_masks(pair: Mapping, dtype=torch.float32):
    """Broadcastable masks for A (..., r_max, fan_in) / B (..., out, r_max);
    the rank is a scalar or ``(leading,)`` for layer-stacked pairs."""
    A, B = pair["A"], pair["B"]
    rank = torch.as_tensor(pair["rank"], dtype=torch.int32, device=A.device)
    r_max = A.shape[-2]
    m = (torch.arange(r_max, device=A.device) < rank[..., None]).to(dtype)
    ma = m.reshape(rank.shape + (1,) * (A.ndim - rank.ndim - 2) + (r_max, 1))
    mb = m.reshape(rank.shape + (1,) * (B.ndim - rank.ndim - 2) + (1, r_max))
    return ma, mb


def mask_pair(pair: Mapping) -> dict:
    """Re-zero padded rows/cols (always fresh tensors)."""
    ma, mb = _pair_row_masks(pair, pair["A"].dtype)
    return {"A": pair["A"] * ma, "B": pair["B"] * mb, "rank": pair["rank"]}


def pair_masks(pair: Mapping) -> dict:
    """delta_{i,r} masks matching the pair's structure; ``rank`` is marked
    fully shared (a 0-d one)."""
    ma, mb = _pair_row_masks(pair)
    return {"A": ma, "B": mb,
            "rank": torch.ones((), device=pair["A"].device)}


def tree_map_pairs(fn: Callable[[Mapping], Any], tree: PyTree) -> PyTree:
    """Map ``fn`` over every LoRA pair in a nested adapter tree."""
    if is_pair(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: tree_map_pairs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_pairs(fn, v) for v in tree)
    return tree


def adapter_masks(adapters: PyTree) -> PyTree:
    return tree_map_pairs(pair_masks, adapters)


def mask_adapters(adapters: PyTree) -> PyTree:
    return tree_map_pairs(mask_pair, adapters)


def set_ranks(adapters: PyTree, rank, r_storage: int | None = None) -> PyTree:
    """Client-side Alg. 2: set the live rank and re-mask (slice + re-pad).

    ``r_storage`` re-cuts the storage rank (slice off beyond it, zero-pad
    up to it).  Every returned tensor is freshly allocated: a client that
    updates its adapters in place can never write into the server's."""
    rank = int(rank)
    if r_storage is not None and rank > r_storage:
        raise ValueError(
            f"set_ranks: live rank {rank} exceeds the target storage rank "
            f"{r_storage}; the pair's rank leaf would claim rows that do not "
            "physically exist")

    def f(pair):
        A, B = pair["A"], pair["B"]
        if r_storage is not None:
            if A.shape[-2] >= r_storage:
                A = A[..., :r_storage, :]
                B = B[..., :r_storage]
            else:
                A = pad_to_rank(A, -2, r_storage)
                B = pad_to_rank(B, -1, r_storage)
        out = {"A": A, "B": B,
               "rank": torch.full_like(torch.as_tensor(pair["rank"],
                                                       dtype=torch.int32),
                                       rank)}
        return mask_pair(out)       # the mask multiply allocates new A, B
    return tree_map_pairs(f, adapters)


def strip_ranks(adapters: PyTree) -> tuple[PyTree, PyTree]:
    """Split pairs into the trainable factors and the int rank leaves."""
    factors = tree_map_pairs(lambda p: {"A": p["A"], "B": p["B"]}, adapters)
    ranks = tree_map_pairs(lambda p: p["rank"], adapters)
    return factors, ranks


def attach_ranks(factors: PyTree, ranks: PyTree) -> PyTree:
    if isinstance(factors, Mapping) and "A" in factors and "B" in factors:
        return {"A": factors["A"], "B": factors["B"], "rank": ranks}
    if isinstance(factors, (tuple, list)):
        return type(factors)(attach_ranks(f, r)
                             for f, r in zip(factors, ranks))
    return {k: attach_ranks(factors[k], ranks[k]) for k in factors}


def init_adapters(gen: torch.Generator, specs: Mapping[str, tuple[int, int]],
                  r_max: int, rank, dtype=torch.float32) -> PyTree:
    """Adapter tree from ``{path: (fan_out, fan_in)}`` specs, drawn in
    sorted path order from ``gen``."""
    return {path: init_pair(gen, fo, fi, r_max, rank, dtype)
            for path, (fo, fi) in sorted(specs.items())}


def count_params(adapters: PyTree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(adapters))
