"""RBLA (the paper's Eq. 7) and the service's staleness weights, plainly.

A global adapter tree holds LoRA pairs ``{"A": (..., r_max, fan_in), "B":
(..., fan_out, r_max), "rank": (...)}``.  For a cohort of uploads with
live ranks ``rank_i`` and weights ``w_i``, rank row ``r`` of ``A`` (column
``r`` of ``B``) is ``sum_i d_ir w_i X_ir / sum_i d_ir w_i`` with ``d_ir =
[r < rank_i]``; a row no upload owns keeps the previous global's.  Every
rank leaf of the result is ``r_max``.  The staleness weight of an upload
``tau`` versions behind is ``n_examples * (1 + tau) ** -a`` (FedAsync's
polynomial schedule).
"""
from __future__ import annotations

import torch

from .precision import dtype, no_tf32


def staleness_weight(n_examples: float, tau: float, a: float) -> float:
    return float(n_examples) * (1.0 + float(tau)) ** (-float(a))


def _pairs(tree, path=()):
    if isinstance(tree, dict) and "A" in tree and "B" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _pairs(v, path + (i,))


def pairs(tree) -> dict:
    """{path: pair} of every LoRA pair in ``tree``."""
    return dict(_pairs(tree))


def map_pairs(tree, fn):
    """``tree`` with each LoRA pair ``q`` replaced by ``fn(q)``."""
    if isinstance(tree, dict) and "A" in tree and "B" in tree:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_pairs(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_pairs(v, fn) for v in tree)
    return tree


@no_tf32()
def eq7(prev, uploads, weights, ranks, r_max: int,
        precision: str = "fp64") -> dict:
    """{path: {"A", "B", "rank"}}: the new global over ``uploads`` (trees
    shaped as ``prev``) at ``precision``, accumulated client by client."""
    dt = dtype(precision)
    ups = [pairs(u) for u in uploads]
    out = {}
    for path, pp in pairs(prev).items():
        a_prev, b_prev = pp["A"], pp["B"]
        rows = torch.arange(r_max, device=a_prev.device)
        num_a = torch.zeros(a_prev.shape, dtype=dt, device=a_prev.device)
        num_b = torch.zeros(b_prev.shape, dtype=dt, device=b_prev.device)
        den = torch.zeros(r_max, dtype=dt, device=a_prev.device)
        for up, w, rk in zip(ups, weights, ranks):
            own = (rows < int(rk)).to(dt) * torch.tensor(
                float(w), dtype=dt, device=a_prev.device)
            num_a += up[path]["A"].to(dt) * own[:, None]
            num_b += up[path]["B"].to(dt) * own
            den += own
        owned = den > 0
        safe = torch.where(owned, den, torch.ones_like(den))
        a = torch.where(owned[:, None], num_a / safe[:, None],
                        a_prev.to(dt))
        b = torch.where(owned, num_b / safe, b_prev.to(dt))
        out[path] = {"A": a, "B": b,
                     "rank": torch.full_like(pp["rank"], r_max)}
    return out
