"""The numbers a check compares: gaps of the program's outputs from the
reference's, each a single float, the larger the worse."""
from __future__ import annotations

import math

import torch


def max_rel(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest absolute gap over the reference's largest magnitude."""
    r = ref.double()
    gap = (prog.double() - r).abs().max().item()
    top = r.abs().max().item()
    return gap / top if top > 0 else gap


def tree_max_rel(prog_pairs: dict, ref_pairs: dict) -> tuple[float, int]:
    """The worst :func:`max_rel` over the ``A`` and ``B`` leaves of two
    ``{path: pair}`` maps, and the number of rank leaves that differ."""
    worst, rank_off = 0.0, 0
    if set(prog_pairs) != set(ref_pairs):
        return math.inf, 1
    for path, rp in ref_pairs.items():
        pp = prog_pairs[path]
        for side in ("A", "B"):
            worst = max(worst, max_rel(pp[side], rp[side]))
        rank_off += int((pp["rank"].long() != rp["rank"].long()).sum())
    return worst, rank_off


def rel_l2(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """``||prog - ref|| / ||ref||`` over the last axis, the worst row."""
    p = prog.double().reshape(-1, prog.shape[-1])
    r = ref.double().reshape(-1, ref.shape[-1])
    num = (p - r).norm(dim=-1)
    den = r.norm(dim=-1).clamp_min(1e-300)
    return float((num / den).max())


def norm_gaps(prog: dict, ref: dict, floor_share: float = 1e-3):
    """Leaf by leaf, ``| ||prog|| - ||ref|| |`` over the larger of the
    reference leaf's norm and the median leaf's; leaves whose reference
    norm is under ``floor_share`` of the median's are left out (nought to
    rounding).  Returns (worst gap, leaves compared, leaves left out)."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    worst, used, skipped = 0.0, 0, 0
    for k, rn in norms.items():
        if rn < floor_share * med:
            skipped += 1
            continue
        pn = float(prog[k].double().norm())
        worst = max(worst, abs(pn - rn) / max(rn, med))
        used += 1
    return worst, used, skipped
