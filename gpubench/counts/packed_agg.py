"""Bytes an RBLA round over stacked LoRA pairs needs, from shapes and the
cohort's ranks: each upload's live rows (rank rows of ``A``, rank
columns of ``B``) read once, the previous global's rows that no upload
owns read once, the weights read once and the new global written once.
The stacked copy of the cohort the program may make first is not work
the round needs."""
from __future__ import annotations

import math


def pair_bytes(a_shape, b_shape, ranks, r_max: int, itemsize: int = 4) -> int:
    """One pair: ``a_shape`` (..., r_max, fan_in), ``b_shape`` (...,
    fan_out, r_max), uploads at ``ranks``."""
    lead = math.prod(a_shape[:-2])
    row = lead * (a_shape[-1] + b_shape[-2]) * itemsize
    live = sum(min(int(r), r_max) for r in ranks)
    unowned = r_max - min(max(int(r) for r in ranks), r_max)
    return row * (live + unowned + r_max)


def round_bytes(pair_shapes, ranks, r_max: int, itemsize: int = 4) -> int:
    """Every pair of the tree (``[(a_shape, b_shape), ...]``), plus the
    cohort's weights."""
    return sum(pair_bytes(a, b, ranks, r_max, itemsize)
               for a, b in pair_shapes) + 4 * len(ranks)
