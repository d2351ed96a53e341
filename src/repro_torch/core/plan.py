"""Compiled aggregation plans: packed cohort buffers, one launch per bucket.

Walking the adapter tree pair by pair costs two kernel launches per pair.
A plan turns a round into

1. **Pack.**  Every adapter pair of the cohort is flattened into a few
   packed ``(n_clients, rows, width)`` buffers, **bucketed by (row width,
   dtype)**.  A factors contribute their rank rows directly; B factors ride
   transposed so the rank axis leads everywhere.  Each packed row carries
   its owner mask column (delta_{i,r}), which is static given the cohort's
   rank multiset, so the whole ``(n, rows)`` owner-mask matrix is built on
   the host once per plan.  Layer-stacked pairs pack like everything else:
   layer ``l`` occupies its own rows with its own mask column.
2. **Combine.**  One ``packed_agg`` launch per bucket (the plain version on
   the ``ref`` backend), with ``prev_global`` retention and rbla_norm's
   norm restoration fused in.
3. **Cache.**  Plans are cached on the strategy instance keyed by the
   :class:`CohortSpec` (tree structure, shapes, dtypes, rank multiset,
   backend, device) in a bounded LRU; see ``AggregationStrategy.plan``.

This slice lowers the mean family (``plan_mode`` "mean" and "mean_norm").
The per-leaf ``aggregate_tree*`` methods remain the plans' oracles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.rbla_agg import packed_agg, packed_agg_ref

PyTree = Any


class PlanUnavailable(Exception):
    """A plan cannot be built for these inputs (bare leaves, mismatched
    prev shapes); callers take the per-leaf path, which handles
    everything."""


# ------------------------------------------------------------- cohort spec --
def _is_pair(node) -> bool:
    return (isinstance(node, Mapping) and "A" in node and "B" in node
            and "rank" in node)


def _walk_pairs(tree, path=()):
    """Yield ``(path, pair)`` for every LoRA pair; raise
    :class:`PlanUnavailable` on bare tensor leaves."""
    if _is_pair(tree):
        yield path, tree
        return
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk_pairs(v, path + (k,))
        return
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk_pairs(v, path + (i,))
        return
    if tree is None:
        return
    raise PlanUnavailable(f"bare leaf of type {type(tree).__name__} at "
                          f"{path}; plans pack whole LoRA pairs")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class PairMeta:
    """Static description of one stacked LoRA pair in a cohort."""
    path: tuple
    a_shape: tuple
    a_dtype: torch.dtype
    b_shape: tuple
    b_dtype: torch.dtype
    rank_shape: tuple          # stacked rank leaf shape, incl. client axis
    ranks: tuple               # flattened stacked rank values
    prev_a_shape: tuple | None = None
    prev_b_shape: tuple | None = None

    def rank_values(self) -> np.ndarray:
        return np.asarray(self.ranks, np.int64).reshape(self.rank_shape)


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """Hashable plan-cache key: everything a plan closes over."""
    n_clients: int
    kind: str                       # resolved backend: "ref" | "kernel"
    r_max: int | None
    pairs: tuple[PairMeta, ...]
    client_ranks: tuple | None
    has_prev: bool
    device: str


def build_cohort_spec(stacked_tree: PyTree, *, kind: str,
                      r_max: int | None = None, client_ranks=None,
                      prev_tree: PyTree | None = None) -> CohortSpec:
    """Describe a stacked cohort host-side; raises :class:`PlanUnavailable`
    for trees with bare leaves or unstacked pairs."""
    if client_ranks is not None:
        client_ranks = tuple(int(v) for v in _host(client_ranks).ravel())
    prev_pairs = (dict(_walk_pairs(prev_tree))
                  if prev_tree is not None else {})
    pairs = []
    device = None
    for path, pair in _walk_pairs(stacked_tree):
        A, B = pair["A"], pair["B"]
        if A.ndim < 3 or B.ndim < 3:
            raise PlanUnavailable(f"pair at {path} is not stacked over "
                                  "clients")
        device = device or str(A.device)
        rk = _host(pair["rank"])
        meta = dict(path=path, a_shape=tuple(A.shape), a_dtype=A.dtype,
                    b_shape=tuple(B.shape), b_dtype=B.dtype,
                    rank_shape=tuple(rk.shape),
                    ranks=tuple(int(v) for v in rk.ravel()))
        if prev_tree is not None:
            if path not in prev_pairs:
                raise PlanUnavailable(f"prev tree missing pair at {path}")
            pp = prev_pairs[path]
            meta.update(prev_a_shape=tuple(pp["A"].shape),
                        prev_b_shape=tuple(pp["B"].shape))
        pairs.append(PairMeta(**meta))
    if not pairs:
        raise PlanUnavailable("no LoRA pairs in the cohort tree")
    return CohortSpec(n_clients=pairs[0].a_shape[0], kind=kind, r_max=r_max,
                      pairs=tuple(pairs), client_ranks=client_ranks,
                      has_prev=prev_tree is not None, device=device)


# ---------------------------------------------------------- packed layout --
@dataclasses.dataclass
class Slot:
    """One pair side's home inside a packed bucket."""
    pair_idx: int
    side: str                  # "A" | "B"
    lead: tuple                # leading (layer/expert) dims
    r_st: int                  # storage rank rows per lead index
    rows: int                  # prod(lead) * r_st
    width: int
    dtype: torch.dtype
    offset: int = 0            # row offset inside the bucket


@dataclasses.dataclass
class Bucket:
    """All slots sharing (row width, dtype): one launch per round."""
    width: int
    dtype: torch.dtype
    slots: list
    rows: int = 0
    mask: np.ndarray | None = None     # (n, rows) owner mask, host-built


def _side_geometry(meta: PairMeta, side: str):
    shape = meta.a_shape if side == "A" else meta.b_shape
    lead = tuple(shape[1:-2])
    if side == "A":
        r_st, width, dtype = shape[-2], shape[-1], meta.a_dtype
    else:
        r_st, width, dtype = shape[-1], shape[-2], meta.b_dtype
    rows = int(np.prod(lead, dtype=np.int64)) * r_st if lead else r_st
    return lead, int(r_st), int(rows), int(width), dtype


def _slot_mask(meta: PairMeta, slot: Slot, n: int,
               use_mask: bool) -> np.ndarray:
    """Per-row owner mask (n, rows): row (l, j) of client i is owned iff
    j < rank_i[l] -- the delta_{i,r} indicator in packed-row form."""
    if not use_mask:
        return np.ones((n, slot.rows), np.float32)
    rk = meta.rank_values()                      # (n, *rank_leaf_shape)
    mid = len(slot.lead) - (rk.ndim - 1)
    r = rk.reshape(rk.shape + (1,) * mid + (1,))
    m = np.arange(slot.r_st).reshape((1,) * (1 + len(slot.lead))
                                     + (slot.r_st,)) < r
    m = np.broadcast_to(m, (n,) + slot.lead + (slot.r_st,))
    return np.ascontiguousarray(m.reshape(n, slot.rows).astype(np.float32))


def _make_buckets(spec: CohortSpec, use_mask: bool) -> list:
    buckets: dict = {}
    for pi, meta in enumerate(spec.pairs):
        for side in ("A", "B"):
            lead, r_st, rows, width, dtype = _side_geometry(meta, side)
            b = buckets.setdefault((width, dtype),
                                   Bucket(width=width, dtype=dtype, slots=[]))
            b.slots.append(Slot(pair_idx=pi, side=side, lead=lead,
                                r_st=r_st, rows=rows, width=width,
                                dtype=dtype, offset=b.rows))
            b.rows += rows
    out = list(buckets.values())
    for b in out:
        b.mask = np.concatenate(
            [_slot_mask(spec.pairs[s.pair_idx], s, spec.n_clients, use_mask)
             for s in b.slots], axis=1)
    return out


def pair_side_rows(x: torch.Tensor, side: str) -> torch.Tensor:
    """Rank-axis-leading row view of one pair side: A ``(..., r, fan_in)``
    passes through, B ``(..., fan_out, r)`` rides transposed to
    ``(..., r, fan_out)``.  Applying it twice restores the leaf layout."""
    return x.transpose(-1, -2) if side == "B" else x


def _pack_side(x: torch.Tensor, slot: Slot) -> torch.Tensor:
    """(n, *lead, ...) leaf -> (n, rows, width) f32, rank axis leading."""
    return pair_side_rows(x, slot.side).reshape(
        x.shape[0], slot.rows, slot.width).float()


def _pack_prev_side(x: torch.Tensor, slot: Slot) -> torch.Tensor:
    """Like :func:`_pack_side` for an unstacked (server-state) leaf."""
    return pair_side_rows(x, slot.side).reshape(slot.rows, slot.width).float()


def _unpack_slot(out: torch.Tensor, slot: Slot) -> torch.Tensor:
    """(rows, width) f32 block -> the slot's leaf layout (contiguous)."""
    y = out[slot.offset:slot.offset + slot.rows]
    y = y.reshape(slot.lead + (slot.r_st, slot.width))
    return pair_side_rows(y, slot.side).to(slot.dtype).contiguous()


def _gather(parts: list, dim: int) -> torch.Tensor:
    """One contiguous buffer of ``parts`` joined along ``dim``."""
    return torch.cat(parts, dim=dim) if len(parts) > 1 else \
        parts[0].contiguous()


# ------------------------------------------------------- tree (re)building --
def _make_rebuilder(tree) -> Callable:
    """Recipe to rebuild ``tree``'s container structure from a flat list
    of per-pair replacements (in :func:`_walk_pairs` order)."""
    counter = [0]

    def recipe(t):
        if _is_pair(t):
            counter[0] += 1
            return ("pair", counter[0] - 1)
        if isinstance(t, Mapping):
            return ("map", {k: recipe(v) for k, v in t.items()})
        if isinstance(t, (tuple, list)):
            return ("seq", type(t), [recipe(v) for v in t])
        return ("leaf", t)

    r = recipe(tree)

    def rebuild(pairs: Sequence):
        def go(node):
            tag = node[0]
            if tag == "pair":
                return pairs[node[1]]
            if tag == "map":
                return {k: go(v) for k, v in node[1].items()}
            if tag == "seq":
                return node[1](go(v) for v in node[2])
            return node[1]
        return go(r)
    return rebuild


def _ab_list(tree) -> list:
    return [{"A": p["A"], "B": p["B"]} for _, p in _walk_pairs(tree)]


# ------------------------------------------------------------ the product --
class CompiledRound:
    """One aggregation round for a fixed :class:`CohortSpec`.

    ``__call__(stacked_tree, weights, prev_tree=None)`` runs the round.
    ``kind`` is "packed" (one launch per bucket) or "eager" (the per-leaf
    path); ``n_kernel_launches`` is the packed plan's launches per round
    (#buckets).
    """

    def __init__(self, strategy, spec: CohortSpec, kind: str,
                 execute: Callable, *, n_kernel_launches: int | None = None):
        self.strategy = strategy
        self.spec = spec
        self.kind = kind
        self._execute = execute
        self.n_kernel_launches = n_kernel_launches

    def __call__(self, stacked_tree: PyTree, weights,
                 prev_tree=None) -> PyTree:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=self.spec.device)
        return self._execute(stacked_tree, w, prev_tree)


def _out_rank_leaves(spec: CohortSpec) -> list:
    """Finalized rank leaves: r_max (or the storage rank) everywhere."""
    return [torch.full(tuple(meta.rank_shape[1:]),
                       int(spec.r_max if spec.r_max is not None
                           else meta.a_shape[-2]),
                       dtype=torch.int32, device=spec.device)
            for meta in spec.pairs]


def _client_ranks(spec: CohortSpec):
    if spec.client_ranks is None:
        return None
    return torch.tensor(spec.client_ranks, dtype=torch.int32,
                        device=spec.device)


# ------------------------------------------------------ packed mean plans --
def _build_mean_round(strategy, spec: CohortSpec,
                      norm_restore: bool = False) -> CompiledRound:
    buckets = _make_buckets(spec, strategy.use_mask)
    retains = strategy.retains_prev and spec.has_prev
    if retains:
        for meta in spec.pairs:       # mean plans overlay prev row for row
            if (meta.prev_a_shape != meta.a_shape[1:]
                    or meta.prev_b_shape != meta.b_shape[1:]):
                raise PlanUnavailable(
                    "prev leaf shapes differ from the cohort's")
    cr = _client_ranks(spec)
    rank_leaves = _out_rank_leaves(spec)
    masks = [torch.as_tensor(b.mask, device=spec.device) for b in buckets]
    norm_by = strategy.norm_by
    rebuild = [None]

    def execute(stacked_tree, w, prev_tree):
        if rebuild[0] is None:
            rebuild[0] = _make_rebuilder(stacked_tree)
        ab = _ab_list(stacked_tree)
        prev_ab = _ab_list(prev_tree) if retains else None
        wt = strategy.transform_weights(w, cr)
        outs = []
        for bi, b in enumerate(buckets):
            x = _gather([_pack_side(ab[s.pair_idx][s.side], s)
                         for s in b.slots], dim=1)
            prev = None
            if retains:
                prev = _gather([_pack_prev_side(prev_ab[s.pair_idx][s.side],
                                                s) for s in b.slots], dim=0)
            if spec.kind == "kernel":
                out = packed_agg(x, masks[bi], wt, prev, norm_by=norm_by,
                                 norm_restore=norm_restore, backend="kernel")
            else:
                out = packed_agg_ref(x, masks[bi], wt, prev, norm_by=norm_by,
                                     norm_restore=norm_restore)
            outs.append(out)
        unpacked = [{} for _ in spec.pairs]
        for bi, b in enumerate(buckets):
            for s in b.slots:
                unpacked[s.pair_idx][s.side] = _unpack_slot(outs[bi], s)
        return rebuild[0]([{"A": u["A"], "B": u["B"], "rank": rank_leaves[i]}
                           for i, u in enumerate(unpacked)])

    return CompiledRound(strategy, spec, "packed", execute,
                         n_kernel_launches=len(buckets))


def _build_eager_round(strategy, spec: CohortSpec) -> CompiledRound:
    """The per-leaf path behind a plan's interface (cohorts a packed plan
    cannot take)."""
    cr = _client_ranks(spec)

    def execute(stacked_tree, w, prev_tree):
        from repro_torch.lora import adapter_masks
        prev = prev_tree if strategy.retains_prev else None
        if spec.kind == "kernel":
            out = strategy.aggregate_tree_kernel(stacked_tree, w, cr, prev,
                                                 r_max=spec.r_max)
        else:
            masks = adapter_masks(stacked_tree)
            out = strategy.aggregate_tree(stacked_tree, masks, w, prev,
                                          r_max=spec.r_max, client_ranks=cr)
        return strategy.finalize_tree(out, spec.r_max)

    return CompiledRound(strategy, spec, "eager", execute)


def build_plan(strategy, spec: CohortSpec) -> CompiledRound:
    """The :class:`CompiledRound` for ``strategy`` x ``spec``.

    ``plan_mode`` "mean" packs every cohort; "mean_norm" (rbla_norm) packs
    scalar-rank pairs and leaves layer-stacked ones to the per-leaf path
    (which refuses them)."""
    mode = getattr(strategy, "plan_mode", None)
    try:
        if mode == "mean":
            return _build_mean_round(strategy, spec)
        if mode == "mean_norm" and all(len(m.a_shape) == 3
                                       for m in spec.pairs):
            return _build_mean_round(strategy, spec, norm_restore=True)
    except PlanUnavailable:
        pass
    return _build_eager_round(strategy, spec)


__all__ = ["CohortSpec", "PairMeta", "CompiledRound", "PlanUnavailable",
           "build_cohort_spec", "build_plan", "pair_side_rows"]
