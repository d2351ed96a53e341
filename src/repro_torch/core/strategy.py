"""Aggregation strategies: one pluggable API over every path.

Each method is one :class:`AggregationStrategy` that owns

* (a) its **leaf math** (:meth:`AggregationStrategy.leaf`),
* (b) its **tree traversal** with ``prev_global`` retention
  (:meth:`AggregationStrategy.aggregate_tree`, the ``ref`` backend),
* (c) a **per-pair kernel path**
  (:meth:`AggregationStrategy.aggregate_tree_kernel`), and
* (d) a **compiled plan** (``repro_torch.core.plan``): every pair side of
  the round in its own layout, one grouped ``packed_agg`` launch per
  round -- the default route of
  :meth:`AggregationStrategy.aggregate_adapters`, and
* (e) a **per-update fold** for the async aggregation service
  (:meth:`AggregationStrategy.fold` and the ``supports_incremental``
  declaration; see ``repro_torch.fl.async_agg``): every leaf of the server
  state and the arriving update is one segment of a single grouped
  ``axpy_fold`` call per fold (one launch per dtype triple), and
* (f) a **distributed path** over ``torch.distributed``
  (:meth:`AggregationStrategy.aggregate_tree_distributed`,
  :meth:`AggregationStrategy.make_distributed_aggregator`,
  :meth:`AggregationStrategy.allreduce_leaf`, and the mean family's
  collective round in ``repro_torch.core.plan``; the SPMD contract is in
  ``repro_torch.core.distributed``),

behind ``backend="auto" | "ref" | "kernel" | "distributed"`` (``"pallas"``
is an alias of ``"kernel"``): ``auto`` runs the kernels for tensors on a
CUDA device and the plain PyTorch versions for tensors on the CPU.

The port runs the mean family (fedavg, zeropad, rbla, rbla_ranked,
rbla_norm), the robust family (rbla_clipped, rbla_trimmed, rbla_median),
svd (product-space aggregation through ``repro_torch.core.lowrank``) and
flora (rank-growing stacking), on plain or encoded (int8/bf16,
``repro_torch.core.codec``) uploads, one cohort at a time or one update at
a time.  ``supports_distributed`` declares the strategies with a
distributed path, as in the JAX package: rbla_norm and the robust family
have none and refuse it.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from collections import OrderedDict
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.rbla_agg import (axpy_fold_group,
                                          axpy_fold_group_ref,
                                          flora_stack_group, packed_agg_group,
                                          packed_robust_group,
                                          packed_robust_group_ref,
                                          rbla_agg_group)
from repro_torch.kernels.runtime import (BACKENDS, resolve_backend,
                                        resolve_device)
from repro_torch.obs.trace import count, read_back, trace_span
from repro_torch.tree import tree_leaves, tree_map

from .aggregation import _EPS, fedavg_leaf, rbla_leaf, zeropad_leaf
from .compat import all_gather_slices, all_reduce_sum, local_slice
from .lowrank import product_factors, svd_project_stacked
from .masks import pad_to_rank, stacked_rank_masks
from .plan import host_array
from .variants import rank_proportional_weights, rbla_norm_leaf

PyTree = Any

#: per-strategy-instance LRU bound on cached plans (keyed by the cohort's
#: rank multiset among other things; a random-cohort service sees many)
PLAN_CACHE_SIZE = 128


# ------------------------------------------------------------ server state --
@dataclasses.dataclass
class ServerState:
    """The FL server's round state (what Alg. 1 carries between rounds).
    ``current_rank`` mirrors ``adapters`` with each pair replaced by its
    live-rank leaf."""
    adapters: PyTree | None            # global LoRA adapters (None in FFT)
    base_trainable: PyTree             # non-LoRA trainables (or full params)
    round: int = 0
    r_max: int | None = None
    client_ranks: torch.Tensor | None = None   # last cohort's ranks
    current_rank: PyTree | None = None


@dataclasses.dataclass
class ClientUpdate:
    """One participant's upload for a round."""
    adapters: PyTree | None
    base_trainable: PyTree
    n_examples: float = 1.0
    rank: int | None = None


@dataclasses.dataclass
class FoldState:
    """Accumulator threaded through a sequence of per-update folds.

    ``mass``: accumulated raw weight mass (the running mean's denominator
    for base trainables and ``norm_by="weight"`` strategies).
    ``row_mass``: per-pair per-rank-row owner mass (Eq. 7's denominator in
    streaming form): the adapters with each pair replaced by a
    ``rank_leaf_shape + (r_storage,)`` fp32 tensor, or ``None``.
    ``n_folds``: updates folded since the anchor.  ``extra``: strategy-
    private bookkeeping (flora's segment ledger).  ``momentum``: the
    service's server-momentum buffer over the adapters' float leaves, or
    ``None``."""
    mass: float = 0.0
    row_mass: PyTree | None = None
    n_folds: int = 0
    extra: Any = None
    momentum: PyTree | None = None


# ---------------------------------------------------------------- registry --
_REGISTRY: dict[str, "AggregationStrategy"] = {}


def register_strategy(cls):
    """Class decorator: instantiate ``cls`` and register it under
    ``cls.name`` (plus ``cls.aliases``).  Duplicate names raise."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} needs a non-empty .name")
    names = (inst.name,) + tuple(inst.aliases)
    taken = [n for n in names if n in _REGISTRY]
    if taken:
        raise ValueError(
            f"strategy name(s) {taken} already registered (by "
            f"{type(_REGISTRY[taken[0]]).__name__})")
    for n in names:
        _REGISTRY[n] = inst
    return cls


def get_strategy(name: "str | AggregationStrategy") -> "AggregationStrategy":
    """Resolve a strategy by registry name (or pass an instance through)."""
    if isinstance(name, AggregationStrategy):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown aggregation strategy {name!r}; registered: "
                     f"{list_strategies()}")


def list_strategies() -> list[str]:
    """Sorted primary names of every registered strategy."""
    return sorted({s.name for s in _REGISTRY.values()})


# ------------------------------------------------------------ tree helpers --
def stack_trees(trees: Sequence[PyTree]) -> PyTree:
    """Stack per-client trees leafwise into (n_clients, *leaf) tensors."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _squeeze_mask(m):
    """0-d mask means 'fully shared leaf' -> None (no rank masking)."""
    return None if (m is not None and m.ndim == 0) else m


def _is_pair(node) -> bool:
    return (isinstance(node, Mapping) and "A" in node and "B" in node
            and "rank" in node)


def _map_pairs(fn, tree, *rest, strict: bool = False):
    """Map ``fn`` over every LoRA pair of ``tree`` (and parallel ``rest``
    trees, which may be ``None``).  ``strict`` raises on bare leaves."""
    if _is_pair(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: _map_pairs(fn, v, *[None if r is None else r[k]
                                       for r in rest], strict=strict)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _map_pairs(fn, v, *[None if r is None else r[i] for r in rest],
                       strict=strict) for i, v in enumerate(tree))
    if strict and tree is not None:
        raise NotImplementedError(
            "this strategy aggregates whole LoRA pairs ({'A','B','rank'}); "
            f"got a bare leaf of type {type(tree).__name__}")
    return tree


def _fix_rank(tree: PyTree, r_max: int | None) -> PyTree:
    """Reset every pair's live rank to r_max: the server keeps the full
    stack; clients re-slice per Alg. 2."""
    def fix(pair):
        p = dict(pair)
        rm = p["A"].shape[-2] if r_max is None else r_max
        p["rank"] = torch.full_like(p["rank"].to(torch.int32), rm)
        return p
    return _map_pairs(fix, tree)


def adapter_live_ranks(tree: PyTree) -> PyTree:
    """Every LoRA pair replaced by its rank leaf."""
    return _map_pairs(lambda p: p["rank"].to(torch.int32), tree)


def _infer_ranks(stacked_tree: PyTree) -> torch.Tensor | None:
    """The per-client rank vector of the first scalar-rank stacked pair."""
    found = []

    def visit(pair):
        if pair["rank"].ndim == 1:
            found.append(pair["rank"].to(torch.int32))
        return pair
    _map_pairs(visit, stacked_tree)
    return found[0] if found else None


def _collect_pairs(tree: PyTree, prev: PyTree | None) -> tuple:
    """Every LoRA pair of ``tree`` with its ``prev`` pair (None without),
    in traversal order, and the tree with each pair replaced by a
    :class:`_Slot` of its index (for :func:`_place_pairs`).  Bare leaves
    raise, as ``_map_pairs(strict=True)``."""
    found: list = []

    def grab(pair, prev_pair):
        found.append((pair, prev_pair))
        return _Slot(len(found) - 1)
    return _map_pairs(grab, tree, prev, strict=True), found


@functools.lru_cache(maxsize=256)
def _rank_leaf(shape: tuple, rank: int, device: torch.device) -> torch.Tensor:
    """An output pair's rank leaf: ``rank`` int32 of ``shape``, made once
    per (shape, rank, device) and shared, as a compiled plan shares its
    rank leaves between rounds (a new one would cost a fill launch a pair)."""
    return torch.full(shape, rank, dtype=torch.int32, device=device)


def _place_pairs(skeleton: PyTree, outs: Sequence) -> PyTree:
    """:func:`_collect_pairs`'s tree with slot i replaced by ``outs[i]``."""
    if isinstance(skeleton, _Slot):
        return outs[skeleton.index]
    if isinstance(skeleton, Mapping):
        return {k: _place_pairs(v, outs) for k, v in skeleton.items()}
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_place_pairs(v, outs) for v in skeleton)
    return skeleton


def _flat_pair_values(tree: PyTree) -> list:
    """Values at the pair positions of a ``_map_pairs`` output whose pairs
    were replaced by bare values (a ``row_mass`` tree), in traversal
    order."""
    vals: list = []

    def go(t):
        if isinstance(t, Mapping) and not _is_pair(t):
            for v in t.values():
                go(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                go(v)
        elif t is not None:
            vals.append(t)
    go(tree)
    return vals


def _pairs(tree) -> list:
    out: list = []
    _map_pairs(lambda p: out.append(p) or p, tree)
    return out


def _device_of(tree) -> torch.device | None:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else None


def _state_device(state: ServerState) -> torch.device:
    """Where a server state lives: the device of its first tensor."""
    got = _device_of(state.adapters) or _device_of(state.base_trainable)
    return got if got is not None else torch.device("cpu")


def _retain_prev(tree: PyTree, prev: PyTree, client_ranks) -> PyTree:
    """Rank rows no participant owns keep the server's current value: row r
    is owned iff r < max(participant ranks), the per-element ``den > 0``
    test for rank-row masks and positive weights."""
    rmax = int(torch.as_tensor(client_ranks).max())

    def fix(pair, prev_pair):
        A, B = pair["A"], pair["B"]
        owned = torch.arange(A.shape[-2], device=A.device) < rmax
        return {"A": torch.where(owned[:, None], A,
                                 prev_pair["A"].to(A.dtype)),
                "B": torch.where(owned[None, :], B,
                                 prev_pair["B"].to(B.dtype)),
                "rank": pair["rank"]}
    return _map_pairs(fix, tree, prev)


def _gather_cohort(stacked_tree: PyTree, weights: torch.Tensor,
                   client_ranks, group) -> tuple:
    """Each rank's slice of the cohort, gathered to every rank in one
    ``all_gather``: per client, every leaf of the stacked tree (factors and
    rank leaves), its weight and its rank (when given) ride as one fp32 row,
    and come back in their own dtypes (bf16 and int32 round-trip fp32
    exactly).  Returns the whole cohort's ``(stacked_tree, weights,
    client_ranks)``; without a group, the inputs as they are."""
    if group is None:
        return stacked_tree, weights, client_ranks
    n = int(weights.shape[0])
    loc = local_slice(n, group)
    leaves = tree_leaves(stacked_tree) + [weights]
    if client_ranks is not None:
        leaves.append(torch.as_tensor(client_ranks, device=weights.device))
    widths = [t[0].numel() for t in leaves]
    rows = all_gather_slices(torch.cat(
        [t[loc].reshape(loc.stop - loc.start, wd).float()
         for t, wd in zip(leaves, widths)], 1), n, group)
    full = [part.reshape(t.shape).to(t.dtype)
            for part, t in zip(torch.split(rows, widths, 1), leaves)]
    it = iter(full)
    tree = tree_map(lambda _: next(it), stacked_tree)
    w = next(it)
    return tree, w, (next(it) if client_ranks is not None else None)


# ------------------------------------------------------------ the protocol --
class AggregationStrategy:
    """One server-side aggregation method, every execution path.

    Subclasses set the class attributes and implement :meth:`leaf` (or
    override :meth:`aggregate_tree` for pair-structured methods)."""
    name: str = ""
    aliases: tuple[str, ...] = ()
    #: denominator of the weighted mean: "mask" = sum_i w_i * delta_ir
    #: (RBLA Eq. 7), "weight" = sum_i w_i (zero-padding dilution / FedAvg)
    norm_by: str = "mask"
    #: apply delta_{i,r} rank-row masks at all (FedAvg turns this off)
    use_mask: bool = True
    #: rows no participant owns keep the previous global value
    retains_prev: bool = False
    #: method name understood by the rbla_agg kernel
    kernel_method: str = "rbla"
    #: "fixed": the aggregate's live rank is always r_max
    rank_contract: str = "fixed"
    #: how :meth:`plan` lowers a round: "mean" = packed masked-mean
    #: buckets (robust reductions included), "mean_norm" = + per-row norm
    #: restore, "stack" = flora's copy/scale stacking, "svd" = batched
    #: factored SVD per same-shape pair bucket
    plan_mode: str | None = None
    #: Byzantine-robustness contract: "none" (a single adversarial upload
    #: can move the weighted mean arbitrarily far), "clipped" (per-row
    #: norm clipping bounds a client's displacement), "trimmed" /
    #: "median" (per-coordinate order statistics over a row's owners)
    robustness: str = "none"
    #: folding a cohort one update at a time (:meth:`fold`) reproduces the
    #: one-shot :meth:`aggregate`; the async service replays the rest
    supports_incremental: bool = False
    #: ``backend="distributed"`` has a collective path (else it refuses)
    supports_distributed: bool = True

    def with_options(self, **options) -> "AggregationStrategy":
        """A configured copy of this strategy.  Registered instances are
        shared singletons, so per-run knobs (flora's ``stack_r_cap``, the
        robust ``clip_norm``/``trim_frac``, svd's ``svd_method``) go on a
        copy; only attributes the strategy declares are accepted, and the
        copy starts with no cached plans."""
        inst = copy.copy(self)
        for cached in ("_plan_cache", "plan_stats", "_fold_plan_cache"):
            inst.__dict__.pop(cached, None)
        for k, v in options.items():
            if not hasattr(inst, k) or k.startswith("_"):
                raise ValueError(
                    f"strategy {self.name!r} has no option {k!r}")
            setattr(inst, k, v)
        return inst

    def server_storage_rank(self, r_max: int | None) -> int | None:
        """Storage rank of the global adapters: ``r_max`` for fixed-rank
        strategies; rank-growing ones (flora) need room up to their cap."""
        return r_max

    def plan_knobs(self) -> tuple:
        """The options a compiled plan bakes in; part of its cache key, so
        changing one on an instance never serves a stale plan."""
        return ()

    # ------------------------------------------------------ compiled plans --
    def plan(self, state, cohort_spec):
        """Compiled round for ``cohort_spec`` (see ``repro_torch.core.plan``),
        cached on this instance in a bounded LRU keyed by the spec and
        :meth:`plan_knobs`; :attr:`plan_stats` counts hits and misses.
        ``state`` is unused (the spec encodes the layout) and may be
        None.  A distributed spec raises ``NotImplementedError`` for a
        strategy without a distributed path."""
        from .plan import build_plan
        if (cohort_spec.kind == "distributed"
                and not self.supports_distributed):
            raise NotImplementedError(
                f"strategy {self.name!r} has no distributed path; "
                "use backend='ref'")
        cache = self.__dict__.setdefault("_plan_cache", OrderedDict())
        stats = self.__dict__.setdefault("plan_stats",
                                         {"hits": 0, "misses": 0})
        key = (cohort_spec, self.plan_knobs())
        got = cache.get(key)
        if got is not None:
            stats["hits"] += 1
            count("plan_cache", "hit")
            cache.move_to_end(key)
            return got
        stats["misses"] += 1
        count("plan_cache", "miss")
        with trace_span("plan.build"):
            built = build_plan(self, cohort_spec)
        cache[key] = built
        while len(cache) > PLAN_CACHE_SIZE:
            cache.popitem(last=False)
        return built

    def _plan_round(self, stacked, kind, *, r_max, client_ranks, prev,
                    mesh=None, client_axis="clients"):
        """Plan for an already-stacked cohort; ``None`` when the cohort
        cannot be described host-side (bare leaves)."""
        from .plan import PlanUnavailable, build_cohort_spec
        with trace_span("plan"):
            try:
                spec = build_cohort_spec(stacked, kind=kind, r_max=r_max,
                                         client_ranks=client_ranks,
                                         prev_tree=prev, mesh=mesh,
                                         client_axis=client_axis)
            except PlanUnavailable:
                return None
            return self.plan(None, spec)

    def _plan_encoded_round(self, client_adapters, codecs, kind, *, r_max,
                            client_ranks, prev):
        """Plan for an *encoded* cohort (per-client trees, never stacked);
        ``None`` sends the caller to the decode-eagerly path.  Shares
        :meth:`plan`'s cache: a codec-mix change re-plans, a rank-multiset
        repeat under the same mix hits."""
        from .plan import PlanUnavailable, build_encoded_cohort_spec
        with trace_span("plan"):
            try:
                spec = build_encoded_cohort_spec(
                    client_adapters, codecs, kind=kind, r_max=r_max,
                    client_ranks=client_ranks, prev_tree=prev)
                return self.plan(None, spec)
            except PlanUnavailable:
                return None

    # ------------------------------------------------------ (a) leaf math --
    def leaf(self, stacked, mask, weights, prev=None):
        """Aggregate one stacked leaf (n_clients, *shape) -> (*shape)."""
        raise NotImplementedError

    def transform_weights(self, weights: torch.Tensor,
                          client_ranks: torch.Tensor | None = None):
        """Hook: reweight clients before aggregation (rbla_ranked)."""
        return weights

    # ------------------------------------------------- (b) tree traversal --
    def aggregate_tree(self, stacked_tree: PyTree, mask_tree: PyTree,
                       weights, prev_tree: PyTree | None = None, *,
                       r_max: int | None = None,
                       client_ranks=None) -> PyTree:
        """Reference path: leafwise map over stacked (n, *leaf) trees.
        ``mask_tree`` leaves broadcast against the stacked leaves; 0-d
        leaves mean fully shared.  ``prev_tree`` is honoured only by
        strategies with ``retains_prev``."""
        w = self.transform_weights(torch.as_tensor(weights).float(),
                                   client_ranks)
        if prev_tree is not None and self.retains_prev:
            return tree_map(
                lambda x, m, p: self.leaf(x, _squeeze_mask(m), w, p),
                stacked_tree, mask_tree, prev_tree)
        return tree_map(lambda x, m: self.leaf(x, _squeeze_mask(m), w),
                        stacked_tree, mask_tree)

    # --------------------------------------------- (c) per-pair kernel path --
    def aggregate_tree_kernel(self, stacked_tree: PyTree, weights,
                              client_ranks, prev_tree: PyTree | None = None,
                              *, r_max: int | None = None) -> PyTree:
        """One ``rbla_agg_group`` launch a round: every pair's A ``(n,
        r_max, fan_in)`` by rank row and B ``(n, fan_out, r_max)`` by rank
        column, in their own layouts; the kernel takes each pair's owner
        masks from the ranks (one column for every pair when
        ``client_ranks`` is given) and, for strategies that retain it,
        reads ``prev`` in place where no participant owns a rank row.
        Takes scalar-rank pairs only (layer-stacked pairs go through the
        compiled plan)."""
        w = self.transform_weights(weights.float(), client_ranks)
        skeleton, pairs = _collect_pairs(stacked_tree, prev_tree)
        if not pairs:
            return skeleton
        ranks, rank_cols = self._round_ranks([p for p, _ in pairs],
                                             client_ranks)
        xs, prevs = [], []
        for pair, prev_pair in pairs:
            xs += [pair["A"], pair["B"]]
            keep = prev_pair is not None and self.retains_prev
            prevs += [prev_pair["A"], prev_pair["B"]] if keep else [None] * 2
        outs = rbla_agg_group(xs, ranks, w, prevs, cols=(False, True) * len(
            pairs), rank_cols=[c for c in rank_cols for _ in "AB"],
            method=self.kernel_method, backend="kernel")
        return _place_pairs(skeleton, [
            {"A": outs[2 * i], "B": outs[2 * i + 1], "rank": pair["rank"][0]}
            for i, (pair, _) in enumerate(pairs)])

    @staticmethod
    def _check_pair(pair, client_ranks) -> None:
        A, B = pair["A"], pair["B"]
        if A.ndim != 3 or B.ndim != 3 or (client_ranks is None
                                          and pair["rank"].ndim != 1):
            raise NotImplementedError(
                "the per-pair kernel path takes scalar-rank pairs (got "
                f"A.ndim={A.ndim}); layer-stacked pairs go through the "
                "compiled plan (use_plan=True)")

    def _pair_ranks(self, pair, client_ranks) -> torch.Tensor:
        self._check_pair(pair, client_ranks)
        A = pair["A"]
        if not self.use_mask:
            return torch.full((A.shape[0],), A.shape[-2], dtype=torch.int32,
                              device=A.device)
        return torch.as_tensor(pair["rank"] if client_ranks is None
                               else client_ranks, dtype=torch.int32,
                               device=A.device)

    def _round_ranks(self, pairs, client_ranks) -> tuple:
        """The per-pair round's rank matrix ``(n, cols)`` int32 on the
        pairs' device, and each pair's column: one column for every pair
        when ``client_ranks`` is given or ``use_mask`` is off (then a rank
        no storage reaches: every rank row owned), else pair p's own ranks
        in column p."""
        for pair in pairs:
            self._check_pair(pair, client_ranks)
        A = pairs[0]["A"]
        shared = [0] * len(pairs)
        if not self.use_mask:
            return torch.full((A.shape[0], 1), torch.iinfo(torch.int32).max,
                              dtype=torch.int32, device=A.device), shared
        if client_ranks is not None:
            return torch.as_tensor(client_ranks, dtype=torch.int32,
                                   device=A.device).reshape(-1, 1), shared
        return (torch.stack([p["rank"] for p in pairs], 1).to(torch.int32),
                list(range(len(pairs))))

    # ------------------------------------------------ (f) distributed path --
    def _combine(self, num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
        """The collective paths' combine: ``num / (den + eps)``, and 0 where
        no owner has mass for ``norm_by="mask"``."""
        out = num / (den + _EPS)
        return torch.where(den > 0, out, 0.0) if self.norm_by == "mask" \
            else out

    def allreduce_leaf(self, local: torch.Tensor, mask, weight, mesh=None,
                       client_axis: str = "clients") -> torch.Tensor:
        """Aggregate this rank's one-client leaf with its peers over
        ``client_axis`` of ``mesh`` (the default client mesh for None): the
        masked numerator and its denominator in one ``all_reduce``."""
        if not self.supports_distributed:
            raise NotImplementedError(
                f"strategy {self.name!r} has no distributed path")
        from .plan import resolve_client_group
        x = local.float()
        w = torch.as_tensor(weight, dtype=torch.float32, device=x.device)
        mask = _squeeze_mask(mask) if self.use_mask else None
        m = (torch.ones_like(x) if mask is None
             else torch.broadcast_to(mask.float(), x.shape))
        den = w * m if self.norm_by == "mask" else w.reshape(1)
        buf = all_reduce_sum(torch.cat([(w * m * x).reshape(-1),
                                        den.reshape(-1)]),
                             resolve_client_group(mesh, client_axis))
        num, den = torch.split(buf, [x.numel(), den.numel()])
        den = den.reshape(x.shape) if self.norm_by == "mask" else den
        return self._combine(num.reshape(x.shape), den).to(local.dtype)

    def aggregate_tree_distributed(self, stacked_tree: PyTree,
                                   mask_tree: PyTree, weights,
                                   prev_tree: PyTree | None = None, *,
                                   r_max: int | None = None,
                                   client_ranks=None, mesh=None,
                                   client_axis: str = "clients") -> PyTree:
        """Distributed path over a stacked tree that every rank holds whole:
        the weights are transformed on the whole cohort (a rank's slice
        does not see the global rank vector), each rank reduces its slice
        through :meth:`make_distributed_aggregator`, and prev retention is
        applied after.  flora and svd override it with their gathered
        collectives."""
        wt = self.transform_weights(torch.as_tensor(weights).float(),
                                    client_ranks)
        out = self._aggregate_distributed(stacked_tree, mask_tree, wt, mesh,
                                          client_axis)
        if (prev_tree is not None and self.retains_prev
                and client_ranks is not None):
            out = _retain_prev(out, prev_tree, client_ranks)
        return out

    def make_distributed_aggregator(self, mesh, client_axis: str = "data"):
        """A callable ``(stacked_tree, mask_tree, weights) -> tree`` over
        ``client_axis`` of ``mesh`` (the default client mesh for None) that
        takes **this rank's clients only**: leaves ``(n_local, ...)``, their
        masks and weights already transformed (:meth:`transform_weights`
        needs the global rank vector).  The local clients are reduced to
        masked partial sums, then every leaf's numerator and denominator
        are summed over the ranks in one ``all_reduce``: a two-level
        reduction.  Every rank returns the same tree."""
        if not self.supports_distributed:
            raise NotImplementedError(
                f"strategy {self.name!r} has no distributed path; "
                "use backend='ref'")
        from .plan import resolve_client_group
        by_mask = self.norm_by == "mask"

        def aggregate(stacked_tree, mask_tree, weights):
            wf = torch.as_tensor(weights).float()
            nums, dens, leaves = [], [], []

            def reduce(x, m):
                m = _squeeze_mask(m) if self.use_mask else None
                xf = x.float()
                w = wf.reshape(wf.shape + (1,) * (xf.ndim - 1))
                mf = (torch.ones_like(xf) if m is None
                      else torch.broadcast_to(m.float(), xf.shape))
                nums.append((w * mf * xf).sum(0))
                if by_mask:
                    dens.append((w * mf).sum(0))
                leaves.append(x)
                return _Slot(len(leaves) - 1)
            skeleton = tree_map(reduce, stacked_tree, mask_tree)
            if not by_mask:
                dens = [wf.sum()]
            sizes = [t.numel() for t in nums + dens]
            buf = all_reduce_sum(
                torch.cat([t.reshape(-1) for t in nums + dens]),
                resolve_client_group(mesh, client_axis))
            parts = torch.split(buf, sizes)
            outs = []
            for i, (num, x) in enumerate(zip(nums, leaves)):
                den = parts[len(nums) + i] if by_mask else parts[-1]
                outs.append(self._combine(parts[i].reshape(num.shape),
                                          den.reshape(num.shape) if by_mask
                                          else den).to(x.dtype))
            return tree_map(lambda t: outs[t.index], skeleton)
        return aggregate

    def _aggregate_distributed(self, stacked, masks, w, mesh, client_axis):
        """This rank's slice of a whole stacked cohort through
        :meth:`make_distributed_aggregator`; 0-d ("fully shared") masks are
        materialised first, so that they slice over clients."""
        from .plan import resolve_client_group
        loc = local_slice(int(w.shape[0]),
                          resolve_client_group(mesh, client_axis))
        full = tree_map(lambda x, m: (
            torch.ones(x.shape, device=x.device) if m.ndim == 0
            else torch.broadcast_to(m.float(), x.shape)), stacked, masks)
        agg = self.make_distributed_aggregator(mesh, client_axis)
        return agg(tree_map(lambda t: t[loc], stacked),
                   tree_map(lambda t: t[loc], full), w[loc])

    def _fold_kind(self, backend: str, device) -> str:
        """A fold's backend: one update has nothing to distribute, so a
        ``"distributed"`` fold runs on the device's own backend (the kernels
        on the card, the plain versions on the CPU); a strategy without a
        distributed path refuses it, as its rounds do."""
        kind = resolve_backend(backend, device)
        if kind != "distributed":
            return kind
        if not self.supports_distributed:
            raise NotImplementedError(
                f"strategy {self.name!r} has no distributed path; "
                "use backend='ref'")
        return resolve_backend("auto", device)

    # ----------------------------------------------------- mid-level API --
    def aggregate_adapters(self, client_adapters: Sequence[PyTree], weights,
                           *, r_max: int | None = None, client_ranks=None,
                           prev_global: PyTree | None = None,
                           backend: str = "auto", use_plan: bool = True,
                           mesh=None, client_axis: str = "clients",
                           donate: bool = False) -> PyTree:
        """Aggregate per-client adapter trees into the global adapter.

        Stacks the uploads and runs the round through a cached compiled
        plan (one grouped launch a round); ``use_plan=False`` takes the
        per-leaf path (``aggregate_tree_kernel`` on the kernel backend,
        ``aggregate_tree`` on ref).  Live ranks are reset to ``r_max``.
        ``donate=True`` donates ``prev_global``'s A/B storage to the round:
        a planned mean, robust or stacking round writes the new global
        into it (``repro_torch.core.plan``, "Donation"; the stream rule in
        ``repro_torch.core.donation``), and the caller must not read the
        old global afterwards.

        When the same cohort comes again (the same upload tensors, none
        edited in place since: benchmarks, replays, weight-only
        re-aggregation), its stacking is reused: a single-entry
        :class:`~repro_torch.core.plan.BufferMemo` keyed on every upload
        leaf's identity and ``_version``, held by weakrefs, and kept only
        for a cohort seen twice in a row.

        Encoded uploads (``repro_torch.core.codec``): the mean family plans
        them directly -- per-client wire-dtype payloads, dequantisation
        fused into ``packed_agg``/``packed_robust``, one launch a round
        (mixed codecs too).  Every other strategy, a client whose pairs
        mix codecs, an unplannable cohort and a distributed round decode
        eagerly and take the standard path.

        ``backend="distributed"`` reduces over ``client_axis`` of ``mesh``
        (the default client mesh for None); every rank is given the whole
        cohort and returns the same aggregate (``repro_torch.core
        .distributed``)."""
        from repro_torch.lora import adapter_masks

        from .codec import cohort_codecs, decode_adapters
        codecs = cohort_codecs(client_adapters)
        if codecs is not None:
            kind_enc = resolve_backend(backend, _device_of(client_adapters))
            if (use_plan and "mixed" not in codecs
                    and kind_enc != "distributed"
                    and self.plan_mode in ("mean", "mean_norm")):
                prev_enc = prev_global if self.retains_prev else None
                round_ = self._plan_encoded_round(
                    client_adapters, codecs, kind_enc, r_max=r_max,
                    client_ranks=client_ranks, prev=prev_enc)
                if round_ is not None:
                    return round_(client_adapters, weights, prev_enc,
                                  donate=donate)
            client_adapters = [decode_adapters(a) for a in client_adapters]
        stacked = self._stack_cohort(client_adapters)
        device = _device_of(stacked)
        if client_ranks is None:
            client_ranks = _infer_ranks(stacked)
        elif not isinstance(client_ranks, torch.Tensor):
            client_ranks = torch.as_tensor(client_ranks, dtype=torch.int32,
                                           device=device)
        w = torch.as_tensor(weights, dtype=torch.float32, device=device)
        prev = prev_global if self.retains_prev else None
        kind = resolve_backend(backend, device)
        if use_plan:
            round_ = self._plan_round(stacked, kind, r_max=r_max,
                                      client_ranks=client_ranks, prev=prev,
                                      mesh=mesh, client_axis=client_axis)
            if round_ is not None:
                return round_(stacked, w, prev, donate=donate)
        if kind == "kernel":
            out = self.aggregate_tree_kernel(stacked, w, client_ranks, prev,
                                             r_max=r_max)
        else:
            masks = stack_trees([adapter_masks(a) for a in client_adapters])
            if kind == "distributed":
                out = self.aggregate_tree_distributed(
                    stacked, masks, w, prev, r_max=r_max,
                    client_ranks=client_ranks, mesh=mesh,
                    client_axis=client_axis)
            else:
                out = self.aggregate_tree(stacked, masks, w, prev,
                                          r_max=r_max,
                                          client_ranks=client_ranks)
        return self.finalize_tree(out, r_max)

    def _stack_cohort(self, client_adapters) -> PyTree:
        """:func:`stack_trees` of the uploads, through the instance's stack
        memo (see :meth:`aggregate_adapters`)."""
        from .plan import BufferMemo
        leaves = [t for ad in client_adapters for t in tree_leaves(ad)]
        with trace_span("strategy.stack",
                        device=leaves[0] if leaves else None):
            memo = self.__dict__.get("_stack_memo")
            if memo is None:
                # require_repeat: a normal FL loop (fresh uploads every
                # round) keeps a fingerprint between rounds, not a stacked
                # copy
                memo = self.__dict__["_stack_memo"] = BufferMemo(
                    require_repeat=True)
            stacked = memo.lookup(leaves)
            if stacked is None:
                stacked = stack_trees(client_adapters)
                memo.store(leaves, stacked)
            return stacked

    def finalize_tree(self, out: PyTree, r_max: int | None) -> PyTree:
        """Fixed-rank strategies reset every pair's live rank to r_max."""
        return _fix_rank(out, r_max)

    # ---------------------------------------------------- high-level API --
    def aggregate(self, state: ServerState,
                  client_updates: Sequence[ClientUpdate], weights=None, *,
                  backend: str = "auto", device="cuda", mesh=None,
                  client_axis: str = "clients",
                  donate: bool = False) -> ServerState:
        """One server round: fold a participant cohort into ``state``.

        Non-LoRA trainables are FedAvg'd; adapters go through this
        strategy (over ``client_axis`` of ``mesh`` on the distributed
        backend).  ``weights`` defaults to the updates' ``n_examples``.
        The state's tensors must lie on ``device``.  ``donate=True``
        donates ``state.adapters``' storage to the round (see
        :meth:`aggregate_adapters`): the caller must not read the old
        state's adapters afterwards."""
        device = resolve_device(device)
        for tree in (state.adapters, state.base_trainable):
            got = _device_of(tree)
            if got is not None and got.type != device.type:
                raise ValueError(f"aggregate runs on {device}; the server "
                                 f"state lies on {got}")
        updates = list(client_updates)
        if weights is None:
            weights = [u.n_examples for u in updates]
        w = torch.as_tensor(weights, dtype=torch.float32, device=device)
        got = [u.rank for u in updates]
        ranks = (torch.tensor(got, dtype=torch.int32, device=device)
                 if updates and all(r is not None for r in got) else None)

        new_base = state.base_trainable
        base_trees = [u.base_trainable for u in updates]
        if updates and tree_leaves(base_trees[0]):
            new_base = tree_map(lambda x: fedavg_leaf(x, w),
                                stack_trees(base_trees))

        new_adapters = state.adapters
        ad_trees = [u.adapters for u in updates]
        if (state.adapters is not None and updates
                and all(a is not None for a in ad_trees)):
            new_adapters = self.aggregate_adapters(
                ad_trees, w, r_max=state.r_max, client_ranks=ranks,
                prev_global=state.adapters, backend=backend, mesh=mesh,
                client_axis=client_axis, donate=donate)

        current_rank = (adapter_live_ranks(new_adapters)
                        if new_adapters is not None else state.current_rank)
        return ServerState(adapters=new_adapters, base_trainable=new_base,
                           round=state.round + 1, r_max=state.r_max,
                           client_ranks=(ranks if ranks is not None
                                         else state.client_ranks),
                           current_rank=current_rank)

    # ---------------------------------------------------- per-update fold --
    def init_fold(self, state: ServerState) -> FoldState:
        """Fresh accumulator for a sequence of :meth:`fold` calls anchored
        at ``state`` (strategies that stream per-row mass override it)."""
        return FoldState()

    def fold(self, state: ServerState, update: ClientUpdate,
             weight: float | None = None, *,
             fold_state: FoldState | None = None,
             backend: str = "auto") -> tuple[ServerState, FoldState]:
        """Fold ONE arriving update into ``state`` (the async hot path).

        ``weight`` is the update's effective mass (its ``n_examples``
        scaled by any staleness discount; default the plain
        ``n_examples``).  The update is aggregated as a single-element
        cohort through :meth:`aggregate`, then mixed into the state at
        rate ``alpha = w / (mass + w)`` -- a running weighted mean, exact
        for fedavg and zeropad.  The mix of every float leaf (adapters and
        base trainables) is one grouped ``axpy_fold`` call.  The state's
        tensors are never written: the new state holds new tensors.
        Returns ``(new_state, fold_state)``."""
        fs = fold_state if fold_state is not None else self.init_fold(state)
        w = float(update.n_examples if weight is None else weight)
        if w <= 0:
            raise ValueError(f"fold needs a positive weight, got {w}")
        device = _state_device(state)
        kind = self._fold_kind(backend, device)
        agg = self.aggregate(state, [update], weights=[w], backend=kind,
                             device=device)
        alpha = w / (fs.mass + w)
        batch = _FoldBatch()
        new_adapters = state.adapters
        if state.adapters is not None and agg.adapters is not None:
            new_adapters = batch.add_tree(state.adapters, agg.adapters, alpha)
        new_base = batch.add_tree(state.base_trainable, agg.base_trainable,
                                  alpha)
        new_adapters, new_base = batch.run(kind, (new_adapters, new_base))
        new_fs = FoldState(mass=fs.mass + w, row_mass=fs.row_mass,
                           n_folds=fs.n_folds + 1)
        current_rank = (adapter_live_ranks(new_adapters)
                        if new_adapters is not None else state.current_rank)
        return ServerState(
            adapters=new_adapters, base_trainable=new_base,
            round=state.round + 1, r_max=state.r_max,
            client_ranks=agg.client_ranks,
            current_rank=current_rank), new_fs


class _Slot:
    """Where a leaf's fold result lands in a :class:`_FoldBatch`."""
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class _FoldBatch:
    """The leaves of one fold, mixed by ONE grouped ``axpy_fold`` call: the
    kernel (one launch per dtype triple) for ``kind="kernel"``, its plain
    version for ``"ref"``.  :meth:`add` and :meth:`add_tree` return
    placeholders that :meth:`run` replaces by the new tensors."""

    def __init__(self):
        self.ys, self.xs, self.alphas, self.cols = [], [], [], []

    def add(self, old: torch.Tensor, new: torch.Tensor, alpha, *,
            col: bool = False) -> _Slot:
        """``old + alpha * (new - old)`` in old's dtype.  ``alpha`` is a
        number or a tensor over old's leading dims (one rate per rank
        row); ``col`` reads it over the leading dims and the last axis (a
        LoRA B leaf, rank axis last)."""
        self.ys.append(old)
        self.xs.append(new)
        self.alphas.append(alpha)
        self.cols.append(col)
        return _Slot(len(self.ys) - 1)

    def add_tree(self, old: PyTree, new: PyTree, alpha) -> PyTree:
        """Every float leaf of ``old`` mixed with ``new``'s at one rate;
        integer leaves (rank bookkeeping) take ``new``'s."""
        return tree_map(lambda o, n: self.add(o, n, alpha)
                        if o.is_floating_point() else n, old, new)

    def run(self, kind: str, tree: PyTree) -> PyTree:
        """Fold every segment; returns ``tree`` with each placeholder
        replaced by its result."""
        if kind == "kernel":
            outs = axpy_fold_group(self.ys, self.xs, self.alphas,
                                   cols=self.cols, backend="kernel")
        else:
            outs = axpy_fold_group_ref(self.ys, self.xs, self.alphas,
                                       cols=self.cols)
        return tree_map(lambda t: outs[t.index] if isinstance(t, _Slot)
                        else t, tree)


# --------------------------------------------------------- the strategies --
@register_strategy
class FedAvgStrategy(AggregationStrategy):
    """Plain weighted mean (non-LoRA leaves and the FFT baseline)."""
    name = "fedavg"
    aliases = ("fft",)
    norm_by = "weight"
    use_mask = False
    kernel_method = "zeropad"          # full-rank masks => weighted mean
    plan_mode = "mean"
    # the default fold IS the exact streaming form of a weighted mean
    supports_incremental = True

    def leaf(self, stacked, mask, weights, prev=None):
        return fedavg_leaf(stacked, weights)


@register_strategy
class ZeropadStrategy(AggregationStrategy):
    """HetLoRA-style zero-padding baseline (paper Eq. 1-5): mask values,
    normalise by total weight mass -- missing rows dilute toward zero."""
    name = "zeropad"
    norm_by = "weight"
    kernel_method = "zeropad"
    plan_mode = "mean"
    # a weighted mean of masked uploads: the default fold streams it
    # exactly (rows nobody owns stay zero through the mix)
    supports_incremental = True

    def leaf(self, stacked, mask, weights, prev=None):
        return zeropad_leaf(stacked, mask, weights)


@register_strategy
class RBLAStrategy(AggregationStrategy):
    """Rank-Based LoRA Aggregation (paper Eq. 7 / Alg. 1): per rank-row
    weighted mean over owners; unowned rows keep the previous global."""
    name = "rbla"
    norm_by = "mask"
    retains_prev = True
    kernel_method = "rbla"
    plan_mode = "mean"
    supports_incremental = True

    def leaf(self, stacked, mask, weights, prev=None):
        return rbla_leaf(stacked, mask, weights, prev)

    # ---------------------------------------------------- streaming fold --
    def _fold_adapter_weight(self, update: ClientUpdate, w: float,
                             rank: int) -> float:
        """Hook: the mass this update's adapter rows enter with (the
        streaming analogue of :meth:`transform_weights`)."""
        return w

    def init_fold(self, state: ServerState) -> FoldState:
        if state.adapters is None:
            return FoldState()

        def zeros(pair):
            rank = torch.as_tensor(pair["rank"])
            return torch.zeros(tuple(rank.shape) + (pair["A"].shape[-2],),
                               dtype=torch.float32, device=pair["A"].device)
        return FoldState(row_mass=_map_pairs(zeros, state.adapters))

    def _packed_fold(self, batch: _FoldBatch, adapters, upd, row_mass,
                     wa: float, kind: str):
        """Fold through the cached fold plan of the state's spec: each pair
        side joins ``batch`` as one segment with its per-row rates.
        Returns ``(new_adapters, new_row_mass)`` with the pair sides as
        ``batch`` placeholders, or ``None`` when the layout cannot be
        planned (the per-pair path takes everything)."""
        from .plan import (PlanUnavailable, _make_rebuilder, _walk_pairs,
                           build_fold_plan, build_state_spec)
        try:
            spec = build_state_spec(adapters, kind=kind)
            state_pairs = list(_walk_pairs(adapters))
            upd_pairs = list(_walk_pairs(upd))
        except PlanUnavailable:
            return None
        if len(state_pairs) != len(upd_pairs) or any(
                sp["A"].shape != up["A"].shape
                or sp["B"].shape != up["B"].shape
                for (_, sp), (_, up) in zip(state_pairs, upd_pairs)):
            return None
        # keyed on shapes, dtypes, device and backend (the spec)
        cache = self.__dict__.setdefault("_fold_plan_cache", {})
        fold_fn = cache.get(spec)
        if fold_fn is None:
            fold_fn = cache[spec] = build_fold_plan(self, spec)
        dev = torch.device(spec.device)
        new_ab, new_mass = fold_fn(
            batch, [{"A": p["A"], "B": p["B"]} for _, p in state_pairs],
            [{"A": p["A"], "B": p["B"]} for _, p in upd_pairs],
            _flat_pair_values(row_mass), wa,
            [torch.as_tensor(p["rank"], dtype=torch.int32, device=dev)
             for _, p in upd_pairs])
        rebuild = _make_rebuilder(adapters)
        new_adapters = rebuild(
            [{"A": o["A"], "B": o["B"], "rank": p["rank"]}
             for o, (_, p) in zip(new_ab, state_pairs)])
        return new_adapters, rebuild(new_mass)

    def fold(self, state, update, weight=None, *, fold_state=None,
             backend="auto", use_plan=True):
        """Exact streaming RBLA: Eq. 7's per-rank-row weighted mean in
        running form.  Row ``rho`` of the accumulated owner mass ``d``
        gives the arriving update the rate ``w / (d_rho + w)`` on the rows
        it owns and 0 elsewhere, so rows no client has touched keep the
        anchor (retention for free) and folding a cohort one update at a
        time reproduces the one-shot aggregate.  Every pair side and base
        trainable is one segment of a single grouped ``axpy_fold`` call
        (B folds in its own layout, rank axis last).  ``use_plan=False``
        declines the cached fold plan: the rates are built pair by pair,
        to the same bits."""
        fs = fold_state if fold_state is not None else self.init_fold(state)
        w = float(update.n_examples if weight is None else weight)
        if w <= 0:
            raise ValueError(f"fold needs a positive weight, got {w}")
        dev = _state_device(state)
        kind = self._fold_kind(backend, dev)

        batch = _FoldBatch()
        new_adapters, new_row_mass = state.adapters, fs.row_mass
        rank_seen = update.rank
        wa = w
        packed = None
        if state.adapters is not None and update.adapters is not None:
            upd = update.adapters
            if rank_seen is None:
                # reads the rank leaves back to the host
                ranks = [int(torch.as_tensor(p["rank"]).max())
                         for p in _pairs(upd)]
                rank_seen = max(ranks) if ranks else None
            wa = self._fold_adapter_weight(update, w, int(rank_seen or 1))
            if use_plan:
                packed = self._packed_fold(batch, state.adapters, upd,
                                           fs.row_mass, wa, kind)
        if packed is not None:
            new_adapters, new_row_mass = packed
        elif state.adapters is not None and update.adapters is not None:
            masses: list = []

            def fold_pair(pair, upd_pair, dmass):
                r_storage = pair["A"].shape[-2]
                rank = torch.as_tensor(upd_pair["rank"], dtype=torch.int32,
                                       device=dev)
                owned = (torch.arange(r_storage, device=dev)
                         < rank[..., None]).float()
                alpha = torch.where(owned > 0, wa / (dmass + wa), 0.0)
                masses.append(dmass + wa * owned)
                return {"A": batch.add(pair["A"], upd_pair["A"], alpha),
                        "B": batch.add(pair["B"], upd_pair["B"], alpha,
                                       col=True),
                        "rank": pair["rank"]}

            new_adapters = _map_pairs(fold_pair, state.adapters,
                                      update.adapters, fs.row_mass,
                                      strict=True)
            mass_it = iter(masses)      # same traversal order as above
            new_row_mass = _map_pairs(lambda p: next(mass_it),
                                      state.adapters)

        new_base = state.base_trainable
        if tree_leaves(update.base_trainable):
            new_base = batch.add_tree(state.base_trainable,
                                      update.base_trainable,
                                      w / (fs.mass + w))
        new_adapters, new_base = batch.run(kind, (new_adapters, new_base))

        new_fs = FoldState(mass=fs.mass + w, row_mass=new_row_mass,
                           n_folds=fs.n_folds + 1)
        current_rank = (adapter_live_ranks(new_adapters)
                        if new_adapters is not None else state.current_rank)
        return ServerState(
            adapters=new_adapters, base_trainable=new_base,
            round=state.round + 1, r_max=state.r_max,
            client_ranks=(torch.tensor([rank_seen], dtype=torch.int32,
                                       device=dev)
                          if rank_seen is not None else state.client_ranks),
            current_rank=current_rank), new_fs


@register_strategy
class RBLARankedStrategy(RBLAStrategy):
    """RBLA with rank-proportional client weights (HetLoRA-flavoured)."""
    name = "rbla_ranked"

    def _fold_adapter_weight(self, update, w, rank):
        # streaming analogue of rank_proportional_weights: a masked
        # weighted mean depends only on weight ratios, so the global scale
        # and the renormalisation cancel and w * rank is exact (alpha=1)
        return w * float(max(rank, 1))

    def transform_weights(self, weights, client_ranks=None):
        if client_ranks is None:
            raise ValueError("rbla_ranked needs client_ranks to reweight "
                             "clients by rank; pass client_ranks (or use "
                             "aggregate_adapters on adapter trees, which "
                             "infers them)")
        return rank_proportional_weights(
            weights, torch.as_tensor(client_ranks, device=weights.device))

    def allreduce_leaf(self, local, mask, weight, mesh=None,
                       client_axis="clients"):
        raise NotImplementedError(
            "rbla_ranked cannot reweight inside a one-client collective (a "
            "rank never sees the global rank vector); apply "
            "rank_proportional_weights to the weights first and use the "
            "'rbla' strategy")


@register_strategy
class RBLANormStrategy(AggregationStrategy):
    """RBLA + per-row update-norm preservation (pair-structured: the row
    axis differs between A and B, so it traverses whole pairs)."""
    name = "rbla_norm"
    norm_by = "mask"
    plan_mode = "mean_norm"
    supports_distributed = False

    def leaf(self, stacked, mask, weights, prev=None):
        return rbla_leaf(stacked, mask, weights, prev)

    def aggregate_tree(self, stacked_tree, mask_tree, weights,
                       prev_tree=None, *, r_max=None, client_ranks=None):
        w = torch.as_tensor(weights).float()

        def agg_pair(pair, masks):
            if pair["A"].ndim != 3 or pair["B"].ndim != 3:
                raise NotImplementedError(
                    "rbla_norm supports scalar-rank pairs (got "
                    f"A.ndim={pair['A'].ndim}); the per-row norm target "
                    "needs a per-layer loop for layer-stacked pairs")
            return {
                "A": rbla_norm_leaf(pair["A"], masks["A"], w, row_axis=0),
                "B": rbla_norm_leaf(pair["B"], masks["B"], w, row_axis=1),
                "rank": pair["rank"][0],
            }
        return _map_pairs(agg_pair, stacked_tree, mask_tree, strict=True)

    def aggregate_tree_kernel(self, stacked_tree, weights, client_ranks,
                              prev_tree=None, *, r_max=None):
        """The masked mean and the per-row norm restore of a pair's A and
        B (by rank column, in its own layout) in one
        ``packed_agg_group(norm_restore=True)`` launch per pair."""
        w = weights.float()

        def agg_pair(pair, _prev):
            A, B = pair["A"], pair["B"]
            masks = stacked_rank_masks(A.shape[-2],
                                       self._pair_ranks(pair, client_ranks))
            outA, outB = packed_agg_group(
                [A, B], masks, w, cols=[False, True], mask_offs=[0, 0],
                out_dtypes=[A.dtype, B.dtype], norm_by="mask",
                norm_restore=True, backend="kernel")
            return {"A": outA, "B": outB, "rank": pair["rank"][0]}
        return _map_pairs(agg_pair, stacked_tree, prev_tree, strict=True)


# ------------------------------------------------------------ robust family --
class RobustRBLAStrategy(AggregationStrategy):
    """Byzantine-tolerant RBLA family (pair-structured): the masked
    rank-row aggregation of Eq. 7 with the weighted mean replaced by a
    robust reduction over each row's owners.

    * ``rbla_clipped`` -- every client rank-row is L2-clipped to
      ``clip_norm`` before the masked weighted mean (equal to ``rbla``
      while every row norm is under the clip).
    * ``rbla_trimmed`` -- per-coordinate trimmed mean over a row's owners,
      dropping ``k = min(floor(trim_frac * c), (c-1)//2)`` from each end.
    * ``rbla_median`` -- coordinate-wise median over a row's owners.

    Trimmed and median are unweighted: example counts are client-reported
    and so adversary-controlled.  Rows with no owner keep the previous
    global, as in ``rbla``.  All three lower through the packed mean plan:
    one grouped ``packed_robust`` launch per round."""
    norm_by = "mask"
    use_mask = True
    retains_prev = True
    plan_mode = "mean"
    #: robust statistics need every owner's value on one device
    supports_distributed = False
    #: L2 clip applied per (client, rank-row) by "clipped"
    clip_norm: float = 100.0
    #: per-end trim fraction of a row's owners used by "trimmed"
    trim_frac: float = 0.2

    def plan_knobs(self) -> tuple:
        return (self.robustness, float(self.clip_norm),
                float(self.trim_frac))

    def leaf(self, stacked, mask, weights, prev=None):
        # non-pair leaves have no rank-row structure to defend
        return rbla_leaf(stacked, mask, weights, prev)

    def _robust_pair(self, group, pair, prev_pair, w, ranks):
        """One pair through ``group`` (a grouped robust call): A by rank
        row and B by rank column, both in their own layout, sharing the
        pair's owner-mask columns."""
        A, B = pair["A"], pair["B"]
        pranks = ranks
        if pranks is None and pair["rank"].ndim == 1:
            pranks = pair["rank"]
        if A.ndim != 3 or B.ndim != 3 or pranks is None:
            raise NotImplementedError(
                f"{self.name} supports scalar-rank pairs (got "
                f"A.ndim={A.ndim}); layer-stacked pairs lower through the "
                "compiled plan, which packs per-layer rows")
        masks = stacked_rank_masks(A.shape[-2], pranks, device=A.device)
        prevs = (None, None) if prev_pair is None else (prev_pair["A"],
                                                        prev_pair["B"])
        outA, outB = group([A, B], masks, w, prevs, cols=(False, True),
                           scales=(None, None), mask_offs=(0, 0),
                           out_dtypes=(A.dtype, B.dtype))
        return {"A": outA, "B": outB, "rank": pair["rank"][0]}

    def _map_robust(self, group, stacked_tree, weights, client_ranks,
                    prev_tree):
        w = torch.as_tensor(weights).float()
        ranks = (None if client_ranks is None
                 else torch.as_tensor(client_ranks, dtype=torch.int32))
        kw = dict(mode=self.robustness, clip_norm=self.clip_norm,
                  trim_frac=self.trim_frac)
        return _map_pairs(
            lambda pair, prev_pair: self._robust_pair(
                lambda *a, **k: group(*a, **k, **kw), pair, prev_pair, w,
                ranks),
            stacked_tree, prev_tree, strict=True)

    def aggregate_tree(self, stacked_tree, mask_tree, weights,
                       prev_tree=None, *, r_max=None, client_ranks=None):
        return self._map_robust(packed_robust_group_ref, stacked_tree,
                                weights, client_ranks, prev_tree)

    def aggregate_tree_kernel(self, stacked_tree, weights, client_ranks,
                              prev_tree=None, *, r_max=None):
        """One ``packed_robust_group`` launch per pair (the compiled plan
        takes the whole round in one)."""
        def group(*a, **kw):
            return packed_robust_group(*a, backend="kernel", **kw)
        return self._map_robust(group, stacked_tree, weights, client_ranks,
                                prev_tree)


@register_strategy
class RBLAClippedStrategy(RobustRBLAStrategy):
    name = "rbla_clipped"
    aliases = ("clipped",)
    robustness = "clipped"


@register_strategy
class RBLATrimmedStrategy(RobustRBLAStrategy):
    name = "rbla_trimmed"
    aliases = ("trimmed",)
    robustness = "trimmed"


@register_strategy
class RBLAMedianStrategy(RobustRBLAStrategy):
    name = "rbla_median"
    aliases = ("median",)
    robustness = "median"


# ----------------------------------------------------------------------- svd --
@register_strategy
class SVDStrategy(AggregationStrategy):
    """Product-space aggregation: weighted-average the effective updates
    ``(r_out / rank_i) * B_i @ A_i``, truncated-SVD back to rank-``r_out``
    factors, re-pad to storage rank.  The truncation runs through the
    factored engine (``repro_torch.core.lowrank``): the weighted product
    mean is itself a product of concatenated factors, so no dense (out,
    in) delta is formed.  ``svd_method`` and the ``rsvd_*`` knobs route the
    engine ("auto" is exact).  The kernel backend shares this math: it is
    QR and small SVDs, with no reduction a hand-written kernel would
    take."""
    name = "svd"
    norm_by = "mask"
    plan_mode = "svd"
    #: lowrank engine knobs: "auto" | "factored" | "dense" | "randomized"
    svd_method: str = "auto"
    rsvd_oversample: int = 8
    rsvd_power_iters: int = 2

    def plan_knobs(self) -> tuple:
        return (self.svd_method, int(self.rsvd_oversample),
                int(self.rsvd_power_iters))

    def _pair_scales(self, pranks, r_out: int) -> torch.Tensor:
        """Per-contributor ``r_out / rank`` scales, (n, *rank_lead)."""
        return (torch.tensor(float(r_out), dtype=torch.float32)
                / torch.as_tensor(pranks).float().clamp(min=1.0))

    def _project(self, B, A, w, r_out: int, scales):
        return svd_project_stacked(B, A, w, r_out, scales=scales,
                                   method=self.svd_method,
                                   oversample=self.rsvd_oversample,
                                   power_iters=self.rsvd_power_iters)

    def aggregate_tree(self, stacked_tree, mask_tree, weights,
                       prev_tree=None, *, r_max=None, client_ranks=None):
        w = torch.as_tensor(weights).float()

        def agg_pair(pair, _masks):
            A, B = pair["A"], pair["B"]
            r_storage = A.shape[-2]
            r_out = r_storage if r_max is None else min(r_max, r_storage)
            pranks = pair["rank"] if client_ranks is None else client_ranks
            Bo, Ao = self._project(B, A, w, r_out,
                                   self._pair_scales(pranks, r_out))
            return {"A": pad_to_rank(Ao.to(A.dtype), -2, r_storage),
                    "B": pad_to_rank(Bo.to(B.dtype), -1, r_storage),
                    "rank": pair["rank"][0]}
        return _map_pairs(agg_pair, stacked_tree, mask_tree, strict=True)

    def aggregate_tree_kernel(self, stacked_tree, weights, client_ranks,
                              prev_tree=None, *, r_max=None):
        """The engine's math on the tensors' device (QR and small SVDs;
        the JAX package also leaves them to the compiler's library)."""
        return self.aggregate_tree(stacked_tree, None, weights, prev_tree,
                                   r_max=r_max, client_ranks=client_ranks)

    def make_distributed_aggregator(self, mesh, client_axis: str = "data"):
        raise NotImplementedError(
            "svd's distributed path gathers the low-rank factors "
            "(all_gather moves (out+in)*r per client; a dense out*in "
            "delta psum would defeat the factored engine) and projects "
            "replicated -- use aggregate_tree_distributed / "
            "aggregate_adapters(backend='distributed') instead")

    def aggregate_tree_distributed(self, stacked_tree, mask_tree, weights,
                                   prev_tree=None, *, r_max=None,
                                   client_ranks=None, mesh=None,
                                   client_axis: str = "clients"):
        """Gathered-factor collective: each rank gathers every rank's slice
        of the low-rank factors, rank leaves, weights and client ranks --
        O((out + in) * r) bytes a client on the wire, never a dense delta
        -- and runs the factored projection replicated, on the tensors'
        device."""
        from .plan import resolve_client_group
        tree, w, cr = _gather_cohort(
            stacked_tree, torch.as_tensor(weights).float(), client_ranks,
            resolve_client_group(mesh, client_axis))
        return self.aggregate_tree(tree, None, w, None, r_max=r_max,
                                   client_ranks=cr)


# --------------------------------------------------------------------- flora --
@register_strategy
class FloraStrategy(AggregationStrategy):
    """FLoRA-style stacking aggregation (Wang et al., 2024).

    The participants' A/B factors are concatenated along the rank axis, so
    the aggregate is noise-free but rank-growing: its live rank is the sum
    of the contributors' ranks.  The previous global is one more
    contributor, first, with mass ``prev_weight`` x the mean client
    weight.  Contributor ``i`` (normalised mass ``m_i``, rank ``r_i``)
    enters with ``s_i = m_i * R_out / r_i`` folded into its B columns, so
    serving the aggregate at rank ``R_out`` under the ``alpha/rank``
    convention reproduces ``sum_i m_i (alpha/r_i) B_i A_i`` exactly; A
    rows pass through.

    Storage is padded to ``stack_r_cap`` (default ``2*r_max``).  When the
    stacked rank would exceed the cap, the contributors are re-projected
    to ``r_max`` in product space by a factored SVD instead, and growth
    restarts from there.  Every path needs concrete client ranks."""
    name = "flora"
    aliases = ("stacking",)
    rank_contract = "stacked"
    retains_prev = True
    norm_by = "weight"
    plan_mode = "stack"
    stack_r_cap: int | None = None     # None -> 2 * r_max at aggregation
    prev_weight: float = 1.0           # prev global mass / mean client mass
    supports_incremental = True

    def plan_knobs(self) -> tuple:
        return (self.stack_r_cap, float(self.prev_weight))

    # ------------------------------------------------------ rank plumbing --
    def resolve_cap(self, r_max: int | None,
                    r_storage: int | None = None) -> int:
        if self.stack_r_cap is not None:
            return int(self.stack_r_cap)
        base = r_max if r_max is not None else r_storage
        if base is None:
            raise ValueError("flora needs r_max (or an explicit "
                             "stack_r_cap) to size the stacked storage")
        return 2 * int(base)

    def server_storage_rank(self, r_max: int | None) -> int | None:
        cap = self.resolve_cap(r_max)
        self._validate_cap(cap, np.zeros(0, np.int64), r_max)  # fail fast
        return cap

    @staticmethod
    def _concrete_ranks(ranks) -> np.ndarray:
        if ranks is None:
            raise ValueError(
                "flora needs the client ranks (pass client_ranks, or "
                "aggregate adapter trees whose pairs carry scalar ranks)")
        if isinstance(ranks, torch.Tensor):
            ranks = read_back("strategy", host_array, ranks)
        arr = np.asarray(ranks).astype(np.int64)
        if arr.ndim == 2:            # layer-stacked (n, L): must be uniform
            if not np.all(arr == arr[:, :1]):
                raise NotImplementedError(
                    "flora supports layer-stacked pairs only when each "
                    "client's rank is uniform across layers")
            arr = arr[:, 0]
        return arr.reshape(-1)

    def _validate_cap(self, cap: int, ranks: np.ndarray,
                      r_max: int | None) -> None:
        mx = int(ranks.max()) if ranks.size else 0
        if cap < mx:
            raise ValueError(
                f"flora: stack_r_cap={cap} < max client rank {mx}; a "
                "single contributor would not fit the stacked storage -- "
                "raise stack_r_cap to at least the largest client rank")
        if r_max is not None and cap < r_max:
            raise ValueError(
                f"flora: stack_r_cap={cap} < r_max={r_max}: the SVD "
                "re-projection target would not fit the stacked storage")

    # -------------------------------------------------------- core pair op --
    def _stack_pair(self, A, B, ranks: np.ndarray, w, prev_A, prev_B,
                    prev_rank: int | None, r_max: int | None):
        """Stack (or SVD-reproject) one gathered pair: ``A`` (n, *lead,
        r_st, fan_in), ``B`` (n, *lead, fan_out, r_st); ``ranks`` and
        ``prev_rank`` are host ints.  Returns (A_out, B_out, r_out) at
        ``stack_r_cap`` storage; contributors are prev first."""
        n = A.shape[0]
        cap = self.resolve_cap(r_max, r_storage=A.shape[-2])
        self._validate_cap(cap, ranks, r_max)
        wf = torch.as_tensor(w, device=A.device).float()

        seg_ranks: list[int] = []
        A_parts, B_parts, masses = [], [], []
        if prev_A is not None and prev_rank:
            seg_ranks.append(int(prev_rank))
            A_parts.append(prev_A[..., :int(prev_rank), :])
            B_parts.append(prev_B[..., :int(prev_rank)])
            masses.append(self.prev_weight * wf.mean())
        for i in range(n):
            r_i = int(ranks[i])
            if r_i <= 0:
                continue
            seg_ranks.append(r_i)
            A_parts.append(A[i][..., :r_i, :])
            B_parts.append(B[i][..., :, :r_i])
            masses.append(wf[i])
        if not seg_ranks:
            raise ValueError("flora: empty cohort (all ranks are zero)")
        m = torch.stack(masses)
        mhat = m / (m.sum() + _EPS)
        r_total = int(sum(seg_ranks))
        A_cat = torch.cat([a.float() for a in A_parts], dim=-2)
        if r_total <= cap:
            r_out = r_total
            scales = mhat * torch.as_tensor(
                np.float32(r_out) / np.asarray(seg_ranks, np.float32),
                device=A.device)
            A_out = A_cat
            B_out = torch.cat([b.float() * scales[i]
                               for i, b in enumerate(B_parts)], dim=-1)
        else:
            # over the cap: product-space re-projection back to r_max in
            # factored form (no dense (out, in) delta)
            r_out = min(int(r_max if r_max is not None else A.shape[-2]),
                        cap)
            B_cat = torch.cat(
                [b.float() * (mhat[i] * float(np.float32(r_out)
                                              / np.float32(seg_ranks[i])))
                 for i, b in enumerate(B_parts)], dim=-1)
            B_out, A_out = product_factors(B_cat, A_cat, r_out)
        A_out = pad_to_rank(A_out.to(A.dtype), -2, cap)
        B_out = pad_to_rank(B_out.to(B.dtype), -1, cap)
        return A_out, B_out, r_out

    def _pair_ranks(self, pair, client_ranks) -> np.ndarray:
        return self._concrete_ranks(pair["rank"] if client_ranks is None
                                    else client_ranks)

    @staticmethod
    def _out_rank_leaf(stacked_rank_leaf, r_out: int) -> torch.Tensor:
        # drop the client axis: scalar-rank -> (), layer-stacked -> (L,)
        return torch.full(tuple(stacked_rank_leaf.shape[1:]), r_out,
                          dtype=torch.int32, device=stacked_rank_leaf.device)

    @staticmethod
    def _prev_rank_of(prev_pair) -> int | None:
        if prev_pair is None:
            return None
        # read to the host first: a copy, and no reduction on the card
        return int(read_back("strategy", host_array,
                             torch.as_tensor(prev_pair["rank"])).max())

    def finalize_tree(self, out: PyTree, r_max: int | None) -> PyTree:
        return out                       # live ranks already written

    # ---------------------------------------------------- per-update fold --
    def init_fold(self, state: ServerState) -> FoldState:
        """Open a per-pair segment ledger anchored at ``state``: the anchor
        enters the stream as the prev contributor (its B columns carry
        scale 1).  Reads each pair's live rank back to the host."""
        if state.adapters is None:
            return FoldState()
        pairs = []

        def grab(pair):
            r_live = int(torch.as_tensor(pair["rank"]).max())
            pairs.append({
                "prev_rank": r_live,       # anchor segment rows
                "seg_ranks": [],           # client segment ranks, in order
                "seg_w": [],               # client segment masses
                # applied B-column scales, [prev] + clients, in segment
                # order; the anchor starts unscaled
                "applied": [1.0] if r_live else [],
                "anchor_mass": None,       # set after a cap re-projection
            })
            return pair
        _map_pairs(grab, state.adapters)
        return FoldState(extra={"w_list": [], "pairs": pairs})

    def fold(self, state, update, weight=None, *, fold_state=None,
             backend="auto"):
        """Exact streaming stack (below the cap): every contributor owns a
        disjoint B-column segment, and the one-shot scales ``m_i_hat *
        R_out / r_i`` change multiplicatively as the cohort grows -- so the
        fold keeps a per-pair ledger of segment ranks, masses and applied
        scales (:attr:`FoldState.extra`), re-scales the existing columns by
        ``desired / applied`` and writes the arriving client's rows at the
        next offset.  Folding a cohort one update at a time reproduces the
        one-shot aggregate.  A stale update is down-weighted, never
        dropped.  A fold that would cross ``stack_r_cap`` re-projects the
        ledgered stack to ``r_max`` by the factored SVD, and the result is
        a fresh anchor whose mass is everything folded so far.  The
        adapter update is a scale and a copy (the JAX package runs it in
        plain array ops too); the base trainables mix through
        ``axpy_fold`` on the kernel backend."""
        fs = fold_state if fold_state is not None else self.init_fold(state)
        if fs.extra is None:
            fs = dataclasses.replace(self.init_fold(state), mass=fs.mass,
                                     n_folds=fs.n_folds)
        w = float(update.n_examples if weight is None else weight)
        if w <= 0:
            raise ValueError(f"fold needs a positive weight, got {w}")
        dev = _state_device(state)

        new_adapters = state.adapters
        extra = fs.extra
        rank_seen = update.rank
        if state.adapters is not None and update.adapters is not None:
            w_list = extra["w_list"] + [w]
            mean_w = sum(w_list) / len(w_list)
            idx = [0]
            new_pairs = []

            def fold_pair(pair, upd_pair):
                meta = extra["pairs"][idx[0]]
                idx[0] += 1
                rk = read_back("strategy", host_array,
                               torch.as_tensor(upd_pair["rank"]))
                if rk.size > 1 and not np.all(rk == rk.flat[0]):
                    raise NotImplementedError(
                        "flora supports layer-stacked pairs only when "
                        "each client's rank is uniform across layers")
                r_upd = int(rk.max()) if rk.size else 0
                storage = pair["A"].shape[-2]
                cap = self.resolve_cap(state.r_max, r_storage=storage)
                self._validate_cap(cap, np.asarray([r_upd]), state.r_max)
                prev_rank = meta["prev_rank"]
                prev_mass = (meta["anchor_mass"]
                             if meta["anchor_mass"] is not None
                             else self.prev_weight * mean_w)
                seg_ranks = (([prev_rank] if prev_rank else [])
                             + meta["seg_ranks"]
                             + ([r_upd] if r_upd else []))
                masses = (([prev_mass] if prev_rank else [])
                          + meta["seg_w"] + ([w] if r_upd else []))
                if not seg_ranks:
                    raise ValueError("flora: empty fold (rank 0 update "
                                     "into an empty state)")
                r_out = int(sum(seg_ranks))
                m = np.asarray(masses, np.float64)
                mhat = m / (m.sum() + _EPS)
                A, B = pair["A"], pair["B"]
                off = r_out - r_upd        # the new segment's row offset
                applied = meta["applied"] + ([1.0] if r_upd else [])
                upd_A = upd_pair["A"][..., :r_upd, :]
                upd_B = upd_pair["B"][..., :, :r_upd].float()

                if r_out <= cap:
                    desired = mhat * (float(r_out)
                                      / np.asarray(seg_ranks, np.float64))
                    # re-scale every existing segment's B columns
                    colscale = np.ones(storage, np.float32)
                    o = 0
                    for j, rj in enumerate(seg_ranks):
                        colscale[o:o + rj] = desired[j] / applied[j]
                        o += rj
                    B = B.float() * torch.as_tensor(colscale, device=dev)
                    if r_upd:
                        A = A.clone()
                        B[..., :, off:off + r_upd] = \
                            float(np.float32(desired[-1])) * upd_B
                        A[..., off:off + r_upd, :] = upd_A.to(A.dtype)
                    new_pairs.append({
                        "prev_rank": prev_rank,
                        "seg_ranks": meta["seg_ranks"]
                        + ([r_upd] if r_upd else []),
                        "seg_w": meta["seg_w"] + ([w] if r_upd else []),
                        "applied": list(desired),
                        "anchor_mass": meta["anchor_mass"],
                    })
                    rank_out = r_out
                else:
                    # cap crossing: product-space re-projection to r_max
                    # over the same matrix the one-shot over-cap path
                    # builds, in factored form
                    r_t = min(int(state.r_max if state.r_max is not None
                                  else storage), cap)
                    desired = mhat * (float(r_t)
                                      / np.asarray(seg_ranks, np.float64))
                    colscale = np.zeros(storage, np.float32)
                    o = 0
                    for j in range(len(seg_ranks) - (1 if r_upd else 0)):
                        rj = seg_ranks[j]
                        colscale[o:o + rj] = desired[j] / applied[j]
                        o += rj
                    B_cat = B.float() * torch.as_tensor(colscale, device=dev)
                    A_cat = A.float()
                    if r_upd:
                        B_cat = torch.cat(
                            [B_cat, float(np.float32(desired[-1])) * upd_B],
                            dim=-1)
                        A_cat = torch.cat([A_cat, upd_A.float()], dim=-2)
                    B_new, A_new = product_factors(B_cat, A_cat, r_t)
                    B = pad_to_rank(B_new.to(B.dtype), -1, storage)
                    A = pad_to_rank(A_new.to(A.dtype), -2, storage)
                    new_pairs.append({
                        "prev_rank": r_t, "seg_ranks": [], "seg_w": [],
                        "applied": [1.0], "anchor_mass": float(m.sum()),
                    })
                    rank_out = r_t
                return {"A": A, "B": B.to(pair["B"].dtype),
                        "rank": torch.full_like(
                            torch.as_tensor(pair["rank"], dtype=torch.int32),
                            rank_out)}

            new_adapters = _map_pairs(fold_pair, state.adapters,
                                      update.adapters, strict=True)
            extra = {"w_list": w_list, "pairs": new_pairs}
            if rank_seen is None:
                rank_seen = max((p["seg_ranks"][-1] for p in new_pairs
                                 if p["seg_ranks"]), default=None)

        kind = self._fold_kind(backend, dev)
        new_base = state.base_trainable
        if tree_leaves(update.base_trainable):
            batch = _FoldBatch()
            new_base = batch.run(kind, batch.add_tree(
                state.base_trainable, update.base_trainable,
                w / (fs.mass + w)))

        new_fs = FoldState(mass=fs.mass + w, n_folds=fs.n_folds + 1,
                           extra=extra)
        current_rank = (adapter_live_ranks(new_adapters)
                        if new_adapters is not None else state.current_rank)
        return ServerState(
            adapters=new_adapters, base_trainable=new_base,
            round=state.round + 1, r_max=state.r_max,
            client_ranks=(torch.tensor([rank_seen], dtype=torch.int32,
                                       device=dev)
                          if rank_seen is not None else state.client_ranks),
            current_rank=current_rank), new_fs

    # ------------------------------------------------- (b) tree traversal --
    def aggregate_tree(self, stacked_tree, mask_tree, weights,
                       prev_tree=None, *, r_max=None, client_ranks=None):
        w = torch.as_tensor(weights).float()

        def agg_pair(pair, _masks, prev_pair):
            pA = prev_pair["A"] if prev_pair is not None else None
            pB = prev_pair["B"] if prev_pair is not None else None
            A_out, B_out, r_out = self._stack_pair(
                pair["A"], pair["B"], self._pair_ranks(pair, client_ranks),
                w, pA, pB, self._prev_rank_of(prev_pair), r_max)
            return {"A": A_out, "B": B_out,
                    "rank": self._out_rank_leaf(pair["rank"], r_out)}
        return _map_pairs(agg_pair, stacked_tree, mask_tree, prev_tree,
                          strict=True)

    # --------------------------------------------- (c) per-pair kernel path --
    def aggregate_tree_kernel(self, stacked_tree, weights, client_ranks,
                              prev_tree=None, *, r_max=None):
        """One ``flora_stack_group`` launch stacks every pair within the
        cap, each side read where it lies and written in its final layout
        and dtype: prev first, then the live clients by index; A rows pass
        verbatim, B columns take ``mhat_i * r_total / r_i``, computed in the
        kernel from the weights; a layer-stacked pair stacks each layer on
        its own.  Over-cap pairs are re-projected by SVD through the pair
        math, for which the TPU package has no kernel either."""
        w = weights.float()
        skeleton, pairs = _collect_pairs(stacked_tree, prev_tree)
        shared = (None if client_ranks is None
                  else self._concrete_ranks(client_ranks))
        outs: list = [None] * len(pairs)
        segs: dict = {k: [] for k in ("xs", "contribs", "prevs", "cols",
                                      "caps", "scales")}
        stacked = []
        for p, (pair, prev_pair) in enumerate(pairs):
            A, B = pair["A"], pair["B"]
            ranks = (shared if shared is not None
                     else self._pair_ranks(pair, None))
            prev_rank = self._prev_rank_of(prev_pair)
            pA = prev_pair["A"] if prev_pair is not None else None
            pB = prev_pair["B"] if prev_pair is not None else None
            cap = self.resolve_cap(r_max, r_storage=A.shape[-2])
            self._validate_cap(cap, ranks, r_max)
            has_prev = pA is not None and bool(prev_rank)
            con = (((-1, int(prev_rank)),) if has_prev else ()) + tuple(
                (i, int(r)) for i, r in enumerate(ranks) if int(r) > 0)
            r_total = sum(r for _, r in con)
            if r_total > cap:
                A_out, B_out, r_out = self._stack_pair(
                    A, B, ranks, w, pA, pB, prev_rank, r_max)
                outs[p] = {"A": A_out, "B": B_out,
                           "rank": self._out_rank_leaf(pair["rank"], r_out)}
                continue
            if not con:
                raise ValueError("flora: empty cohort (all ranks are zero)")
            segs["xs"] += [A, B]
            segs["contribs"] += [con, con]
            segs["prevs"] += [pA, pB] if has_prev else [None, None]
            segs["cols"] += [False, True]
            segs["caps"] += [cap, cap]
            segs["scales"] += [None, "mass"]
            stacked.append((p, r_total))
        if stacked:
            got = flora_stack_group(
                segs["xs"], segs["contribs"], segs["prevs"], cap=segs["caps"],
                cols=segs["cols"], scales=segs["scales"], weights=w,
                prev_weight=self.prev_weight, eps=_EPS, backend="kernel")
            for j, (p, r_total) in enumerate(stacked):
                outs[p] = {"A": got[2 * j], "B": got[2 * j + 1],
                           "rank": _rank_leaf(
                               tuple(pairs[p][0]["rank"].shape[1:]), r_total,
                               pairs[p][0]["rank"].device)}
        return _place_pairs(skeleton, outs)

    # ---------------------------------------------- (f) distributed path --
    def make_distributed_aggregator(self, mesh, client_axis: str = "data"):
        raise NotImplementedError(
            "flora's distributed path is a ragged concat "
            "(gather-then-stack), not a uniform masked psum -- the base "
            "leafwise aggregator would silently average the stacked "
            "factors; use aggregate_tree_distributed / "
            "aggregate_adapters(backend='distributed') instead")

    def aggregate_tree_distributed(self, stacked_tree, mask_tree, weights,
                                   prev_tree=None, *, r_max=None,
                                   client_ranks=None, mesh=None,
                                   client_axis: str = "clients"):
        """Ragged-concat collective: ranks differ per client, so there is
        no uniform sum.  Each rank gathers every rank's slice of the
        factors (gather, then stack) and runs the per-pair stacking round
        replicated, prev first: on the card one ``flora_stack_group``
        launch stacks every pair within the cap
        (:meth:`aggregate_tree_kernel`), on the CPU the plain pair math;
        pairs over the cap are re-projected by ``product_factors``."""
        from .plan import resolve_client_group
        tree, w, cr = _gather_cohort(
            stacked_tree, torch.as_tensor(weights).float(), client_ranks,
            resolve_client_group(mesh, client_axis))
        if resolve_backend("auto", w.device) == "kernel":
            return self.aggregate_tree_kernel(tree, w, cr, prev_tree,
                                              r_max=r_max)
        return self.aggregate_tree(tree, None, w, prev_tree, r_max=r_max,
                                   client_ranks=cr)
