"""Aggregation strategies: one pluggable API over every path.

Each method is one :class:`AggregationStrategy` that owns

* (a) its **leaf math** (:meth:`AggregationStrategy.leaf`),
* (b) its **tree traversal** with ``prev_global`` retention
  (:meth:`AggregationStrategy.aggregate_tree`, the ``ref`` backend),
* (c) a **per-pair kernel path**
  (:meth:`AggregationStrategy.aggregate_tree_kernel`), and
* (d) a **compiled plan** (``repro_torch.core.plan``): packed buckets, one
  ``packed_agg`` launch per bucket -- the default route of
  :meth:`AggregationStrategy.aggregate_adapters`,

behind ``backend="auto" | "ref" | "kernel"`` (``"pallas"`` is an alias of
``"kernel"``): ``auto`` runs the kernels for tensors on a CUDA device and
the plain PyTorch versions for tensors on the CPU.

This slice ports the mean family: fedavg, zeropad, rbla, rbla_ranked and
rbla_norm.  The svd, flora and robust strategies, encoded (int8/bf16)
uploads, the async fold and the distributed backend raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Mapping, Sequence

import torch

from repro_torch.kernels.rbla_agg import packed_agg, rbla_agg
from repro_torch.kernels.runtime import resolve_backend, resolve_device
from repro_torch.tree import tree_leaves, tree_map

from .aggregation import fedavg_leaf, rbla_leaf, zeropad_leaf
from .masks import stacked_rank_masks
from .variants import rank_proportional_weights, rbla_norm_leaf

PyTree = Any

#: per-strategy-instance LRU bound on cached plans (keyed by the cohort's
#: rank multiset among other things; a random-cohort service sees many)
PLAN_CACHE_SIZE = 128

#: registered JAX-package strategies this port does not have yet
_LATER = {
    "svd": "ROADMAP queue 1 item 10 (svd slice)",
    "flora": "ROADMAP queue 1 item 11 (flora slice)",
    "rbla_clipped": "ROADMAP queue 1 item 12 (robust slice)",
    "rbla_trimmed": "ROADMAP queue 1 item 12 (robust slice)",
    "rbla_median": "ROADMAP queue 1 item 12 (robust slice)",
}


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
    if name in _LATER:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet; it arrives with "
            f"{_LATER[name]}")
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


def _retain_prev(tree: PyTree, prev: PyTree,
                 client_ranks: torch.Tensor) -> PyTree:
    """Rank-rows no participant owns (r >= max participant rank) keep the
    server's current value."""
    rmax_part = client_ranks.max()

    def fix(pair, prev_pair):
        owned = (torch.arange(pair["A"].shape[-2], device=pair["A"].device)
                 < rmax_part)
        return {
            "A": torch.where(owned[:, None], pair["A"],
                             prev_pair["A"].to(pair["A"].dtype)),
            "B": torch.where(owned[None, :], pair["B"],
                             prev_pair["B"].to(pair["B"].dtype)),
            "rank": pair["rank"],
        }
    return _map_pairs(fix, tree, prev)


def _reject_encoded(client_adapters: Sequence[PyTree]) -> None:
    for ad in client_adapters:
        for pair in _pairs(ad):
            if ("A_scale" in pair or "B_scale" in pair
                    or pair["A"].dtype == torch.bfloat16):
                raise NotImplementedError(
                    "encoded (int8/bf16) uploads are not ported yet; they "
                    "arrive with ROADMAP queue 1 item 13 (codec slice)")


def _pairs(tree) -> list:
    out: list = []
    _map_pairs(lambda p: out.append(p) or p, tree)
    return out


def _device_of(tree) -> torch.device | None:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else None


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
    #: buckets, "mean_norm" = + per-row norm restore
    plan_mode: str | None = None

    # ------------------------------------------------------ compiled plans --
    def plan(self, state, cohort_spec):
        """Compiled round for ``cohort_spec`` (see ``repro_torch.core.plan``),
        cached on this instance in a bounded LRU keyed by the spec;
        :attr:`plan_stats` counts hits and misses.  ``state`` is unused
        (the spec encodes the layout) and may be None."""
        from .plan import build_plan
        cache = self.__dict__.setdefault("_plan_cache", OrderedDict())
        stats = self.__dict__.setdefault("plan_stats",
                                         {"hits": 0, "misses": 0})
        got = cache.get(cohort_spec)
        if got is not None:
            stats["hits"] += 1
            cache.move_to_end(cohort_spec)
            return got
        stats["misses"] += 1
        built = build_plan(self, cohort_spec)
        cache[cohort_spec] = built
        while len(cache) > PLAN_CACHE_SIZE:
            cache.popitem(last=False)
        return built

    def _plan_round(self, stacked, kind, *, r_max, client_ranks, prev):
        """Plan for an already-stacked cohort; ``None`` when the cohort
        cannot be described host-side (bare leaves)."""
        from .plan import PlanUnavailable, build_cohort_spec
        try:
            spec = build_cohort_spec(stacked, kind=kind, r_max=r_max,
                                     client_ranks=client_ranks,
                                     prev_tree=prev)
        except PlanUnavailable:
            return None
        return self.plan(None, spec)

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
        """Two ``rbla_agg`` launches per pair: A ``(n, r_max, fan_in)``
        directly, B ``(n, fan_out, r_max)`` as a contiguous rank-leading
        copy.  Takes scalar-rank pairs only (layer-stacked pairs go through
        the compiled plan)."""
        w = self.transform_weights(weights.float(), client_ranks)

        def agg_pair(pair, prev_pair):
            A, B = pair["A"], pair["B"]
            pranks = self._pair_ranks(pair, client_ranks)
            outA = rbla_agg(A.contiguous(), pranks, w,
                            method=self.kernel_method, backend="kernel")
            outB = rbla_agg(B.transpose(1, 2).contiguous(), pranks, w,
                            method=self.kernel_method,
                            backend="kernel").T.contiguous()
            out = {"A": outA, "B": outB, "rank": pair["rank"][0]}
            if prev_pair is not None and self.retains_prev:
                out = _retain_prev(out, prev_pair, pranks)
            return out

        return _map_pairs(agg_pair, stacked_tree, prev_tree, strict=True)

    def _pair_ranks(self, pair, client_ranks) -> torch.Tensor:
        A, B = pair["A"], pair["B"]
        pranks = client_ranks
        if pranks is None and pair["rank"].ndim == 1:
            pranks = pair["rank"]
        if A.ndim != 3 or B.ndim != 3 or pranks is None:
            raise NotImplementedError(
                "the per-pair kernel path takes scalar-rank pairs (got "
                f"A.ndim={A.ndim}); layer-stacked pairs go through the "
                "compiled plan (use_plan=True)")
        if not self.use_mask:
            return torch.full((A.shape[0],), A.shape[-2], dtype=torch.int32,
                              device=A.device)
        return torch.as_tensor(pranks, dtype=torch.int32, device=A.device)

    # ----------------------------------------------------- mid-level API --
    def aggregate_adapters(self, client_adapters: Sequence[PyTree], weights,
                           *, r_max: int | None = None, client_ranks=None,
                           prev_global: PyTree | None = None,
                           backend: str = "auto",
                           use_plan: bool = True) -> PyTree:
        """Aggregate per-client adapter trees into the global adapter.

        Stacks the uploads and runs the round through a cached compiled
        plan (one fused launch per bucket); ``use_plan=False`` takes the
        per-leaf path (``aggregate_tree_kernel`` on the kernel backend,
        ``aggregate_tree`` on ref).  Live ranks are reset to ``r_max``."""
        from repro_torch.lora import adapter_masks
        _reject_encoded(client_adapters)
        stacked = stack_trees(client_adapters)
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
                                      client_ranks=client_ranks, prev=prev)
            if round_ is not None:
                return round_(stacked, w, prev)
        if kind == "kernel":
            out = self.aggregate_tree_kernel(stacked, w, client_ranks, prev,
                                             r_max=r_max)
        else:
            masks = stack_trees([adapter_masks(a) for a in client_adapters])
            out = self.aggregate_tree(stacked, masks, w, prev, r_max=r_max,
                                      client_ranks=client_ranks)
        return self.finalize_tree(out, r_max)

    def finalize_tree(self, out: PyTree, r_max: int | None) -> PyTree:
        """Fixed-rank strategies reset every pair's live rank to r_max."""
        return _fix_rank(out, r_max)

    # ---------------------------------------------------- high-level API --
    def aggregate(self, state: ServerState,
                  client_updates: Sequence[ClientUpdate], weights=None, *,
                  backend: str = "auto", device="cuda") -> ServerState:
        """One server round: fold a participant cohort into ``state``.

        Non-LoRA trainables are FedAvg'd; adapters go through this
        strategy.  ``weights`` defaults to the updates' ``n_examples``.
        The state's tensors must lie on ``device``."""
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
                prev_global=state.adapters, backend=backend)

        current_rank = (adapter_live_ranks(new_adapters)
                        if new_adapters is not None else state.current_rank)
        return ServerState(adapters=new_adapters, base_trainable=new_base,
                           round=state.round + 1, r_max=state.r_max,
                           client_ranks=(ranks if ranks is not None
                                         else state.client_ranks),
                           current_rank=current_rank)

    # ---------------------------------------------------- per-update fold --
    def init_fold(self, state):
        raise NotImplementedError(
            "the per-update fold is not ported yet; it arrives with ROADMAP "
            "queue 1 item 14 (async slice)")

    def fold(self, state, update, weight=None, **kw):
        raise NotImplementedError(
            "the per-update fold is not ported yet; it arrives with ROADMAP "
            "queue 1 item 14 (async slice)")


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

    def leaf(self, stacked, mask, weights, prev=None):
        return rbla_leaf(stacked, mask, weights, prev)


@register_strategy
class RBLARankedStrategy(RBLAStrategy):
    """RBLA with rank-proportional client weights (HetLoRA-flavoured)."""
    name = "rbla_ranked"

    def transform_weights(self, weights, client_ranks=None):
        if client_ranks is None:
            raise ValueError("rbla_ranked needs client_ranks to reweight "
                             "clients by rank; pass client_ranks (or use "
                             "aggregate_adapters on adapter trees, which "
                             "infers them)")
        return rank_proportional_weights(
            weights, torch.as_tensor(client_ranks, device=weights.device))


@register_strategy
class RBLANormStrategy(AggregationStrategy):
    """RBLA + per-row update-norm preservation (pair-structured: the row
    axis differs between A and B, so it traverses whole pairs)."""
    name = "rbla_norm"
    norm_by = "mask"
    plan_mode = "mean_norm"

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
        """The masked mean and the per-row norm restore in one
        ``packed_agg(norm_restore=True)`` launch per side."""
        w = weights.float()

        def agg_pair(pair, _prev):
            A, B = pair["A"], pair["B"]
            masks = stacked_rank_masks(A.shape[-2],
                                       self._pair_ranks(pair, client_ranks))
            outA = packed_agg(A.contiguous(), masks, w, norm_by="mask",
                              norm_restore=True, backend="kernel")
            outB = packed_agg(B.transpose(1, 2).contiguous(), masks, w,
                              norm_by="mask", norm_restore=True,
                              backend="kernel").T.contiguous()
            return {"A": outA.to(A.dtype), "B": outB.to(B.dtype),
                    "rank": pair["rank"][0]}
        return _map_pairs(agg_pair, stacked_tree, prev_tree, strict=True)
