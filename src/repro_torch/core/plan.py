"""Compiled aggregation plans: one grouped launch per round.

Walking the adapter tree pair by pair costs launches per pair.  A plan
turns a round into

1. **Segments.**  Every pair side of the cohort is one segment of the
   round's grouped call, in the leaf's own layout: A ``(*lead, r,
   fan_in)`` by rank row, B ``(*lead, fan_out, r)`` by rank column.  Each
   rank row carries its owner mask column (delta_{i,r}), which is static
   given the cohort's rank multiset, so the whole ``(n, rank rows)``
   owner-mask matrix is built on the host once per plan.  Layer-stacked
   pairs take one mask column per (layer, rank row).
2. **Combine.**  The mean family (and rbla_norm's norm restoration, and
   ``prev_global`` retention) is one ``packed_agg_group`` call, the robust
   family one ``packed_robust_group`` call (through ``grouped_launch``,
   its card path without the per-call argument checks: the plan checked
   the geometry once): one launch a round on the card, the plain version
   on the ``ref`` backend.  Nothing is packed,
   transposed, stacked or cast around it.  Encoded (int8/bf16) cohorts
   hand each client's wire-dtype leaves and int8 scales to the same call,
   which dequantises on the load.  flora's stack plan is one
   ``packed_stack_group`` call over the same segments (every pair side
   within the cap, prev first and the live clients at host-known
   offsets), each output written at its cap in its final layout and
   dtype; svd buckets pairs by their full geometry and runs one batched
   factored SVD per bucket (``repro_torch.core.lowrank``).
3. **Cache.**  Plans are cached on the strategy instance keyed by the
   :class:`CohortSpec` (tree structure, shapes, dtypes, rank multiset,
   codec mix, backend, device, client mesh) and the strategy's
   ``plan_knobs`` in a bounded LRU; see ``AggregationStrategy.plan``.
   The JAX plans also memoise their packed buckets per cohort (a
   :class:`BufferMemo` over the stacked leaves); here there is nothing to
   pack, because the grouped kernels read every leaf where it lies, so a
   plan keeps no pack memo.  ``AggregationStrategy.aggregate_adapters``
   memoises the stacking of a repeated cohort (:class:`BufferMemo`).
4. **Donation.**  ``CompiledRound.__call__(..., donate=True)`` writes the
   round's outputs into the previous global's A/B storage, where the JAX
   plans donate it: the mean and robust rounds (plain and encoded) and
   flora's stacking round, for a strategy that retains prev and a round
   that has one (a side whose prev is not stored as the output is, in
   dtype, layout and -- for the stack -- at the cap, gets a fresh one).
   The grouped kernels take prev's storage as their output pointer
   (``outs=``; each kernel's comment says why the alias is safe), and the
   write keeps the stream rule of ``repro_torch.core.donation``.  The svd,
   collective and per-leaf rounds ignore ``donate``, as JAX's do.

On the ``distributed`` backend the mean family's round is one collective:
each rank reduces its slice of the clients, every pair side where it lies,
into fp32 numerators and denominators, and one ``all_reduce`` of one
buffer sums them (:func:`_build_mean_distributed`); flora and svd take
their gathered collectives through the per-leaf path
(``repro_torch.core.distributed`` states the contract).

:func:`build_fold_plan` hands every pair side of the server state to the
async fold's one grouped ``axpy_fold`` call, each leaf in its own layout.
The per-leaf ``aggregate_tree*`` methods remain the plans' oracles.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.rbla_agg import (packed_agg_group_ref,
                                          packed_robust_group_ref,
                                          packed_stack_group,
                                          packed_stack_group_ref, stack_plan)
from repro_torch.kernels.rbla_agg.ops import grouped_launch, write_into
from repro_torch.obs.trace import read_back

from . import donation
from .aggregation import _EPS
from .compat import all_reduce_sum, client_group, default_mesh, local_slice
from .masks import pad_to_rank

PyTree = Any


class PlanUnavailable(Exception):
    """A plan cannot be built for these inputs (bare leaves, mismatched
    prev shapes); callers take the per-leaf path, which handles
    everything."""


class BufferMemo:
    """Single-entry memo keyed by the *identity and version* of tensors
    (the JAX package's ``BufferMemo``, whose arrays are immutable; here a
    tensor's ``_version``, which every in-place edit bumps, stands in for
    immutability):

    * a fingerprint is every leaf's ``(id, _version)``: an in-place edit of
      any leaf misses, and an id is trusted only while a weakref pins it to
      its tensor;
    * only tensors that need no gradient are fingerprinted;
    * the payload is released eagerly: ``weakref.finalize`` on the leaves
      drops the entry the moment any of them is collected, so a memo never
      pins a dead cohort's bytes;
    * with ``require_repeat=True`` a payload is kept only for a fingerprint
      seen on consecutive stores: a loop whose cohorts never repeat keeps a
      fingerprint and weakrefs, not a cohort-sized payload.
    """

    def __init__(self, require_repeat: bool = False):
        self._require_repeat = require_repeat
        self._entry = None             # (fingerprint, payload, refs, token)
        self._candidate = None         # (fingerprint, refs): seen once

    @staticmethod
    def fingerprint(leaves) -> tuple | None:
        if not leaves or not all(isinstance(v, torch.Tensor)
                                 and not v.requires_grad for v in leaves):
            return None
        return tuple((id(v), v._version) for v in leaves)

    def lookup(self, leaves):
        """The stored payload iff ``leaves`` are exactly the tensors, at
        exactly the versions, it was stored under; None otherwise."""
        entry = self._entry
        if entry is None:
            return None
        fp, payload, refs, _ = entry
        if any(r() is None for r in refs):
            self._entry = None
            return None
        return payload if self.fingerprint(list(leaves)) == fp else None

    def store(self, leaves, payload) -> None:
        import weakref
        leaves = list(leaves)
        fp = self.fingerprint(leaves)
        if fp is None:
            return
        if self._require_repeat:
            cand = self._candidate
            if not (cand is not None and cand[0] == fp
                    and all(r() is not None for r in cand[1])):
                self._candidate = (fp, [weakref.ref(v) for v in leaves])
                return
        token = object()
        self._entry = (fp, payload, [weakref.ref(v) for v in leaves], token)
        wself = weakref.ref(self)

        def _release(wself=wself, token=token):
            m = wself()
            if m is not None and m._entry is not None and m._entry[3] is token:
                m._entry = None
        for v in leaves:               # any leaf dying releases it
            weakref.finalize(v, _release)


def default_client_mesh(client_axis: str = "clients"):
    """The 1-D client mesh over every rank of the default process group --
    the shared default of every distributed aggregation path -- or
    ``None`` when no group is initialised (``compat.default_mesh``).
    The reference sizes its mesh to the largest device count dividing the
    cohort; here each rank takes a slice as even as the cohort allows
    (``compat.client_slices``), so the mesh is always the whole world."""
    return default_mesh(client_axis)


def resolve_client_group(mesh, client_axis: str):
    """The process group a distributed round reduces over: ``client_axis``
    of ``mesh``, or of :func:`default_client_mesh` for ``mesh=None``
    (``None`` again, and no collective, without a process group)."""
    if mesh is None:
        mesh = default_client_mesh(client_axis)
    return client_group(mesh, client_axis)


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
        return read_back("plan.spec", host_array, x)
    return np.asarray(x)


def host_array(x: torch.Tensor) -> np.ndarray:
    """``x``'s values in a host array (a copy from the card for a device
    tensor)."""
    return x.detach().cpu().numpy()


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
    prev_rank_shape: tuple | None = None
    prev_ranks: tuple | None = None
    prev_a_dtype: torch.dtype | None = None
    prev_b_dtype: torch.dtype | None = None

    def rank_values(self) -> np.ndarray:
        return np.asarray(self.ranks, np.int64).reshape(self.rank_shape)

    def prev_rank_values(self) -> np.ndarray | None:
        if self.prev_ranks is None:
            return None
        return np.asarray(self.prev_ranks,
                          np.int64).reshape(self.prev_rank_shape)


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """Hashable plan-cache key: everything a plan closes over."""
    n_clients: int
    kind: str               # resolved: "ref" | "kernel" | "distributed"
    r_max: int | None
    pairs: tuple[PairMeta, ...]
    client_ranks: tuple | None
    has_prev: bool
    device: str
    #: per-client upload codec names ("none" | "bf16" | "int8") of an
    #: encoded cohort; None for a plain stacked cohort
    codecs: tuple | None = None
    #: the distributed round's client mesh (a ``DeviceMesh``; None for the
    #: default one) and the axis its clients lie along
    mesh: Any = None
    client_axis: str = "clients"


def build_cohort_spec(stacked_tree: PyTree, *, kind: str,
                      r_max: int | None = None, client_ranks=None,
                      prev_tree: PyTree | None = None, mesh=None,
                      client_axis: str = "clients") -> CohortSpec:
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
            prk = _host(pp["rank"])
            meta.update(prev_a_shape=tuple(pp["A"].shape),
                        prev_b_shape=tuple(pp["B"].shape),
                        prev_rank_shape=tuple(prk.shape),
                        prev_ranks=tuple(int(v) for v in prk.ravel()),
                        prev_a_dtype=pp["A"].dtype,
                        prev_b_dtype=pp["B"].dtype)
        pairs.append(PairMeta(**meta))
    if not pairs:
        raise PlanUnavailable("no LoRA pairs in the cohort tree")
    return CohortSpec(n_clients=pairs[0].a_shape[0], kind=kind, r_max=r_max,
                      pairs=tuple(pairs), client_ranks=client_ranks,
                      has_prev=prev_tree is not None, device=device,
                      mesh=mesh, client_axis=client_axis)


def build_encoded_cohort_spec(client_trees: Sequence, codecs, *, kind: str,
                              r_max: int | None = None, client_ranks=None,
                              prev_tree: PyTree | None = None) -> CohortSpec:
    """Describe an *encoded* cohort: per-client adapter trees in their wire
    dtypes (``repro_torch.core.codec``), never stacked -- stacking int8 next
    to fp32 would promote, i.e. stage an fp32 copy.  ``codecs`` is the
    per-client codec tuple (``cohort_codecs``); the pair metadata records
    the decoded (fp32) dtypes, so bucketing and unpacking match the fp32
    cohort and only ``spec.codecs`` tells the wire layout."""
    codecs = tuple(codecs)
    n = len(client_trees)
    if len(codecs) != n:
        raise PlanUnavailable(f"{len(codecs)} codecs for {n} clients")
    if any(c not in ("none", "bf16", "int8") for c in codecs):
        raise PlanUnavailable(
            "per-pair mixed codecs inside one client are not plannable")
    prev_pairs = (dict(_walk_pairs(prev_tree))
                  if prev_tree is not None else {})
    walked = [list(_walk_pairs(t)) for t in client_trees]
    paths = [p for p, _ in walked[0]]
    for i, wl in enumerate(walked[1:], start=1):
        if [p for p, _ in wl] != paths:
            raise PlanUnavailable(
                f"client {i}'s tree structure differs from client 0's")
    if client_ranks is not None:
        client_ranks = tuple(int(v) for v in _host(client_ranks).ravel())
    inferred: list | None = [] if client_ranks is None else None
    pairs = []
    device = None
    for pi, path in enumerate(paths):
        shapes, rks = [], []
        for i in range(n):
            pair = walked[i][pi][1]
            device = device or str(pair["A"].device)
            shapes.append((tuple(pair["A"].shape), tuple(pair["B"].shape)))
            rks.append(_host(pair["rank"]))
        if any(m != shapes[0] for m in shapes[1:]):
            raise PlanUnavailable(
                f"clients disagree on pair shapes at {path}")
        rk = np.stack(rks)
        if inferred is not None and pi == 0 and rk.ndim == 1:
            inferred.extend(int(v) for v in rk)
        meta = dict(path=path, a_shape=(n,) + shapes[0][0],
                    a_dtype=torch.float32, b_shape=(n,) + shapes[0][1],
                    b_dtype=torch.float32, rank_shape=tuple(rk.shape),
                    ranks=tuple(int(v) for v in rk.ravel()))
        if prev_tree is not None:
            if path not in prev_pairs:
                raise PlanUnavailable(f"prev tree missing pair at {path}")
            pp = prev_pairs[path]
            prk = _host(pp["rank"])
            meta.update(prev_a_shape=tuple(pp["A"].shape),
                        prev_b_shape=tuple(pp["B"].shape),
                        prev_rank_shape=tuple(prk.shape),
                        prev_ranks=tuple(int(v) for v in prk.ravel()),
                        prev_a_dtype=pp["A"].dtype,
                        prev_b_dtype=pp["B"].dtype)
        pairs.append(PairMeta(**meta))
    if not pairs:
        raise PlanUnavailable("no LoRA pairs in the cohort trees")
    if client_ranks is None and inferred:
        client_ranks = tuple(inferred)
    return CohortSpec(n_clients=n, kind=kind, r_max=r_max,
                      pairs=tuple(pairs), client_ranks=client_ranks,
                      has_prev=prev_tree is not None, device=device,
                      codecs=codecs)


# ---------------------------------------------------------- packed layout --
@dataclasses.dataclass
class Slot:
    """One pair side's home in a round: its rank rows start at column
    ``offset`` of the owner masks."""
    pair_idx: int
    side: str                  # "A" | "B"
    lead: tuple                # leading (layer/expert) dims
    r_st: int                  # storage rank rows per lead index
    rows: int                  # prod(lead) * r_st
    width: int
    dtype: torch.dtype
    offset: int = 0            # its first rank row in the round or bucket


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


def pair_side_rows(x: torch.Tensor, side: str) -> torch.Tensor:
    """Rank-axis-leading row view of one pair side: A ``(..., r, fan_in)``
    passes through, B ``(..., fan_out, r)`` rides transposed to
    ``(..., r, fan_out)``.  Applying it twice restores the leaf layout."""
    return x.transpose(-1, -2) if side == "B" else x


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


def _pairs_at(tree, paths) -> list:
    """The pairs of ``tree`` at ``paths``, in that order: a plan walks the
    first tree it sees once (its cache key fixes the structure)."""
    out = []
    for path in paths:
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


# ------------------------------------------------------------ the product --
class CompiledRound:
    """One aggregation round for a fixed :class:`CohortSpec`.

    ``__call__(stacked_tree, weights, prev_tree=None, donate=False)`` runs
    the round; ``donate=True`` writes it into ``prev_tree``'s A/B storage
    where the plan honours donation (see the module docstring; the caller
    must not read the old global afterwards).
    ``kind`` is "packed" (a planned round), "distributed" (the mean
    family's collective round) or "eager" (the per-leaf path);
    ``n_kernel_launches`` is the packed plan's device computations per
    round (1 for the mean and robust families; for the stack plan 1 if
    any pair stacks, plus one per pair re-projected by SVD; #buckets for
    the svd plan; 0 for the collective round, whose reductions are plain
    PyTorch ops around its ``all_reduce``);
    ``n_fallback_pairs`` counts the pairs a packed plan still routes
    through reference pair math (flora's over-cap re-projection).
    """

    def __init__(self, strategy, spec: CohortSpec, kind: str,
                 execute: Callable, *, n_kernel_launches: int | None = None,
                 n_fallback_pairs: int = 0):
        self.strategy = strategy
        self.spec = spec
        self.kind = kind
        self._execute = execute
        self.n_kernel_launches = n_kernel_launches
        self.n_fallback_pairs = n_fallback_pairs

    def __call__(self, stacked_tree: PyTree, weights, prev_tree=None,
                 donate: bool = False) -> PyTree:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=self.spec.device)
        return self._execute(stacked_tree, w, prev_tree, donate)


def _donated(prevs, shapes, dtypes) -> list:
    """Each segment's donated output: its prev where prev is stored as the
    output is (shape, dtype, contiguous), else None (a fresh one)."""
    return [p if p is not None and tuple(p.shape) == tuple(shape)
            and p.dtype == dt and p.is_contiguous() else None
            for p, shape, dt in zip(prevs, shapes, dtypes)]


def _plain_into(fn):
    """A plain twin that writes into ``outs=`` as the kernels do: the ref
    kind runs the plain versions wherever the tensors lie, the card
    included, where the public wrappers would launch."""
    def run(*args, outs=None, **kw):
        return write_into(outs, fn(*args, **kw))
    return run



def _out_rank_leaves(spec: CohortSpec, r_out_per_pair=None) -> list:
    """Finalized rank leaves: r_max (or the storage rank) everywhere, or
    each pair's own output rank (stack plans)."""
    if r_out_per_pair is None:
        r_out_per_pair = [spec.r_max if spec.r_max is not None
                          else meta.a_shape[-2] for meta in spec.pairs]
    return [torch.full(tuple(meta.rank_shape[1:]), int(r_out),
                       dtype=torch.int32, device=spec.device)
            for meta, r_out in zip(spec.pairs, r_out_per_pair)]


def _client_ranks(spec: CohortSpec):
    if spec.client_ranks is None:
        return None
    return torch.tensor(spec.client_ranks, dtype=torch.int32,
                        device=spec.device)


# ------------------------------------------------------- grouped mean plans --
def _mean_segments(spec: CohortSpec, use_mask: bool):
    """The round's segments, every pair's A then B, and the owner-mask
    matrix ``(n, rank rows)`` built on the host once per plan: the
    columns of pair side s are its rank rows, lead-major."""
    slots, cols, off = [], [], 0
    for pi, meta in enumerate(spec.pairs):
        for side in ("A", "B"):
            lead, r_st, rows, width, dtype = _side_geometry(meta, side)
            slots.append(Slot(pair_idx=pi, side=side, lead=lead, r_st=r_st,
                              rows=rows, width=width, dtype=dtype,
                              offset=off))
            cols.append(_slot_mask(meta, slots[-1], spec.n_clients,
                                   use_mask))
            off += rows
    return slots, np.concatenate(cols, axis=1)


def _build_mean_round(strategy, spec: CohortSpec,
                      norm_restore: bool = False) -> CompiledRound:
    """Mean (and robust) round: every pair side of the cohort is one
    segment of one ``packed_agg_group`` / ``packed_robust_group`` call, in
    the leaf's own layout (A by rank row, B by rank column): one launch a
    round on the card, one plain call on the CPU.  A stacked cohort hands
    the stacked leaves; an encoded one (``spec.codecs``) each client's
    wire-dtype leaves and int8 scales, which the kernel dequantises on the
    load (the output is fp32)."""
    slots, mask = _mean_segments(spec, strategy.use_mask)
    retains = strategy.retains_prev and spec.has_prev
    if retains:
        for meta in spec.pairs:       # mean plans overlay prev row for row
            if (meta.prev_a_shape != meta.a_shape[1:]
                    or meta.prev_b_shape != meta.b_shape[1:]):
                raise PlanUnavailable(
                    "prev leaf shapes differ from the cohort's")
    if spec.kind == "distributed":
        return _build_mean_distributed(strategy, spec, slots, mask, retains)
    cr = _client_ranks(spec)
    rank_leaves = _out_rank_leaves(spec)
    masks = torch.as_tensor(mask, device=spec.device)
    encoded = spec.codecs is not None
    kw = dict(cols=[s.side == "B" for s in slots],
              mask_offs=[s.offset for s in slots],
              out_dtypes=[s.dtype for s in slots])
    # the robust family shares the segments; its knobs are read here, once,
    # and are part of the plan's cache key (strategy.plan_knobs)
    robust = strategy.robustness
    if robust != "none":
        name, combine = "packed_robust", packed_robust_group_ref
        kw.update(mode=robust, clip_norm=float(strategy.clip_norm),
                  trim_frac=float(strategy.trim_frac))
    else:
        name, combine = "packed_agg", packed_agg_group_ref
        kw.update(norm_by=strategy.norm_by, norm_restore=norm_restore)
    combine = _plain_into(combine)
    if spec.kind == "kernel":       # the segments' geometry is checked here
        combine = functools.partial(grouped_launch, name)
    shapes = [_side_shape(s) for s in slots]
    scale_key = {"A": "A_scale", "B": "B_scale"}
    nones = [None] * len(slots)
    rebuild, paths = [None], [None]

    def pairs_of(tree) -> list:
        return _pairs_at(tree, paths[0])

    def execute(cohort, w, prev_tree, donate):
        if rebuild[0] is None:
            first = cohort[0] if encoded else cohort
            rebuild[0] = _make_rebuilder(first)
            paths[0] = [p for p, _ in _walk_pairs(first)]
        prevs = nones
        if retains:
            prev_ab = pairs_of(prev_tree)
            prevs = [prev_ab[s.pair_idx][s.side] for s in slots]
        if encoded:
            clients = [pairs_of(t) for t in cohort]
            xs = [[c[s.pair_idx][s.side] for c in clients] for s in slots]
            scales = [[c[s.pair_idx].get(scale_key[s.side]) for c in clients]
                      for s in slots]
        else:
            ab = pairs_of(cohort)
            xs = [ab[s.pair_idx][s.side] for s in slots]
            scales = nones
        outs = None
        if donate and retains:
            outs = _donated(prevs, shapes, kw["out_dtypes"])
            donation.begin_write(outs)
        res = combine(xs, masks, strategy.transform_weights(w, cr), prevs,
                      scales=scales, outs=outs, **kw)
        if outs is not None:
            donation.end_write(outs, (xs, scales, prevs))
        outs = res
        pairs = [{"A": None, "B": None, "rank": rank_leaves[i]}
                 for i in range(len(spec.pairs))]       # the leaves' order
        for s, out in zip(slots, outs):
            pairs[s.pair_idx][s.side] = out
        return rebuild[0](pairs)

    return CompiledRound(strategy, spec, "packed", execute,
                         n_kernel_launches=1)


# ------------------------------------------------ the collective mean round --
def _side_shape(s: Slot) -> tuple:
    """A slot's leaf shape: A ``(*lead, r, fan_in)``, B ``(*lead, fan_out,
    r)``."""
    return s.lead + ((s.r_st, s.width) if s.side == "A"
                     else (s.width, s.r_st))


def _build_mean_distributed(strategy, spec: CohortSpec, slots, mask,
                            retains: bool) -> CompiledRound:
    """The mean family's collective round.  Each rank takes its slice of
    the clients (``compat.local_slice``) and reduces every pair side where
    it lies -- A by rank row, B by rank column -- into fp32 numerators
    ``sum_i w_i m_ir x_i`` and denominators ``sum_i w_i m_ir`` (the total
    weight for ``norm_by="weight"``); every side's numerator and
    denominator go into one fp32 buffer and one ``all_reduce`` a round
    sums them over the client group.  The combine is the reference's:
    ``num / (den + eps)`` where an owner has mass, else prev (strategies
    that retain it) or 0.  Every rank returns the same aggregate; without
    a process group the rank's slice is the whole cohort and no collective
    runs.  The weights are transformed on the whole cohort first (a slice
    does not see the global rank vector)."""
    n = spec.n_clients
    cr = _client_ranks(spec)
    rank_leaves = _out_rank_leaves(spec)
    masks = torch.as_tensor(mask, device=spec.device)
    by_weight = strategy.norm_by == "weight"
    shapes = [_side_shape(s) for s in slots]
    sizes = ([math.prod(sh) for sh in shapes]
             + ([1] if by_weight else [s.rows for s in slots]))
    rebuild, paths = [None], [None]

    def execute(stacked_tree, w, prev_tree, donate):
        if rebuild[0] is None:
            rebuild[0] = _make_rebuilder(stacked_tree)
            paths[0] = [p for p, _ in _walk_pairs(stacked_tree)]
        group = resolve_client_group(spec.mesh, spec.client_axis)
        loc = local_slice(n, group)
        ab = _pairs_at(stacked_tree, paths[0])
        wt = strategy.transform_weights(w, cr)[loc]
        nums, dens = [], []
        for s, shape in zip(slots, shapes):
            x = ab[s.pair_idx][s.side][loc].float()
            wm = wt[:, None] * masks[loc, s.offset:s.offset + s.rows]
            # (n_loc, L, r) owner weights against (n_loc, L, r, fan_in) A
            # rows or (n_loc, L, fan_out, r) B columns
            L = s.rows // s.r_st
            sub = "nlr,nlrd->lrd" if s.side == "A" else "nlr,nldr->ldr"
            nums.append(torch.einsum(
                sub, wm.reshape(-1, L, s.r_st),
                x.reshape((-1, L) + shape[len(s.lead):])).reshape(-1))
            if not by_weight:
                dens.append(wm.sum(0))
        if by_weight:
            dens.append(wt.sum().reshape(1))
        buf = all_reduce_sum(torch.cat(nums + dens), group)
        parts = torch.split(buf, sizes)
        pairs = [{"A": None, "B": None, "rank": rank_leaves[i]}
                 for i in range(len(spec.pairs))]
        prev_ab = _pairs_at(prev_tree, paths[0]) if retains else None
        for i, (s, shape) in enumerate(zip(slots, shapes)):
            num = parts[i].reshape(shape)
            if by_weight:
                out = num / (parts[-1] + _EPS)
            else:       # one value a rank row: A's rows, B's columns
                den = parts[len(slots) + i].reshape(s.lead + (
                    (s.r_st, 1) if s.side == "A" else (1, s.r_st)))
                fb = (prev_ab[s.pair_idx][s.side].float() if retains
                      else torch.zeros_like(num))
                out = torch.where(den > 0, num / (den + _EPS), fb)
            pairs[s.pair_idx][s.side] = out.to(s.dtype)
        return rebuild[0](pairs)

    return CompiledRound(strategy, spec, "distributed", execute,
                         n_kernel_launches=0)


# ------------------------------------------------------ packed stack plans --
def _build_stack_round(strategy, spec: CohortSpec) -> CompiledRound:
    """flora's packed plan: every pair side within the cap is one segment
    of one ``packed_stack_group`` call, the cohort leaf and prev read where
    they lie and the output written at the cap in its final layout and
    dtype (A by rank row, B by rank column with flora's mass scales
    computed in the kernel): one launch a round on the card, the plain
    twin on the ``ref`` backend.  Contributors (prev first, then the live
    clients by index) and their offsets come from the host-known ranks,
    so the segments are fixed here and a call fills in only the pointers
    and reads no rank.  Pairs whose stacked rank exceeds the cap are
    re-projected by SVD through the strategy's pair math in the same
    round."""
    n = spec.n_clients

    # ---- static per-pair stacking geometry ------------------------------
    plans = []
    for meta in spec.pairs:
        ranks = meta.rank_values()
        if ranks.ndim > 1:           # layer-stacked: flora needs uniform
            flat = ranks.reshape(n, -1)
            if not np.all(flat == flat[:, :1]):
                raise PlanUnavailable(
                    "flora packs layer-stacked pairs only with uniform "
                    "per-client ranks")
            ranks = flat[:, 0]
        ranks = ranks.reshape(-1).astype(np.int64)
        _, r_st_a, _, _, _ = _side_geometry(meta, "A")
        cap = strategy.resolve_cap(spec.r_max, r_storage=r_st_a)
        strategy._validate_cap(cap, ranks, spec.r_max)
        prev_rank = 0
        if spec.has_prev and meta.prev_ranks is not None:
            prev_rank = int(np.max(meta.prev_rank_values()))
        con = ((((-1, prev_rank),) if prev_rank else ())
               + tuple((i, int(r)) for i, r in enumerate(ranks) if r > 0))
        if not con:
            raise PlanUnavailable("flora: empty cohort (all ranks are zero)")
        r_total = sum(r for _, r in con)
        plans.append(dict(ranks=ranks, cap=cap, prev_rank=prev_rank,
                          con=con, r_total=r_total, packable=r_total <= cap))

    def capped_r_out(p, meta):        # _stack_pair's over-cap branch
        base = spec.r_max if spec.r_max is not None else meta.a_shape[-2]
        return min(int(base), p["cap"])

    rank_leaves = _out_rank_leaves(
        spec, [p["r_total"] if p["packable"] else capped_r_out(p, m)
               for p, m in zip(plans, spec.pairs)])

    # ---- the round's segments: each packable pair's A, then its B -------
    sides, seg = [], {k: [] for k in ("shapes", "contribs", "prev_shapes",
                                      "prev_dtypes", "cols", "caps",
                                      "dtypes", "scales")}
    for pi, (meta, p) in enumerate(zip(spec.pairs, plans)):
        if not p["packable"]:
            continue
        for side in ("A", "B"):
            a = side == "A"
            sides.append((pi, side))
            seg["shapes"].append(meta.a_shape if a else meta.b_shape)
            seg["dtypes"].append(meta.a_dtype if a else meta.b_dtype)
            seg["contribs"].append(p["con"])
            seg["cols"].append(not a)
            seg["caps"].append(p["cap"])
            seg["scales"].append(None if a else "mass")
            with_prev = bool(p["prev_rank"])
            seg["prev_shapes"].append(
                (meta.prev_a_shape if a else meta.prev_b_shape)
                if with_prev else None)
            seg["prev_dtypes"].append(
                (meta.prev_a_dtype if a else meta.prev_b_dtype)
                if with_prev else None)
    stack = None
    if sides:
        try:            # the geometry is checked here, once
            stack = stack_plan(
                seg["shapes"], seg["contribs"], cap=seg["caps"],
                dtypes=seg["dtypes"], cols=seg["cols"],
                prev_shapes=seg["prev_shapes"],
                prev_dtypes=seg["prev_dtypes"], scales=seg["scales"],
                prev_weight=float(strategy.prev_weight), eps=_EPS)
        except (ValueError, TypeError) as e:
            raise PlanUnavailable(str(e)) from e
    combine = (functools.partial(packed_stack_group, backend="kernel")
               if spec.kind == "kernel"
               else _plain_into(packed_stack_group_ref))
    fallback = [pi for pi, p in enumerate(plans) if not p["packable"]]
    rebuild, paths = [None], [None]

    def execute(stacked_tree, w, prev_tree, donate):
        if rebuild[0] is None:
            rebuild[0] = _make_rebuilder(stacked_tree)
            paths[0] = [p for p, _ in _walk_pairs(stacked_tree)]
        ab = _pairs_at(stacked_tree, paths[0])
        prev_ab = _pairs_at(prev_tree, paths[0]) if spec.has_prev else None
        results: dict = {}
        if stack is not None:
            xs = [ab[pi][side] for pi, side in sides]
            prevs = [None if ps is None else prev_ab[pi][side]
                     for (pi, side), ps in zip(sides, stack.prev_shapes)]
            outs = None
            if donate and spec.has_prev:
                outs = _donated(prevs, stack.layout.shapes,
                                stack.layout.out_dtypes)
                donation.begin_write(outs)
            res = combine(stack, xs, prevs, w, outs=outs)
            if outs is not None:
                donation.end_write(outs, (xs, prevs))
            results.update(zip(sides, res))
        for pi in fallback:          # over the cap: SVD re-projection
            p = plans[pi]
            pA = pB = None
            if p["prev_rank"]:
                pA, pB = prev_ab[pi]["A"], prev_ab[pi]["B"]
            A_out, B_out, _ = strategy._stack_pair(
                ab[pi]["A"], ab[pi]["B"], p["ranks"], w, pA, pB,
                p["prev_rank"] or None, spec.r_max)
            results[(pi, "A")], results[(pi, "B")] = A_out, B_out
        return rebuild[0]([{"A": results[(pi, "A")],
                            "B": results[(pi, "B")],
                            "rank": rank_leaves[pi]}
                           for pi in range(len(spec.pairs))])

    round_ = CompiledRound(strategy, spec, "packed", execute,
                           n_kernel_launches=int(stack is not None)
                           + len(fallback),
                           n_fallback_pairs=len(fallback))
    round_.stack_plan = stack           # the segments, or None
    round_.stack_sides = tuple(sides)   # each segment's (pair, side)
    return round_


# -------------------------------------------------------- packed svd plans --
def _build_svd_round(strategy, spec: CohortSpec) -> CompiledRound:
    """svd's packed plan: pairs bucket by their full geometry (a batched
    SVD needs both sides of a pair) and each bucket runs one batched
    factored SVD (``repro_torch.core.lowrank``), the bucket's pairs riding
    as a leading batch axis.  The ``r_out / rank`` scales are built on the
    host once per plan."""
    r_outs = [meta.a_shape[-2] if spec.r_max is None
              else min(spec.r_max, meta.a_shape[-2]) for meta in spec.pairs]
    by_key: dict = {}
    for pi, meta in enumerate(spec.pairs):
        key = (meta.a_shape, meta.a_dtype, meta.b_shape, meta.b_dtype,
               meta.rank_shape, r_outs[pi])
        by_key.setdefault(key, []).append(pi)
    groups = list(by_key.values())
    rank_leaves = _out_rank_leaves(spec)

    # per-bucket (n, P, *lead) scales: each pair's (n, *rank_lead) scales
    # aligned with its trailing leading dims, then stacked after the
    # client axis like the pairs themselves
    group_scales = []
    for idxs in groups:
        per_pair = []
        for pi in idxs:
            meta = spec.pairs[pi]
            rk = (np.asarray(spec.client_ranks, np.float32)
                  if spec.client_ranks is not None
                  else meta.rank_values().astype(np.float32))
            sc = np.float32(r_outs[pi]) / np.maximum(rk, np.float32(1.0))
            lead = tuple(meta.a_shape[1:-2])
            mid = len(lead) - (sc.ndim - 1)
            sc = sc.reshape(sc.shape[:1] + (1,) * mid + sc.shape[1:])
            per_pair.append(np.broadcast_to(sc, sc.shape[:1] + lead))
        group_scales.append(torch.as_tensor(np.stack(per_pair, axis=1),
                                            device=spec.device))
    rebuild = [None]

    def execute(stacked_tree, w, prev_tree, donate):
        if rebuild[0] is None:
            rebuild[0] = _make_rebuilder(stacked_tree)
        ab = _ab_list(stacked_tree)
        results: dict = {}
        for idxs, scales in zip(groups, group_scales):
            meta = spec.pairs[idxs[0]]
            r_st, r_out = meta.a_shape[-2], r_outs[idxs[0]]
            Bs = torch.stack([ab[pi]["B"] for pi in idxs], dim=1)
            As = torch.stack([ab[pi]["A"] for pi in idxs], dim=1)
            Bo, Ao = strategy._project(Bs, As, w, r_out, scales)
            for j, pi in enumerate(idxs):
                results[pi] = {
                    "A": pad_to_rank(Ao[j], -2, r_st).to(meta.a_dtype),
                    "B": pad_to_rank(Bo[j], -1, r_st).to(meta.b_dtype),
                    "rank": rank_leaves[pi]}
        return rebuild[0]([results[pi] for pi in range(len(spec.pairs))])

    return CompiledRound(strategy, spec, "packed", execute,
                         n_kernel_launches=len(groups))


def _build_eager_round(strategy, spec: CohortSpec) -> CompiledRound:
    """The per-leaf path behind a plan's interface (cohorts a packed plan
    cannot take, and flora's and svd's gathered collectives)."""
    cr = _client_ranks(spec)

    def execute(stacked_tree, w, prev_tree, donate):
        from repro_torch.lora import adapter_masks
        prev = prev_tree if strategy.retains_prev else None
        if spec.kind == "kernel":
            out = strategy.aggregate_tree_kernel(stacked_tree, w, cr, prev,
                                                 r_max=spec.r_max)
        elif spec.kind == "distributed":
            out = strategy.aggregate_tree_distributed(
                stacked_tree, adapter_masks(stacked_tree), w, prev,
                r_max=spec.r_max, client_ranks=cr, mesh=spec.mesh,
                client_axis=spec.client_axis)
        else:
            masks = adapter_masks(stacked_tree)
            out = strategy.aggregate_tree(stacked_tree, masks, w, prev,
                                          r_max=spec.r_max, client_ranks=cr)
        return strategy.finalize_tree(out, spec.r_max)

    return CompiledRound(strategy, spec, "eager", execute)


def build_plan(strategy, spec: CohortSpec) -> CompiledRound:
    """The :class:`CompiledRound` for ``strategy`` x ``spec``.

    ``plan_mode`` "mean" packs every cohort (the robust family included);
    "mean_norm" (rbla_norm) packs scalar-rank pairs and leaves
    layer-stacked ones to the per-leaf path (which refuses them); "stack"
    is flora's copy/scale round; "svd" the batched factored SVD round.
    Encoded cohorts plan only on the mean family; any other case raises
    :class:`PlanUnavailable` for them, and the caller decodes.  On the
    ``distributed`` backend "mean" is the collective round, "mean_norm"
    refuses, and "stack" and "svd" take their gathered collectives through
    the per-leaf path."""
    mode = getattr(strategy, "plan_mode", None)
    if spec.kind == "distributed":
        if spec.codecs is not None:
            raise PlanUnavailable("encoded cohorts decode before a "
                                  "distributed round")
        if mode == "mean_norm":
            raise NotImplementedError(
                f"strategy {strategy.name!r}: the per-row norm restore has "
                "no distributed round; use backend='ref'")
        if mode == "mean":
            try:
                return _build_mean_round(strategy, spec)
            except PlanUnavailable:
                pass
        return _build_eager_round(strategy, spec)
    if spec.codecs is not None:
        if mode == "mean" or (mode == "mean_norm" and all(
                len(m.a_shape) == 3 for m in spec.pairs)):
            return _build_mean_round(strategy, spec,
                                     norm_restore=mode == "mean_norm")
        raise PlanUnavailable("encoded cohorts plan only on the mean family "
                              "(scalar-rank pairs for mean_norm)")
    try:
        if mode == "mean":
            return _build_mean_round(strategy, spec)
        if mode == "mean_norm" and all(len(m.a_shape) == 3
                                       for m in spec.pairs):
            return _build_mean_round(strategy, spec, norm_restore=True)
        if mode == "stack":
            return _build_stack_round(strategy, spec)
        if mode == "svd":
            return _build_svd_round(strategy, spec)
    except PlanUnavailable:
        pass
    return _build_eager_round(strategy, spec)


# ------------------------------------------------------------- fold plans --
def build_state_spec(adapters: PyTree, *, kind: str) -> CohortSpec:
    """A :class:`CohortSpec` for a *server state* tree (no client axis):
    the fold plan's cache key -- shapes, dtypes, device and backend.  Rank
    values are not part of it: folds take them as data, so one plan serves
    every client."""
    pairs = []
    device = None
    for path, pair in _walk_pairs(adapters):
        A, B = pair["A"], pair["B"]
        device = device or str(A.device)
        rk_shape = tuple(torch.as_tensor(pair["rank"]).shape)
        pairs.append(PairMeta(
            path=path, a_shape=(1,) + tuple(A.shape), a_dtype=A.dtype,
            b_shape=(1,) + tuple(B.shape), b_dtype=B.dtype,
            rank_shape=(1,) + rk_shape,
            ranks=(0,) * int(np.prod(rk_shape, dtype=np.int64))))
    if not pairs:
        raise PlanUnavailable("no LoRA pairs in the state tree")
    return CohortSpec(n_clients=1, kind=kind, r_max=None, pairs=tuple(pairs),
                      client_ranks=None, has_prev=False, device=device)


def build_fold_plan(strategy, spec: CohortSpec) -> Callable:
    """Per-update fold plan of a server state (the async hot path).

    Every pair side of the state becomes one segment of the fold's grouped
    ``axpy_fold`` call, with RBLA's per-rank-row rates ``wa / (d + wa)``
    on the rows the update owns (0 elsewhere); B keeps its own layout, its
    rank axis last.  One launch per dtype triple folds the whole state,
    whatever the number of pairs.  Returns
    ``fold_fn(batch, state_ab, upd_ab, row_mass, wa, rank_leaves) ->
    (new_ab, new_row_mass)``: the sides join ``batch`` (the strategy's
    fold batch, which the caller runs) and ``new_ab`` holds its
    placeholders; ``rank_leaves`` are the update's per-pair rank tensors
    on the device (data, so one plan serves every client)."""
    dev = torch.device(spec.device)
    # per pair: the storage-row indices and the leading (layer) dims
    geo = [(torch.arange(meta.a_shape[-2], device=dev),
            tuple(meta.a_shape[1:-2])) for meta in spec.pairs]

    def fold_fn(batch, state_ab, upd_ab, row_mass, wa, rank_leaves):
        new_ab, new_mass = [], []
        for (rows, lead), st, up, dmass, rank in zip(
                geo, state_ab, upd_ab, row_mass, rank_leaves):
            owned = (rows < rank[..., None]).float()
            alpha = torch.where(owned > 0, wa / (dmass + wa), 0.0)
            new_mass.append(dmass + wa * owned)
            mid = len(lead) - (alpha.ndim - 1)
            if mid:             # one rank per leading index of the leaf
                alpha = alpha.reshape(tuple(alpha.shape[:-1]) + (1,) * mid
                                      + tuple(alpha.shape[-1:])).expand(
                    lead + tuple(alpha.shape[-1:]))
            new_ab.append({"A": batch.add(st["A"], up["A"], alpha),
                           "B": batch.add(st["B"], up["B"], alpha,
                                          col=True)})
        return new_ab, new_mass

    return fold_fn


__all__ = ["BufferMemo", "CohortSpec", "PairMeta", "CompiledRound",
           "PlanUnavailable",
           "build_cohort_spec", "build_encoded_cohort_spec", "build_plan",
           "build_fold_plan", "build_state_spec", "pair_side_rows",
           "default_client_mesh", "resolve_client_group"]
