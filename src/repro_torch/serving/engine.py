"""Multi-tenant LoRA serving engine: one kernel launch per layer, every
tenant.

Pairs the frozen base weights with an :class:`~repro_torch.serving.AdapterStore`
and runs the batched multi-adapter kernel
(:func:`repro_torch.kernels.batched_lora_matmul`) over mixed request
batches: each request row carries an adapter id, the ids resolve against
the store's segment tables on the device, and one launch per layer serves
every tenant mix.

Hot swap: :meth:`ServingEngine.publish` installs a freshly aggregated
global (a sync round's output or the live state of an
:class:`~repro_torch.fl.AsyncAggregator`, via its ``on_publish`` hook) into
the store.  A batch runs against one pinned :class:`StoreSnapshot` end to
end, so publishes never tear a batch -- in-flight requests finish on the
version they started with, the next batch picks up the new one.  Each
launch follows the store's stream rule: its stream waits for the write
that made the snapshot's version, and the store learns what it read.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.kernels.lora_matmul import batched_lora_matmul
from repro_torch.obs import get_registry as _obs_registry
from repro_torch.obs import span
from .store import AdapterStore, StoreSnapshot

_SERVE_REQUESTS = _obs_registry().counter(
    "serving_requests_total", "request rows served (per adapted layer)")
_SERVE_BATCHES = _obs_registry().counter(
    "serving_batches_total", "batched kernel launches (one per layer)")
_PUBLISH_FAILURES = _obs_registry().counter(
    "serving_publish_failures_total",
    "hot-swap publishes that raised (readers kept the last snapshot)")
_PUBLISH_QUARANTINED = _obs_registry().gauge(
    "serving_publish_quarantined",
    "1 while the publish path is backing off after failures")

PyTree = Any


class ServingEngine:
    """Serve ``y = x @ W_path + scale_t * (x @ A_t^T) @ B_t^T`` for mixed
    tenant batches.

    Parameters
    ----------
    weights
        ``{path: W}`` frozen base weights, ``W`` of shape
        ``(fan_in, fan_out)`` matching the store's spec for ``path``, on
        the store's device (kept as contiguous tensors: a transposed view
        is copied once here).
    store
        The live :class:`AdapterStore` (shared with the write path).
    impl
        Forwarded to :func:`~repro_torch.kernels.batched_lora_matmul`:
        ``"auto"`` serves the kernel on the card and the segment lowering
        on the CPU.
    """

    def __init__(self, weights: Mapping[str, Any], store: AdapterStore, *,
                 impl: str = "auto"):
        for path, w in weights.items():
            fo, fi = store.specs[path]
            if tuple(w.shape) != (fi, fo):
                raise ValueError(
                    f"{path}: base weight shape {tuple(w.shape)} does not "
                    f"match spec (fan_in={fi}, fan_out={fo})")
            if w.device != store.device:
                raise ValueError(f"{path}: base weight is on {w.device}, "
                                 f"the store on {store.device}")
        missing = set(store.specs) - set(weights)
        if missing:
            raise ValueError(f"missing base weights for {sorted(missing)}")
        self.weights = {p: w.contiguous() for p, w in weights.items()}
        self.store = store
        self.impl = impl
        # publish-failure quarantine state (see :meth:`publisher`):
        # the newest adapter tree a failed hot-swap left unpublished,
        # how many consecutive attempts have failed, and how many more
        # publish opportunities to skip before the next retry
        self._publish_pending: PyTree | None = None
        self._publish_fail_streak = 0
        self._publish_skip = 0
        self.n_publish_failures = 0

    # ------------------------------------------------------------- read --
    def snapshot(self) -> StoreSnapshot:
        """Pin the current store version for an in-flight batch."""
        return self.store.snapshot()

    def apply(self, path: str, x: torch.Tensor, adapter_ids, *,
              snapshot: StoreSnapshot | None = None) -> torch.Tensor:
        """One adapted layer over a mixed batch: ``x`` (..., fan_in),
        ``adapter_ids`` integer ids matching x's leading dims (a tensor on
        the store's device keeps the lookup free of host copies)."""
        if x.device != self.store.device:
            raise ValueError(f"x is on {x.device}, the store on "
                             f"{self.store.device}")
        snap = self.snapshot() if snapshot is None else snapshot
        a_rows, b_rows = snap.pair_buffers(path)
        tbl = snap.table(path)
        snap.wait()
        y = batched_lora_matmul(
            x, self.weights[path], a_rows, b_rows, adapter_ids,
            tbl.off, tbl.rank, tbl.scale, impl=self.impl)
        self.store.note_read((a_rows, b_rows, tbl.off, tbl.rank, tbl.scale))
        n_rows = 1
        for d in x.shape[:-1]:
            n_rows *= int(d)
        _SERVE_REQUESTS.inc(n_rows)
        _SERVE_BATCHES.inc()
        return y

    def forward(self, x: torch.Tensor, adapter_ids, *,
                paths: Sequence[str] | None = None,
                snapshot: StoreSnapshot | None = None) -> torch.Tensor:
        """Chain adapted layers (fan_out of each must feed the next's
        fan_in) under ONE pinned snapshot -- the whole batch sees exactly
        one store version even if a publish lands mid-flight."""
        snap = self.snapshot() if snapshot is None else snapshot
        # one serve span per batch, synchronising once at the boundary --
        # never between layers (that would serialize the chain)
        with span("serve") as sp:
            for path in (list(self.weights) if paths is None else paths):
                x = self.apply(path, x, adapter_ids, snapshot=snap)
            sp.block(x)
        return x

    # ------------------------------------------------------------ write --
    def publish(self, tree: PyTree) -> int:
        """Hot-swap a freshly aggregated global adapter tree into the
        store (see :meth:`AdapterStore.publish`); returns the version."""
        return self.store.publish(tree)

    def publisher(self, max_backoff: int = 8) -> Callable:
        """An ``on_publish`` hook for :class:`~repro_torch.fl.AsyncAggregator`:
        called with each advanced :class:`~repro_torch.core.ServerState`,
        swaps its adapters into the live store.

        **Degrades gracefully** when the store rejects a swap: the failed
        tree is quarantined -- readers keep serving the last *committed*
        :class:`StoreSnapshot`, which a failed ``AdapterStore.publish``
        never tears -- and the hook retries on a later publish opportunity
        with exponential backoff (skip 1, 2, 4, ... up to ``max_backoff``
        opportunities).  Each retry carries the **newest** pending state,
        not the one that failed: serving an old global after several folds
        would re-widen the very staleness gap aggregation just closed.
        Failures count under ``serving_publish_failures_total``;
        ``serving_publish_quarantined`` is 1 while backing off.
        """
        if max_backoff < 1:
            raise ValueError(
                f"max_backoff must be >= 1, got {max_backoff}")

        def _publish(state) -> None:
            if state.adapters is not None:
                # latest-wins: a newer aggregate supersedes whatever a
                # failed attempt left in quarantine
                self._publish_pending = state.adapters
            if self._publish_pending is None:
                return
            if self._publish_skip > 0:
                self._publish_skip -= 1
                return
            try:
                self.publish(self._publish_pending)
            except Exception:
                self.n_publish_failures += 1
                self._publish_fail_streak += 1
                self._publish_skip = min(
                    2 ** (self._publish_fail_streak - 1), max_backoff)
                _PUBLISH_FAILURES.inc()
                _PUBLISH_QUARANTINED.set(1)
                return              # readers stay on the last snapshot
            self._publish_pending = None
            self._publish_fail_streak = 0
            self._publish_skip = 0
            _PUBLISH_QUARANTINED.set(0)
        return _publish


def merged_reference(engine: ServingEngine, path: str, x, adapter_ids, *,
                     snapshot: StoreSnapshot | None = None) -> torch.Tensor:
    """Per-tenant dense oracle for :meth:`ServingEngine.apply` (tests and
    the chip script): each tenant's segment sliced out of the snapshot's
    buffers and applied to its requests in fp32 on the host.  Returns fp32
    on x's device."""
    snap = engine.snapshot() if snapshot is None else snapshot
    snap.wait()
    a_rows, b_rows = (t.float().cpu() for t in snap.pair_buffers(path))
    tbl = snap.table(path)
    off, rank = tbl.off.cpu().tolist(), tbl.rank.cpu().tolist()
    scale = tbl.scale.cpu().tolist()
    ids = torch.as_tensor(adapter_ids).reshape(-1).cpu()
    x2 = x.reshape(-1, x.shape[-1]).float().cpu()
    w = engine.weights[path].float().cpu()
    out = x2 @ w
    for t in ids.unique().tolist():
        rows = (ids == t).nonzero().reshape(-1)
        seg = slice(off[t], off[t] + rank[t])
        out[rows] += scale[t] * ((x2[rows] @ a_rows[seg].T) @ b_rows[seg])
    return out.reshape(tuple(x.shape[:-1]) + (w.shape[1],)).to(x.device)


__all__ = ["ServingEngine", "merged_reference"]
