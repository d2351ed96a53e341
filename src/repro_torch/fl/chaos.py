"""Deterministic fault injection for the FLaaS service (the port's copy of
``repro.fl.chaos``).

A :class:`FaultPlan` is a *seeded decision oracle*: every fault draw is
keyed by ``(seed, fault kind, event index)`` through an independent
counter-based numpy stream, so the same plan over the same simulation
config injects exactly the same faults -- run to run, machine to machine,
and package to package: the draws are the JAX package's, bit for bit.
That determinism is what makes the crash-consistency gates assertable:
the chaos run is reproducible, so "recovered bit-identical" is a hard
equality, not a statistical claim.

The plan covers the failure modes an at-least-once FLaaS deployment
sees:

* ``drop`` -- an upload lost in transit; the client retries it (same
  ``update_id``) under a jittered :class:`~repro_torch.fl.comm.RetryPolicy`.
* ``duplicate`` -- the transport delivers one upload twice; the server's
  :class:`~repro_torch.fl.comm.DedupWindow` must fold it exactly once.
* ``reorder`` -- an upload delayed past its peers, arriving staler than
  it was sent.
* ``corrupt`` / ``truncate`` -- NaN-poisoned tensors and payloads cut
  short mid-pair; both must bounce off the ingestion front door
  (``nan_tensor`` / ``malformed`` rejections), never reach the WAL or the
  fold.
* ``stale_pull`` -- a client training on a long-obsolete global.
* ``publish_fail`` -- the serving store rejects a hot-swap; the engine
  keeps serving the last committed snapshot and retries with backoff
  (:meth:`repro_torch.serving.ServingEngine.publisher`, made flaky by
  :func:`flaky`).
* ``crash_at`` -- server crash-restart points (counts of received
  uploads); the simulator tears the aggregator down and recovers it from
  its checkpoint and WAL (:class:`~repro_torch.fl.DurableAggregator`).

Injection points live in :func:`repro_torch.fl.run_async_simulation`
(``fault_plan=``) and the serving publish hook.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.strategy import ClientUpdate
from repro_torch.lora import tree_map_pairs
from repro_torch.tree import tree_map

# stable per-kind stream ids (the JAX package's): inserting a new kind
# must not shift the draws of existing plans
_KINDS = {"drop": 1, "duplicate": 2, "reorder": 3, "corrupt": 4,
          "truncate": 5, "stale_pull": 6, "publish_fail": 7}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, immutable fault schedule.  All probabilities are per event
    (per delivery attempt for ``drop``, per upload otherwise);
    ``crash_at`` is a tuple of received-upload counts at which the
    simulator crash-restarts the server."""

    seed: int = 0
    p_drop: float = 0.0
    p_duplicate: float = 0.0
    p_reorder: float = 0.0
    reorder_delay_s: float = 5.0
    p_corrupt: float = 0.0
    p_truncate: float = 0.0
    p_stale_pull: float = 0.0
    p_publish_fail: float = 0.0
    crash_at: tuple = ()

    def __post_init__(self):
        for name in ("p_drop", "p_duplicate", "p_reorder", "p_corrupt",
                     "p_truncate", "p_stale_pull", "p_publish_fail"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.reorder_delay_s < 0:
            raise ValueError(
                f"reorder_delay_s must be >= 0, got {self.reorder_delay_s}")
        object.__setattr__(self, "crash_at",
                           tuple(int(c) for c in self.crash_at))

    # ------------------------------------------------------------- draws --
    def _fires(self, kind: str, idx: int, salt: int, p: float) -> bool:
        if p <= 0.0:
            return False
        rng = np.random.default_rng(
            (self.seed, _KINDS[kind], int(idx), int(salt)))
        return bool(rng.uniform() < p)

    def drop(self, uid: int, attempt: int = 0) -> bool:
        """Is delivery ``attempt`` of upload ``uid`` lost in transit?"""
        return self._fires("drop", uid, attempt, self.p_drop)

    def duplicate(self, uid: int) -> bool:
        return self._fires("duplicate", uid, 0, self.p_duplicate)

    def reorder(self, uid: int) -> bool:
        return self._fires("reorder", uid, 0, self.p_reorder)

    def corrupt(self, uid: int) -> bool:
        return self._fires("corrupt", uid, 0, self.p_corrupt)

    def truncate(self, uid: int) -> bool:
        return self._fires("truncate", uid, 0, self.p_truncate)

    def stale_pull(self, uid: int) -> bool:
        return self._fires("stale_pull", uid, 0, self.p_stale_pull)

    def publish_fail(self, idx: int) -> bool:
        """Does the ``idx``-th publish attempt fail?  Wire this into a
        flaky store (:func:`flaky`) in front of ``ServingEngine.publish``."""
        return self._fires("publish_fail", idx, 0, self.p_publish_fail)

    def crash_now(self, n_accepted: int) -> bool:
        return int(n_accepted) in self.crash_at

    # ---------------------------------------------------------- mutators --
    def corrupt_update(self, update: ClientUpdate) -> ClientUpdate:
        """NaN-poison the first element of the first non-empty float
        tensor (bit rot, a bad DMA on the wire); the input is not
        touched.  The ingestion front door must reject it as
        ``nan_tensor``."""
        def poison(tree):
            done = [False]

            def leaf(x):
                if (not done[0] and isinstance(x, torch.Tensor)
                        and x.is_floating_point() and x.numel()):
                    done[0] = True
                    x = x.clone()
                    x.view(-1)[0] = float("nan")
                return x
            return tree_map(leaf, tree)

        if update.adapters is not None:
            return dataclasses.replace(update,
                                       adapters=poison(update.adapters))
        return dataclasses.replace(
            update, base_trainable=poison(update.base_trainable))

    def truncate_update(self, update: ClientUpdate) -> ClientUpdate:
        """Cut the payload short mid-pair (a proxy timeout): A loses its
        last rank row, so ``A.shape[-2] != B.shape[-1]`` and the front
        door must reject it as ``malformed``.  FFT updates (no adapter
        pairs to truncate) degrade to corruption."""
        if update.adapters is None:
            return self.corrupt_update(update)

        def chop(pair):
            out = dict(pair)
            out["A"] = pair["A"][..., :-1, :]
            return out

        return dataclasses.replace(
            update, adapters=tree_map_pairs(chop, update.adapters))


def flaky(fn, plan: FaultPlan, kind: str = "publish_fail"):
    """Wrap a callable so its ``idx``-th invocation raises when the plan
    says that attempt fails -- the way to make a store's ``publish`` flaky
    in tests and the chip script."""
    counter = {"n": 0}

    def wrapped(*a: Any, **kw: Any):
        idx = counter["n"]
        counter["n"] += 1
        if plan._fires(kind, idx, 0, getattr(plan, f"p_{kind}")):
            raise RuntimeError(f"injected {kind} fault (attempt {idx})")
        return fn(*a, **kw)

    return wrapped


__all__ = ["FaultPlan", "flaky"]
