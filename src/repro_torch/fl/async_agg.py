"""Async staleness-aware aggregation service (the FLaaS serving loop).

In FLaaS, clients on phones, desktops, and accelerators report at wildly
different cadences; a synchronous cohort round moves at the pace of its
slowest participant.  This module makes aggregation a **long-lived
service** instead of a pure per-round function: an
:class:`AsyncAggregator` owns a live
:class:`~repro_torch.core.strategy.ServerState` and folds individual
:class:`~repro_torch.core.strategy.ClientUpdate` objects into it as they
arrive, discounting each update by how *stale* it is -- how many server
versions were published between the global the client trained on and the
moment its update lands (``staleness_clock="version"``), or how much
service-clock time elapsed since the client pulled
(``staleness_clock="wall"``).

Staleness weighting follows FedAsync (Xie et al., 2019): the update's
mass ``n_examples`` is scaled by a schedule ``s(tau)`` in ``(0, 1]``:

* ``constant``:    ``s(tau) = 1`` (staleness ignored),
* ``polynomial``:  ``s(tau) = (1 + tau) ** -a``,
* ``hinge``:       ``s(tau) = 1`` if ``tau <= b`` else
  ``1 / (a * (tau - b) + 1)``.

The scaled mass then flows through **each strategy's own weight
semantics** -- RBLA's per-rank-row masked mean, zero-padding's dilution,
flora's stacked-contributor masses (a stale stacked contributor is
*down-weighted*, never dropped) -- via the per-update
:meth:`~repro_torch.core.strategy.AggregationStrategy.fold` hook.

Three service modes:

* **fully async** (``buffer_size=1``): every arrival folds immediately.
  Strategies declaring ``supports_incremental=True`` stream exactly (one
  O(state) pass per update); the rest are *replayed* -- the service keeps
  the updates folded since the last anchor and recomputes the joint
  aggregate, so sequential folding reproduces the one-shot cohort result
  bit-for-bit at zero staleness for every registered strategy.
* **buffered semi-async** (``buffer_size=K`` and/or ``deadline``):
  arrivals buffer in a :class:`~repro_torch.fl.comm.UpdateBuffer` and
  flush as one mini-cohort when K updates are waiting or the oldest has
  waited past the deadline (FedBuff-style).
* **sync** degenerates to ``buffer_size = cohort size``: one flush per
  round is exactly the classic ``strategy.aggregate``.

The service runs on the device of the state it is given; no fold writes
into a tensor of the state, so the anchor, the replay window, a state
handed to ``on_publish`` and the snapshots clients pulled all stay valid.
:meth:`AsyncAggregator.state_dict` / :meth:`~AsyncAggregator.load_state_dict`
carry the whole service across a crash (:mod:`repro_torch.fl.durability`).
See ``docs/async.md`` for formulas and mode trade-offs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.checkpoint import GeneratorState, host_copy
from repro_torch.core.codec import (CODECS, UploadValidationError,
                                    codec_of_pair, decode_update,
                                    stochastic_round_tree, tree_codec,
                                    validate_encoded_adapters)
from repro_torch.core.codec import _iter_pairs as _iter_adapter_pairs
from repro_torch.core.strategy import (ClientUpdate, FoldState, ServerState,
                                       _state_device, get_strategy)
from repro_torch.fl.comm import (BufferedUpdate, DedupWindow, UpdateBuffer,
                                 tree_bytes)
from repro_torch.obs import (STALENESS_BUCKETS, get_registry, read_back,
                             span, trace_span)
from repro_torch.tree import tree_leaves, tree_map

#: the machine-readable rejection reasons ``fl_updates_rejected_total``
#: counts; every ingestion raise, the zero-mass flush drop, and the
#: idempotency dedup map to exactly one
REJECT_REASONS = ("bad_mass", "codec_not_allowed", "bad_scale",
                  "overflow", "nan_tensor", "malformed",
                  "zero_mass_flush", "duplicate")

#: schedule name -> factory(a, b) -> s(tau); all monotone non-increasing
#: in tau with s(0) == 1 (fresh updates are never discounted)
STALENESS_SCHEDULES = {
    "constant": lambda a, b: lambda tau: 1.0,
    "polynomial": lambda a, b: lambda tau: float((1.0 + tau) ** -a),
    "hinge": lambda a, b: lambda tau: (
        1.0 if tau <= b else 1.0 / (a * (tau - b) + 1.0)),
}


def to_device(tree, device: torch.device):
    """``tree`` with every tensor on ``device`` (a tensor already there is
    kept, none is written in place); other leaves pass through."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


def make_staleness_fn(schedule: "str | Callable[[float], float]"
                      = "polynomial", *, a: float = 0.5,
                      b: float = 4.0) -> Callable[[float], float]:
    """Resolve a staleness schedule by name (or pass a callable through).

    ``a`` is the decay strength (polynomial exponent / hinge slope), ``b``
    the hinge's grace period in server versions.
    """
    if callable(schedule):
        return schedule
    try:
        factory = STALENESS_SCHEDULES[schedule]
    except KeyError:
        raise ValueError(
            f"unknown staleness schedule {schedule!r}; options: "
            f"{sorted(STALENESS_SCHEDULES)} or a callable") from None
    if a <= 0:
        raise ValueError(f"staleness decay a must be > 0, got {a}")
    return factory(a, b)


class AsyncAggregator:
    """A long-lived aggregation service over one strategy and one state.

    Parameters
    ----------
    strategy
        Registered strategy name or instance (configured copies welcome).
    state
        Initial :class:`ServerState`; the service owns it from here on
        (read the live one from :attr:`state`).
    staleness, staleness_a, staleness_b
        Schedule for the staleness discount (see :func:`make_staleness_fn`).
    buffer_size, deadline
        Semi-async knobs: flush when ``buffer_size`` updates are waiting,
        or when the oldest buffered update has waited ``deadline`` clock
        units (checked on :meth:`submit` / :meth:`maybe_flush` -- the
        event loop supplies the clock).  ``buffer_size=1`` is fully async.
    staleness_clock
        What ``tau`` measures: ``"version"`` (default) counts server
        versions published between the client's pull and its upload
        (FedAsync's discrete clock); ``"wall"`` measures elapsed service
        clock -- ``now - pulled_at`` -- so a schedule's decay ``a`` /
        grace ``b`` are in the event loop's time units and slow *wall
        time*, not fold churn, is what discounts an update.
    backend
        Execution backend for the underlying strategy paths (``auto |
        ref | kernel | distributed``; ``auto`` takes the kernels for a
        state on a CUDA device; ``distributed`` runs each flush's cohort
        round over the client group and each single-update fold on the
        device's own backend).
    replay_window
        Fully-async mode only: non-incremental strategies replay the
        updates folded since the last anchor; after this many the service
        re-anchors at the current state (bounding memory and making the
        accumulated state the new retention baseline).
    on_publish, publish_every
        The serving hot-swap hook: after every ``publish_every``-th state
        advance, ``on_publish(state)`` is called with the live
        :class:`ServerState` (a serving engine's publisher, for one).
        ``publish_every > 1`` batches swaps when folds land faster than
        serving wants new versions.
    server_momentum
        FedBuff/FedAvgM-style server momentum ``beta`` in ``[0, 1)`` on
        the fold path: each state advance publishes ``s_old + m`` with
        ``m <- beta * m + (s_new - s_old)`` over the adapters' float
        leaves (``beta=0`` disables, bit-exact).  The buffer
        (:attr:`FoldState.momentum`) lives on
        aggregated state only, so secure-aggregation-compatible
        buffering is unaffected.  Requires a fixed-rank strategy
        (``rank_contract="fixed"``): a rank-changing live rank would
        change the buffer's meaning round to round.
    codecs
        Upload codecs this service accepts (negotiated allow-list, a
        subset of :data:`repro_torch.core.codec.CODECS`); a single name is
        promoted to a 1-tuple.  Uploads using any other wire format are
        rejected at the ingestion front door.  Quantized uploads stay
        encoded through the buffer -- the plan layer fuses
        dequantization into the aggregation kernel -- and are decoded
        only on the incremental/replay fold paths, which operate on
        fp32 trees.
    accum_dtype
        ``None`` (default, fp32 accumulators, bit-exact) or
        ``"bfloat16"``: between folds the live accumulators -- the
        state's adapter float leaves and the server-momentum buffer --
        are stored in bf16, written back with **stochastic rounding**
        (:func:`repro_torch.core.codec.stochastic_round`) so the
        accumulator is unbiased over folds; fold arithmetic itself stays
        fp32.
        ``FoldState`` masses (``mass``, ``row_mass``) stay fp32 --
        rounding the denominators would bias every subsequent mean.
    seed
        Seed of the service's ``torch.Generator`` (on the state's device)
        that draws the stochastic-rounding noise, leaf by leaf in
        traversal order.  Folds are reproducible: a fixed seed and the
        same submission sequence yield bit-identical accumulators.
    dedup_window
        How many recently accepted client ``update_id`` strings the
        service remembers (:class:`~repro_torch.fl.comm.DedupWindow`).  With
        at-least-once delivery (client retries, WAL replay) the same
        logical upload can arrive twice; a ``submit(...,
        update_id=...)`` whose id is inside the window is dropped as a
        ``"duplicate"`` instead of double-folding its mass.  Uploads
        without an id are never deduplicated.
    registry
        The :class:`~repro_torch.obs.MetricsRegistry` this service reports
        into (exposed as :attr:`obs_registry`; ``None`` = the process
        default).
    """

    STALENESS_CLOCKS = ("version", "wall")

    def __init__(self, strategy, state: ServerState, *,
                 staleness="constant", staleness_a: float = 0.5,
                 staleness_b: float = 4.0, staleness_clock: str = "version",
                 buffer_size: int = 1,
                 deadline: float | None = None, backend: str = "auto",
                 replay_window: int = 64,
                 on_publish: "Callable | None" = None,
                 publish_every: int = 1,
                 server_momentum: float = 0.0,
                 codecs=CODECS,
                 accum_dtype=None,
                 seed: int = 0,
                 dedup_window: int = 1024,
                 registry=None):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if replay_window < 1:
            raise ValueError(
                f"replay_window must be >= 1, got {replay_window}")
        if publish_every < 1:
            raise ValueError(
                f"publish_every must be >= 1, got {publish_every}")
        if staleness_clock not in self.STALENESS_CLOCKS:
            raise ValueError(
                f"unknown staleness_clock {staleness_clock!r}; options: "
                f"{self.STALENESS_CLOCKS}")
        if not 0.0 <= server_momentum < 1.0:
            raise ValueError(
                f"server_momentum must be in [0, 1), got {server_momentum}")
        if isinstance(codecs, str):
            codecs = (codecs,)
        codecs = tuple(codecs)
        unknown = [c for c in codecs if c not in CODECS]
        if unknown or not codecs:
            raise ValueError(
                f"unknown upload codec(s) {unknown or codecs}; options: "
                f"{list(CODECS)}")
        self.codecs = codecs
        if accum_dtype is not None and accum_dtype not in (torch.bfloat16,
                                                           "bfloat16"):
            raise ValueError(
                "accum_dtype must be None (fp32) or bfloat16, got "
                f"{accum_dtype!r}")
        self.accum_dtype = None if accum_dtype is None else torch.bfloat16
        self.device = _state_device(state)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self._stream = None         # the card stream the service runs on
        self._note_stream()
        self.strategy = get_strategy(strategy)
        if server_momentum > 0.0 and self.strategy.rank_contract != "fixed":
            raise ValueError(
                f"server momentum needs a fixed-rank strategy; "
                f"{self.strategy.name!r} declares "
                f"rank_contract={self.strategy.rank_contract!r} (the live "
                "rank -- and the momentum buffer's meaning -- would change "
                "round to round)")
        self.server_momentum = float(server_momentum)
        self.state = state
        self.backend = backend
        self.staleness_clock = staleness_clock
        self.staleness_fn = make_staleness_fn(
            staleness, a=staleness_a, b=staleness_b)
        self.buffer = UpdateBuffer(size=buffer_size, deadline=deadline)
        self.dedup = DedupWindow(dedup_window)
        self.replay_window = int(replay_window)
        self.on_publish = on_publish
        self.publish_every = int(publish_every)
        self.n_published = 0
        self._anchor = state
        self._replay: list[tuple[ClientUpdate, float]] = []
        self._fold_state: FoldState = self.strategy.init_fold(state)
        # service counters (the benchmark / simulator read these)
        self.n_received = 0
        self.n_folded = 0
        self.n_flushes = 0
        self.n_dropped = 0          # zero-mass flushes discarded whole
        self.staleness_sum = 0.0
        self.wire_bytes_received = 0   # post-codec upload bytes accepted
        # observability: cache the instrument handles once (hot path is
        # one enabled check + one add per event); pass ``registry=`` for
        # per-service isolation, default is the process registry
        reg = registry if registry is not None else get_registry()
        self.obs_registry = reg
        self._m_received = reg.counter(
            "fl_updates_received_total", "accepted client updates")
        self._m_rejected = reg.counter(
            "fl_updates_rejected_total",
            "rejected client updates, by reason", labelnames=("reason",))
        self._m_codec = reg.counter(
            "fl_uploads_by_codec_total",
            "accepted uploads, by wire codec", labelnames=("codec",))
        self._m_wire = reg.counter(
            "fl_wire_bytes_received_total",
            "post-codec upload bytes accepted")
        self._m_staleness = reg.histogram(
            "fl_staleness", "staleness of accepted updates "
            "(server versions or wall units, per staleness_clock)",
            buckets=STALENESS_BUCKETS)
        self._m_flushes = reg.counter(
            "fl_flushes_total", "buffer flushes that advanced the state")
        self._m_folds = reg.counter(
            "fl_folds_total", "client updates folded into the state")
        self._m_publishes = reg.counter(
            "fl_publishes_total", "states handed to the publish hook")
        self._m_buffer_depth = reg.gauge(
            "fl_buffer_depth", "updates currently buffered")
        self._quantize_live()          # bf16 storage from the first fold on

    # ------------------------------------------------------------- intake --
    @property
    def version(self) -> int:
        """Server model version = rounds folded into the live state."""
        return int(self.state.round)

    def staleness_weight(self, staleness: float) -> float:
        s = self.staleness_fn(max(float(staleness), 0.0))
        if not 0.0 < s <= 1.0:
            raise ValueError(
                f"staleness schedule returned {s} for tau={staleness}; "
                "schedules must map into (0, 1]")
        return s

    def _reject(self, reason: str, n: int = 1) -> None:
        """Count one rejection under its reason (the per-reason split of
        the legacy lone ``n_dropped``)."""
        self._m_rejected.labels(reason=reason).inc(n)

    def _validate_update(self, update: ClientUpdate) -> set:
        """Ingestion front door: reject malformed uploads before they can
        poison the buffer (the robust strategies bound what *well-formed*
        adversarial values can do; NaN/inf and zero/negative masses are
        rejected outright -- a NaN survives any mean, trimmed or not).

        Every raise increments ``fl_updates_rejected_total`` under
        exactly one reason.  Returns the set of wire codecs the upload
        used (for the codec-mix counters)."""
        with trace_span("fl.validate"):
            n = float(update.n_examples)
            if not (math.isfinite(n) and n > 0.0):
                self._reject("bad_mass")
                raise ValueError(
                    "rejected client update: n_examples must be positive "
                    f"and finite, got {update.n_examples!r}")
            used = set()
            for path, p in _iter_adapter_pairs(update.adapters):
                used.add(codec_of_pair(p))
                # structural integrity: a truncated/garbled upload (lost
                # frames, a proxy cutting the payload short) must be
                # rejected here, not crash a fused kernel three layers down
                a, b = p["A"], p["B"]
                if (a.ndim < 2 or b.ndim < 2
                        or a.shape[-2] != b.shape[-1]):
                    self._reject("malformed")
                    name = "/".join(str(s) for s in path) or "<root>"
                    raise ValueError(
                        f"rejected client update: truncated or malformed "
                        f"pair {name}: A {tuple(a.shape)} / B "
                        f"{tuple(b.shape)} do not share a rank axis")
            bad = sorted(used - set(self.codecs))
            if bad:
                self._reject("codec_not_allowed")
                raise ValueError(
                    f"rejected client update: upload codec {bad} not in "
                    f"the negotiated set {list(self.codecs)}")
            # scale sanity first: a NaN scale should name the scale, not
            # fall through to the generic non-finite message below
            try:
                validate_encoded_adapters(update.adapters)
            except UploadValidationError as e:
                self._reject(e.reason)      # "bad_scale" | "overflow"
                raise
            for name, tree in (("adapters", update.adapters),
                               ("base_trainable", update.base_trainable)):
                for x in tree_leaves(tree):
                    # one bool read back to the host per float leaf
                    if (x.is_floating_point() and not read_back(
                            "validate", bool, torch.isfinite(x).all())):
                        self._reject("nan_tensor")
                        raise ValueError(
                            "rejected client update: non-finite values in "
                            f"{name}")
            return used

    def submit(self, update: ClientUpdate, model_version: int | None = None,
               now: float = 0.0, pulled_at: float | None = None,
               update_id: str | None = None) -> bool:
        """Receive one client update; fold or buffer it.

        Staleness follows :attr:`staleness_clock`: on ``"version"`` it is
        ``version - model_version`` (the server version the client pulled
        before training; ``None`` = fresh), on ``"wall"`` it is ``now -
        pulled_at`` (the service clock when the client pulled; ``None`` =
        fresh; negative skew -- a pull timestamp ahead of the server
        clock -- clamps to 0 rather than *inflating* the weight).  ``now``
        is the service clock (any monotone unit), also used for deadline
        flushes.  Malformed updates (non-positive / non-finite
        ``n_examples``, NaN/inf tensors, truncated pairs) raise
        ``ValueError`` and leave the service untouched.

        ``update_id`` makes ingestion **idempotent** under at-least-once
        delivery: a client-supplied id already inside the
        :class:`~repro_torch.fl.comm.DedupWindow` is dropped (counted under
        rejection reason ``"duplicate"``, returns False) so a network
        retry or a WAL replay can never fold the same upload twice.  Ids
        are remembered only for *accepted* uploads -- a retry of a
        previously rejected payload gets a fresh chance.  Returns True
        when the state advanced.
        """
        if update_id is not None and update_id in self.dedup:
            self._reject("duplicate")
            return False
        self._note_stream()
        with span("submit", registry=self.obs_registry):
            used = self._validate_update(update)
            if update_id is not None:
                self.dedup.add(update_id)
            if self.staleness_clock == "wall":
                tau = (0.0 if pulled_at is None
                       else max(0.0, float(now) - float(pulled_at)))
            else:
                tau = (0.0 if model_version is None
                       else max(0.0, float(self.version - model_version)))
            weight = self.staleness_weight(tau) * float(update.n_examples)
            self.n_received += 1
            self.staleness_sum += tau
            wire = (tree_bytes(update.adapters)
                    + tree_bytes(update.base_trainable))
            self.wire_bytes_received += wire
            self._m_received.inc()
            self._m_staleness.observe(tau)
            self._m_wire.inc(wire)
            for c in (used or {"none"}):
                self._m_codec.labels(codec=c).inc()
            self.buffer.add(update, weight=weight, staleness=tau, now=now,
                            wire_bytes=wire)
            self._m_buffer_depth.set(len(self.buffer))
            due = self.buffer.due(now)
        if due:
            self.flush(now=now)
            return True
        return False

    def maybe_flush(self, now: float) -> bool:
        """Deadline check for the event loop: flush if the oldest buffered
        update has waited past the deadline."""
        if len(self.buffer) and self.buffer.due(now):
            self.flush(now=now)
            return True
        return False

    def next_deadline(self) -> float | None:
        """When the buffered remainder becomes due (see
        :meth:`UpdateBuffer.next_deadline`); drive :meth:`maybe_flush`
        at this time if no upload arrives first."""
        return self.buffer.next_deadline()

    # -------------------------------------------------------------- drain --
    def flush(self, now: float = 0.0) -> ServerState:
        """Aggregate everything buffered into the live state; push the
        advanced state through the serving publish hook (if wired).

        A batch whose total mass is zero (staleness discounts can
        underflow any positive ``n_examples`` to 0) is dropped whole and
        the state does not advance: there is no convex combination to
        take, and mixing by ``0 / 0`` would publish NaNs.
        """
        if len(self.buffer) and not self.buffer.total_weight() > 0.0:
            dropped = len(self.buffer.pop())
            self.n_dropped += dropped
            self._reject("zero_mass_flush", dropped)
            self._m_buffer_depth.set(0)
            return self.state
        batch = self.buffer.pop()
        if not batch:
            return self.state
        self._note_stream()
        with span("flush", registry=self.obs_registry) as sp_flush:
            self.n_flushes += 1
            self._m_flushes.inc()
            # fold arithmetic runs in fp32; bf16 is storage between
            # advances
            self._dequantize_live()
            prev_state = self.state
            if self.buffer.size == 1 and len(batch) == 1:
                with span("fold", registry=self.obs_registry) as sp:
                    self._fold_one(batch[0].update, batch[0].weight)
                    self._apply_momentum(prev_state)
                    sp.block(self.state.adapters)
            else:
                # semi-async mini-cohort: one joint aggregate, staleness
                # already folded into the weights
                with span("fold", registry=self.obs_registry) as sp:
                    self.state = self.strategy.aggregate(
                        self.state, [b.update for b in batch],
                        weights=[b.weight for b in batch],
                        backend=self.backend, device=self.device)
                    self.n_folded += len(batch)
                    self._m_folds.inc(len(batch))
                    self._apply_momentum(prev_state)
                    sp.block(self.state.adapters)
                # a flush is a macro-round boundary: re-anchor the
                # per-update machinery at the new (published) state; the
                # momentum buffer is cross-round server state and
                # survives the re-anchor
                self._anchor = self.state
                self._replay.clear()
                momentum = self._fold_state.momentum
                self._fold_state = self.strategy.init_fold(self.state)
                self._fold_state.momentum = momentum
            self._quantize_live()
            self._m_buffer_depth.set(len(self.buffer))
            sp_flush.block(self.state.adapters)
        self._maybe_publish()
        return self.state

    def _apply_momentum(self, prev_state: ServerState) -> None:
        """Publish ``s_old + m`` with ``m <- beta*m + (s_new - s_old)``
        over the adapters' float leaves (rank leaves pass through)."""
        beta = self.server_momentum
        if beta <= 0.0 or prev_state.adapters is None:
            return
        old, new = prev_state.adapters, self.state.adapters
        m = self._fold_state.momentum
        if m is None:
            m = tree_map(lambda x: torch.zeros_like(x)
                         if x.is_floating_point() else x, old)
        m = tree_map(lambda mv, o, c: beta * mv + (c - o)
                     if c.is_floating_point() else c, m, old, new)
        self._fold_state.momentum = m
        adapters = tree_map(lambda mv, o, c: (o + mv).to(c.dtype)
                            if c.is_floating_point() else c, m, old, new)
        self.state = dataclasses.replace(self.state, adapters=adapters)

    def _maybe_publish(self) -> None:
        """Hot-swap hook: every ``publish_every``-th advance hands the
        live state to ``on_publish``."""
        if self.on_publish is None:
            return
        if self.n_flushes % self.publish_every == 0:
            with span("publish", registry=self.obs_registry):
                self.on_publish(self.state)
            self.n_published += 1
            self._m_publishes.inc()

    def _fold_one(self, update: ClientUpdate, weight: float) -> None:
        # the incremental fold kernels and the replay anchor operate on
        # fp32 trees; the fused-dequant plan path only serves mini-cohort
        # flushes, so decode here (idempotent on plain uploads)
        if tree_codec(update.adapters) != "none":
            update = decode_update(update)
        if self.strategy.supports_incremental:
            # strategies build fresh FoldStates (mass/row_mass are theirs);
            # the momentum buffer is service-level state riding in the same
            # slot, so carry it across the fold
            momentum = self._fold_state.momentum
            self.state, self._fold_state = self.strategy.fold(
                self.state, update, weight, fold_state=self._fold_state,
                backend=self.backend)
            self._fold_state.momentum = momentum
        else:
            # replay: recompute the joint aggregate of every update since
            # the anchor -- exact for any strategy (flora's stacked ranks,
            # svd's truncation, rbla_norm's rescale) at O(window) cost
            if len(self._replay) >= self.replay_window:
                self._anchor = self.state
                self._replay.clear()
            self._replay.append((update, weight))
            out = self.strategy.aggregate(
                self._anchor, [u for u, _ in self._replay],
                weights=[w for _, w in self._replay], backend=self.backend,
                device=self.device)
            self.state = dataclasses.replace(out,
                                             round=self.state.round + 1)
        self.n_folded += 1
        self._m_folds.inc()

    # ------------------------------------------------- bf16 accumulators --
    def _quantize_live(self) -> None:
        """Store the live accumulators (state adapter float leaves + the
        momentum buffer) in bf16 with stochastic rounding, the noise drawn
        from the service generator.  FoldState masses stay fp32: they are
        denominators, and rounding them would bias every later mean."""
        if self.accum_dtype is None:
            return
        if self.state.adapters is not None:
            self.state = dataclasses.replace(
                self.state, adapters=stochastic_round_tree(
                    self.state.adapters, self._generator, self.accum_dtype))
        if self._fold_state.momentum is not None:
            self._fold_state.momentum = stochastic_round_tree(
                self._fold_state.momentum, self._generator, self.accum_dtype)

    def _dequantize_live(self) -> None:
        """Promote bf16-stored accumulators back to fp32 (exact: every
        bf16 value is an fp32 value) before fold arithmetic."""
        if self.accum_dtype is None:
            return

        def up(x):
            return x.float() if x.dtype == torch.bfloat16 else x

        if self.state.adapters is not None:
            self.state = dataclasses.replace(
                self.state, adapters=tree_map(up, self.state.adapters))
        if self._fold_state.momentum is not None:
            self._fold_state.momentum = tree_map(
                up, self._fold_state.momentum)

    # ------------------------------------------------ durable state (WAL) --
    #: service counters captured in (and restored from) a snapshot
    _COUNTERS = ("n_received", "n_folded", "n_flushes", "n_dropped",
                 "n_published", "staleness_sum", "wire_bytes_received")

    def _note_stream(self) -> None:
        """Remember the stream the service runs on (its folds write the
        state there); a snapshot reads the card on it."""
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)

    def state_dict(self) -> dict:
        """Everything a crash-recovery snapshot must carry to resume
        **bit-identically**: the live :class:`ServerState`, the fold
        accumulator (masses, flora's segment ledger, the momentum buffer),
        the replay anchor and window, buffered uploads, the state of the
        stochastic-rounding generator, the idempotency dedup window and
        the service counters.  Plain dict/list/tensor structure, ready for
        :func:`repro_torch.checkpoint.pack_obj`; see
        :mod:`repro_torch.fl.durability`.

        The snapshot is on the host: card tensors are copied on the stream
        the service last ran on (the stream rule,
        :func:`repro_torch.checkpoint.host_copy`), so a fold still queued
        there is read finished whatever stream the caller is on."""

        def st(s: ServerState) -> dict:
            return {"adapters": s.adapters,
                    "base_trainable": s.base_trainable,
                    "round": int(s.round), "r_max": s.r_max,
                    "client_ranks": s.client_ranks,
                    "current_rank": s.current_rank}

        def upd(u: ClientUpdate) -> dict:
            return {"adapters": u.adapters,
                    "base_trainable": u.base_trainable,
                    "n_examples": float(u.n_examples), "rank": u.rank}

        fs = self._fold_state
        return host_copy({
            "format": 1,
            "state": st(self.state),
            "anchor": st(self._anchor),
            "fold": {"mass": float(fs.mass), "row_mass": fs.row_mass,
                     "n_folds": int(fs.n_folds), "extra": fs.extra,
                     "momentum": fs.momentum},
            "replay": [[upd(u), float(w)] for u, w in self._replay],
            "buffer": [{"update": upd(b.update), "weight": b.weight,
                        "staleness": b.staleness, "arrived": b.arrived,
                        "wire_bytes": b.wire_bytes}
                       for b in self.buffer._items],
            "generator": GeneratorState.of(self._generator),
            "dedup": self.dedup.state_dict(),
            "counters": {k: getattr(self, k) for k in self._COUNTERS},
        }, self._stream)

    def load_state_dict(self, sd: dict) -> None:
        """Restore a :meth:`state_dict` snapshot into this service (same
        strategy and configuration as the service that wrote it).  Every
        tensor is placed on the service's device in its own dtype as a new
        tensor -- nothing is written in place, so buffers a serving engine
        may hold stay as they are -- and the generator resumes where the
        snapshot's left off.  A snapshot missing a field raises
        ``KeyError`` before the service changes."""
        if sd["format"] != 1:
            raise ValueError(f"unknown snapshot format {sd['format']!r}")
        dev = self.device

        def on(tree):
            return to_device(tree, dev)

        def st(d: dict) -> ServerState:
            return ServerState(adapters=on(d["adapters"]),
                               base_trainable=on(d["base_trainable"]),
                               round=d["round"], r_max=d["r_max"],
                               client_ranks=on(d["client_ranks"]),
                               current_rank=on(d["current_rank"]))

        def upd(d: dict) -> ClientUpdate:
            return ClientUpdate(adapters=on(d["adapters"]),
                                base_trainable=on(d["base_trainable"]),
                                n_examples=d["n_examples"], rank=d["rank"])

        f = sd["fold"]
        state, anchor = st(sd["state"]), st(sd["anchor"])
        fold_state = FoldState(mass=f["mass"], row_mass=on(f["row_mass"]),
                               n_folds=f["n_folds"], extra=f["extra"],
                               momentum=on(f["momentum"]))
        replay = [(upd(u), w) for u, w in sd["replay"]]
        items = [BufferedUpdate(update=upd(b["update"]), weight=b["weight"],
                                staleness=b["staleness"],
                                arrived=b["arrived"],
                                wire_bytes=b["wire_bytes"])
                 for b in sd["buffer"]]
        dedup, counters = sd["dedup"], sd["counters"]
        missing = [k for k in self._COUNTERS if k not in counters]
        if missing:
            raise KeyError(f"snapshot counters lack {missing}")
        generator = sd["generator"].generator(dev)
        self.state, self._anchor = state, anchor
        self._fold_state = fold_state
        self._replay = replay
        self.buffer._items = items
        self._generator = generator
        self.dedup.load_state_dict(dedup)
        for k in self._COUNTERS:
            setattr(self, k, counters[k])
        self._m_buffer_depth.set(len(self.buffer))
        self._note_stream()

    # ---------------------------------------------------------- reporting --
    def mean_staleness(self) -> float:
        return self.staleness_sum / max(self.n_received, 1)


__all__ = ["AsyncAggregator", "STALENESS_SCHEDULES", "REJECT_REASONS",
           "make_staleness_fn"]
