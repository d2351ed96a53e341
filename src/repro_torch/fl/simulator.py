"""In-process FLaaS simulator: the paper's experiment loop, end to end.

One simulation = (dataset, model, aggregation method, participation) ->
global-model test accuracy, seeded and deterministic on a given device.
Two drivers share one rig:

* :func:`run_simulation` -- synchronous rounds (paper Alg. 1): the
  selected clients re-slice the global adapters to their own rank (Alg.
  2), train locally, and the server aggregates once through the strategy
  registry; then the new global is evaluated.
* :func:`run_async_simulation` -- the event-driven FLaaS mode: each client
  reports on its own clock (log-normal latencies with a straggler tail,
  :class:`~repro_torch.fl.selection.ClientLatencyModel`) and the server
  folds updates as they arrive through an
  :class:`~repro_torch.fl.async_agg.AsyncAggregator`, discounting stale
  ones; with a ``wal_dir`` the server is a
  :class:`~repro_torch.fl.durability.DurableAggregator`, and a
  :class:`~repro_torch.fl.chaos.FaultPlan` injects transport faults and
  crash-restarts.

Both run on ``device="cuda"`` unless the caller asks for the CPU.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.strategy import ClientUpdate, ServerState, get_strategy
from repro_torch.data import make_dataset, staircase_partition
from repro_torch.fl.async_agg import AsyncAggregator
from repro_torch.fl.chaos import FaultPlan
from repro_torch.fl.client import (make_local_fit, merge_base_params,
                                   split_base_params)
from repro_torch.fl.comm import RetryPolicy
from repro_torch.fl.durability import DurableAggregator
from repro_torch.fl.selection import ClientLatencyModel, select_clients
from repro_torch.kernels.runtime import resolve_device
from repro_torch.lora import init_adapters, set_ranks
from repro_torch.models.paper_nets import PAPER_MODELS
from repro_torch.optim import adam, sgd
from repro_torch.tree import tree_map

PyTree = Any


@dataclass
class FLConfig:
    dataset: str = "mnist"
    model: str = "mlp"
    method: str = "rbla"           # any registered strategy: rbla |
                                   # zeropad | fedavg | rbla_ranked |
                                   # rbla_norm | rbla_clipped | rbla_trimmed
                                   # | rbla_median | svd | flora -- or
                                   # "fft" (full fine-tune)
    agg_backend: str = "auto"      # auto | ref | kernel (alias: pallas)
                                   # | distributed
    stack_r_cap: int | None = None  # rank-changing strategies (flora):
                                    # stacked-rank cap / server storage
                                    # rank (None = the strategy default)
    n_clients: int = 10
    rounds: int = 50
    local_epochs: int = 1
    batch_size: int = 64
    lr: float = 0.01
    optimizer: str = "sgd"         # sgd (mnist/fmnist) | adam (cifar/cinic)
    r_max: int = 64
    ratio_step: float = 0.1
    alpha: float = 16.0
    participation: float = 1.0     # 1.0 = full, 0.2 = paper's random 20%
    n_per_class: int = 400
    n_test_per_class: int = 100
    seed: int = 42
    eval_batch: int = 256


@dataclass
class AsyncFLConfig(FLConfig):
    """Event-driven FLaaS simulation.

    ``buffer_size=1`` is fully async (every arrival folds immediately);
    ``buffer_size=K > 1`` and/or ``buffer_deadline_s`` is buffered
    semi-async (flush a mini-cohort on K or deadline).  Latencies are the
    two-level log-normal of :class:`ClientLatencyModel`; staleness is
    measured in server versions or simulated seconds.
    """
    staleness: str = "polynomial"      # constant | polynomial | hinge
    staleness_a: float = 0.5           # decay strength (exponent / slope)
    staleness_b: float = 4.0           # hinge grace period (versions / s)
    staleness_clock: str = "version"   # version (folds behind) | wall
                                       # (simulated seconds since pull)
    buffer_size: int = 1               # semi-async: flush at K updates
    buffer_deadline_s: float | None = None   # ... or on deadline (sim s)
    latency_median_s: float = 1.0      # fleet-median report latency
    latency_sigma: float = 0.25        # per-upload jitter (log-normal)
    straggler_sigma: float = 1.0       # device heterogeneity (log-normal)
    total_updates: int | None = None   # stop after this many uploads
                                       # (None -> rounds * n_clients)
    eval_every: int | None = None      # eval cadence in uploads
                                       # (None -> n_clients)
    # -- durability: a wal_dir makes the server a DurableAggregator
    # (journal + periodic checkpoints); crash-restart faults require it.
    # fsync is off in simulation: the fault model is process crashes, and
    # the event loop is hot.
    wal_dir: str | None = None
    checkpoint_every: int = 64         # accepted uploads per snapshot
    dedup_window: int = 1024           # update_id memory (idempotency)
    retry_base_s: float = 0.5          # client re-upload backoff (see
    retry_max: int = 4                 # repro_torch.fl.comm.RetryPolicy)
    # the service's accumulators: None (fp32) or "bfloat16", stochastically
    # rounded from the service's generator; clients pull them in fp32
    accum_dtype: str | None = None


@dataclass
class FLHistory:
    test_acc: list[float] = field(default_factory=list)
    train_loss: list[float] = field(default_factory=list)
    round_time_s: list[float] = field(default_factory=list)
    # async-mode extras (empty for sync runs): simulated service clock at
    # each eval point, and the mean staleness of the interval's uploads
    sim_time_s: list[float] = field(default_factory=list)
    mean_staleness: list[float] = field(default_factory=list)

    def rounds_to_target(self, target: float) -> int | None:
        for i, a in enumerate(self.test_acc):
            if a >= target:
                return i + 1
        return None


def _build_sim(cfg: FLConfig, device: torch.device, params=None,
               adapters=None) -> SimpleNamespace:
    """Strategy, data, model, server state, the local fit and the eval
    closure.  ``params``/``adapters`` replace the seeded initial model
    (already in the port's format, on ``device``)."""
    strategy = get_strategy(cfg.method)     # a typo fails before any setup
    if cfg.stack_r_cap is not None:
        # a configured copy: registered instances are shared singletons,
        # and a strategy without the knob refuses it here
        strategy = strategy.with_options(stack_r_cap=cfg.stack_r_cap)
    model = (PAPER_MODELS[cfg.model]() if cfg.model != "cnn_cifar" else
             PAPER_MODELS[cfg.model](n_dense=2 if cfg.dataset == "cifar"
                                     else 4))
    train = make_dataset(cfg.dataset, cfg.n_per_class, cfg.seed, "train")
    test = make_dataset(cfg.dataset, cfg.n_test_per_class, cfg.seed, "test")
    clients = staircase_partition(train, cfg.n_clients, cfg.r_max,
                                  cfg.ratio_step, cfg.seed)

    # the seeded initial model is drawn on the CPU and moved, so a run
    # starts from the same weights on every device; a caller's adapters are
    # copied, as the synchronous rounds donate the global's storage
    gen = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        params = tree_map(lambda t: t.to(device), model.init(gen))
    if adapters is not None:
        adapters = tree_map(torch.clone, adapters)
    mode = "fft" if cfg.method == "fft" else "lora"
    if mode == "lora":
        frozen_base, base_trainable = split_base_params(params,
                                                        model.lora_specs)
        if adapters is None:
            # rank-growing strategies (flora) keep the global at a larger
            # storage rank (the stack cap); it starts at live rank r_max
            r_storage = strategy.server_storage_rank(cfg.r_max) or cfg.r_max
            adapters = tree_map(lambda t: t.to(device), init_adapters(
                gen, model.lora_specs, r_storage, cfg.r_max))
    else:                       # FFT trains every parameter
        frozen_base, base_trainable, adapters = {}, params, None
    state = ServerState(adapters=adapters, base_trainable=base_trainable,
                        round=0, r_max=cfg.r_max)

    opt = sgd(cfg.lr) if cfg.optimizer == "sgd" else adam(cfg.lr)
    max_n = max(len(c.x) for c in clients)
    steps = max(1, (max_n * cfg.local_epochs) // cfg.batch_size)
    local_fit = make_local_fit(model, opt, cfg.batch_size, steps, mode,
                               cfg.alpha, device=device)

    client_x = [torch.as_tensor(c.x, device=device) for c in clients]
    client_y = [torch.as_tensor(c.y, device=device).long() for c in clients]
    test_x = torch.as_tensor(test.x, device=device)
    test_y = torch.as_tensor(test.y, device=device).long()

    @torch.no_grad()
    def evaluate(base_trainable, adapters):
        p = merge_base_params(frozen_base, base_trainable)
        correct = 0
        for i in range(0, len(test_x), cfg.eval_batch):
            logits = model.apply(p, adapters if mode == "lora" else None,
                                 test_x[i:i + cfg.eval_batch], train=False)
            correct += int((logits.argmax(-1)
                            == test_y[i:i + cfg.eval_batch]).sum())
        return correct / len(test_x)

    return SimpleNamespace(strategy=strategy, model=model, mode=mode,
                           clients=clients, frozen_base=frozen_base,
                           state=state, local_fit=local_fit,
                           client_x=client_x, client_y=client_y,
                           evaluate=evaluate)


def run_simulation(cfg: FLConfig, verbose: bool = False, *, device="cuda",
                   params=None, adapters=None,
                   batch_indices: Callable[[int, int], torch.Tensor]
                   | None = None) -> FLHistory:
    """Synchronous rounds (paper Alg. 1) on ``device``; each round's
    aggregation is donated the previous global's storage, as the JAX
    simulator's is.

    ``params``/``adapters``: initial model in the port's format (see
    ``repro_torch.bridge``); ``batch_indices(round, client)``: the
    (steps, batch) index tensor a client trains on, in place of the one it
    would draw.  Client seeds come from ``np.random.default_rng(cfg.seed)``
    in the JAX package's order either way."""
    device = resolve_device(device)
    rig = _build_sim(cfg, device, params, adapters)
    strategy, clients, state = rig.strategy, rig.clients, rig.state

    hist = FLHistory()
    rng = np.random.default_rng(cfg.seed)
    for rnd in range(cfg.rounds):
        t0 = time.time()
        part = select_clients(cfg.n_clients, rnd, cfg.participation,
                              cfg.seed)
        updates, losses = [], []
        for ci in part:
            c = clients[ci]
            # CPU generator: the batch indices are the same on every device
            gen = torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31)))
            # re-cut from the (possibly rank-grown) global to the client's
            # rank at r_max storage; set_ranks copies, so a client never
            # aliases the server's storage
            local_ad = (set_ranks(state.adapters, c.rank, r_storage=cfg.r_max)
                        if rig.mode == "lora" else None)
            idx = batch_indices(rnd, ci) if batch_indices is not None else None
            res = rig.local_fit(rig.frozen_base, state.base_trainable,
                                local_ad, rig.client_x[ci], rig.client_y[ci],
                                c.n, gen=gen, batch_idx=idx)
            updates.append(ClientUpdate(
                adapters=res.adapters if rig.mode == "lora" else None,
                base_trainable=res.base_trainable,
                n_examples=float(max(c.n, 1)), rank=c.rank))
            losses.append(float(res.loss))
        # donate the old global's storage to the round: the loop reads
        # only the returned state (clients re-slice from the new global,
        # eval runs on it), so the server holds one copy of the adapters
        state = strategy.aggregate(state, updates, backend=cfg.agg_backend,
                                   device=device, donate=True)
        acc = rig.evaluate(state.base_trainable, state.adapters)
        hist.test_acc.append(acc)
        hist.train_loss.append(float(np.mean(losses)))
        hist.round_time_s.append(time.time() - t0)
        if verbose:
            print(f"[{cfg.method:>11s}] round {rnd + 1:3d} "
                  f"acc={acc:.4f} loss={hist.train_loss[-1]:.4f}")
    return hist


def run_async_simulation(cfg: AsyncFLConfig, verbose: bool = False,
                         fault_plan: FaultPlan | None = None, *,
                         device="cuda", params=None, adapters=None,
                         batch_indices: Callable[[int, int], torch.Tensor]
                         | None = None) -> FLHistory:
    """Event-driven FLaaS loop on ``device``: clients report on their own
    clocks.

    Each client perpetually pulls the global, fits locally and uploads;
    the upload lands ``latency`` simulated seconds after dispatch and is
    folded (or buffered) by an :class:`AsyncAggregator` with its staleness
    discount.  Stops after ``total_updates`` uploads; evaluates every
    ``eval_every`` uploads, logging the simulated clock and the interval's
    mean staleness beside accuracy.

    With ``cfg.wal_dir`` set the server is a :class:`DurableAggregator`
    (journal + periodic checkpoints); every upload carries a client
    ``update_id``, so redeliveries fold exactly once.  ``fault_plan``
    injects the :mod:`repro_torch.fl.chaos` fault set: dropped uploads are
    retried under the config's :class:`RetryPolicy` with the same id,
    duplicates, corruption and truncation bounce off the dedup window and
    the ingestion front door, stale pulls train on obsolete globals, and
    ``crash_at`` points tear the server down mid-stream and recover it from
    its checkpoint and WAL -- the run completes either way.

    ``params``/``adapters``: initial model in the port's format;
    ``batch_indices(k, client)``: the (steps, batch) index tensor of the
    ``k``-th local fit (0-based, in arrival order; a retransmission does
    not train again), in place of the one the client would draw.  Client
    seeds come from ``np.random.default_rng(cfg.seed)``, one per fit, in
    the JAX package's order either way."""
    plan = fault_plan
    if plan is not None and plan.crash_at and cfg.wal_dir is None:
        raise ValueError(
            "FaultPlan.crash_at needs cfg.wal_dir: crash-restart recovery "
            "only exists for a DurableAggregator")
    device = resolve_device(device)
    rig = _build_sim(cfg, device, params, adapters)
    clients = rig.clients
    agg_kw = dict(
        staleness=cfg.staleness, staleness_a=cfg.staleness_a,
        staleness_b=cfg.staleness_b, staleness_clock=cfg.staleness_clock,
        buffer_size=cfg.buffer_size, deadline=cfg.buffer_deadline_s,
        backend=cfg.agg_backend, dedup_window=cfg.dedup_window,
        accum_dtype=cfg.accum_dtype)

    def make_agg():
        if cfg.wal_dir is not None:
            return DurableAggregator(
                rig.strategy, rig.state, dir=cfg.wal_dir,
                checkpoint_every=cfg.checkpoint_every, wal_fsync=False,
                **agg_kw)
        return AsyncAggregator(rig.strategy, rig.state, **agg_kw)

    def pull(tree):
        # clients train on fp32 whatever the service stores
        if cfg.accum_dtype is None:
            return tree
        return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                        else t, tree)

    agg = make_agg()
    retry = RetryPolicy(base=cfg.retry_base_s, max_retries=cfg.retry_max,
                        seed=cfg.seed)
    latency = ClientLatencyModel(
        cfg.n_clients, median_s=cfg.latency_median_s,
        sigma=cfg.latency_sigma, straggler_sigma=cfg.straggler_sigma,
        seed=cfg.seed)

    total = cfg.total_updates or cfg.rounds * cfg.n_clients
    eval_every = cfg.eval_every or cfg.n_clients
    rng = np.random.default_rng(cfg.seed)
    # (done_time, tiebreak, client, version, pull_time, payload, uid,
    #  attempt) -- payload is the pulled snapshot on attempt 0 and the
    # already-trained ClientUpdate on retries (the client retransmits the
    # same upload, it does not retrain)
    heap: list = []
    seq = 0
    n_uploads = 0                  # upload ids handed out (-> update_id)
    n_fits = 0                     # local fits so far (-> batch_indices)
    past: list = []                # recent pulls for stale_pull faults
    crashed: set[int] = set()

    def dispatch(ci: int, now: float) -> None:
        nonlocal seq, n_uploads
        # the client trains on the global it pulls NOW; by the time its
        # update lands the server may have moved on -- that gap is the
        # staleness the aggregator discounts.  set_ranks copies, and no
        # fold writes into the state's tensors, so the snapshot holds.
        uid = n_uploads
        n_uploads += 1
        version = agg.version
        ad, base = agg.state.adapters, agg.state.base_trainable
        if plan is not None:
            past.append((version, ad, base))
            del past[:-8]
            if plan.stale_pull(uid):
                version, ad, base = past[0]     # oldest retained pull
        local_ad = None
        if rig.mode == "lora":
            local_ad = set_ranks(pull(ad), clients[ci].rank,
                                 r_storage=cfg.r_max)
        delay = latency.sample(ci)
        if plan is not None and plan.reorder(uid):
            delay += plan.reorder_delay_s
        heapq.heappush(heap, (now + delay, seq, ci, version, now,
                              (local_ad, base), uid, 0))
        seq += 1

    def deliver(upd, version, now, pulled_at, uid) -> None:
        """One delivery attempt through the ingestion front door; a
        rejection (poisoned tensors, truncated pairs, duplicate id) is
        counted by the aggregator and otherwise final."""
        try:
            agg.submit(upd, model_version=version, now=now,
                       pulled_at=pulled_at, update_id=f"u{uid}")
        except ValueError:
            pass

    for ci in range(cfg.n_clients):
        dispatch(ci, 0.0)

    hist = FLHistory()
    losses: list[float] = []
    stale_mark = 0.0
    eval_mark = 0                  # uploads already covered by an eval
    received = 0
    t_wall = time.time()
    while received < total:
        (now, _, ci, version, pulled_at, payload, uid,
         attempt) = heapq.heappop(heap)
        # a buffered deadline may fall before this arrival: honour it at
        # its own simulated time
        due_t = agg.next_deadline()
        if due_t is not None and due_t < now:
            agg.maybe_flush(now=due_t)
        if attempt == 0:
            local_ad, base_snap = payload
            c = clients[ci]
            # CPU generator: the batch indices are the same on every device
            gen = torch.Generator().manual_seed(
                int(rng.integers(0, 2 ** 31)))
            idx = (batch_indices(n_fits, ci) if batch_indices is not None
                   else None)
            n_fits += 1
            res = rig.local_fit(rig.frozen_base, base_snap, local_ad,
                                rig.client_x[ci], rig.client_y[ci], c.n,
                                gen=gen, batch_idx=idx)
            losses.append(float(res.loss))
            upd = ClientUpdate(
                adapters=res.adapters if rig.mode == "lora" else None,
                base_trainable=res.base_trainable,
                n_examples=float(max(c.n, 1)), rank=c.rank)
            if plan is not None:
                if plan.corrupt(uid):
                    upd = plan.corrupt_update(upd)
                elif plan.truncate(uid):
                    upd = plan.truncate_update(upd)
        else:
            upd = payload           # retransmission of the same upload
        if plan is not None and plan.drop(uid, attempt):
            if not retry.give_up(attempt):
                # lost in transit: the client re-uploads the SAME update
                # (same id) after a jittered backoff
                heapq.heappush(heap, (now + retry.delay(attempt, salt=uid),
                                      seq, ci, version, pulled_at, upd,
                                      uid, attempt + 1))
                seq += 1
                continue            # nothing reached the server yet
            # retries exhausted: the upload is lost for good; the client
            # moves on to its next round (counts toward total so chaos
            # runs still terminate)
        else:
            deliver(upd, version, now, pulled_at, uid)
            if plan is not None and plan.duplicate(uid):
                # transport redelivery: the dedup window must fold it
                # exactly once (rejected as "duplicate")
                deliver(upd, version, now, pulled_at, uid)
        received += 1
        dispatch(ci, now)
        if (plan is not None and cfg.wal_dir is not None
                and plan.crash_now(received) and received not in crashed):
            # server crash-restart: drop the in-memory aggregator and
            # recover from checkpoint + WAL.  In-flight client uploads
            # (the heap) survive -- clients are other machines.
            crashed.add(received)
            agg.close()
            agg = make_agg()

        if received % eval_every == 0 or received == total:
            if received == total:
                agg.flush(now=now)      # drain any semi-async remainder
            acc = rig.evaluate(agg.state.base_trainable, agg.state.adapters)
            interval = received - eval_mark   # the final one may be short
            hist.test_acc.append(acc)
            hist.train_loss.append(float(np.mean(losses[eval_mark:])))
            hist.round_time_s.append(time.time() - t_wall)
            hist.sim_time_s.append(now)
            hist.mean_staleness.append(
                (agg.staleness_sum - stale_mark) / max(interval, 1))
            stale_mark = agg.staleness_sum
            eval_mark = received
            t_wall = time.time()
            if verbose:
                print(f"[{cfg.method:>11s}/async] upload {received:4d} "
                      f"t={now:8.1f}s acc={acc:.4f} "
                      f"stale={hist.mean_staleness[-1]:.2f}")
    return hist
