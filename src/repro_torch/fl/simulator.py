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
  ones.

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
from repro_torch.fl.client import (make_local_fit, merge_base_params,
                                   split_base_params)
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
    dedup_window: int = 1024           # update_id memory (idempotency)
    # the durable service (write-ahead log, checkpoints) is ROADMAP queue
    # 1 item 16; a wal_dir raises until then
    wal_dir: str | None = None


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
    # starts from the same weights on every device
    gen = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        params = tree_map(lambda t: t.to(device), model.init(gen))
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
    """Synchronous rounds (paper Alg. 1) on ``device``.

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
        state = strategy.aggregate(state, updates, backend=cfg.agg_backend,
                                   device=device)
        acc = rig.evaluate(state.base_trainable, state.adapters)
        hist.test_acc.append(acc)
        hist.train_loss.append(float(np.mean(losses)))
        hist.round_time_s.append(time.time() - t0)
        if verbose:
            print(f"[{cfg.method:>11s}] round {rnd + 1:3d} "
                  f"acc={acc:.4f} loss={hist.train_loss[-1]:.4f}")
    return hist


def run_async_simulation(cfg: AsyncFLConfig, verbose: bool = False,
                         fault_plan=None, *, device="cuda", params=None,
                         adapters=None,
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

    ``params``/``adapters``: initial model in the port's format;
    ``batch_indices(k, client)``: the (steps, batch) index tensor of the
    ``k``-th arrival (0-based, in arrival order), in place of the one the
    client would draw.  Client seeds come from
    ``np.random.default_rng(cfg.seed)``, one per arrival, in the JAX
    package's order either way.  ``cfg.wal_dir`` and ``fault_plan`` (the
    durable service and its chaos harness) raise ``NotImplementedError``:
    ROADMAP queue 1 item 16."""
    if cfg.wal_dir is not None or fault_plan is not None:
        raise NotImplementedError(
            "the durable service (wal_dir) and fault plans are not ported "
            "yet; they arrive with ROADMAP queue 1 item 16 "
            "(fl/durability, fl/chaos)")
    device = resolve_device(device)
    rig = _build_sim(cfg, device, params, adapters)
    clients = rig.clients
    agg = AsyncAggregator(
        rig.strategy, rig.state, staleness=cfg.staleness,
        staleness_a=cfg.staleness_a, staleness_b=cfg.staleness_b,
        staleness_clock=cfg.staleness_clock, buffer_size=cfg.buffer_size,
        deadline=cfg.buffer_deadline_s, backend=cfg.agg_backend,
        dedup_window=cfg.dedup_window)
    latency = ClientLatencyModel(
        cfg.n_clients, median_s=cfg.latency_median_s,
        sigma=cfg.latency_sigma, straggler_sigma=cfg.straggler_sigma,
        seed=cfg.seed)

    total = cfg.total_updates or cfg.rounds * cfg.n_clients
    eval_every = cfg.eval_every or cfg.n_clients
    rng = np.random.default_rng(cfg.seed)
    # (done_time, tiebreak, client, version, pull_time, pulled snapshot,
    #  update id); the snapshot is what the client trains on
    heap: list = []
    seq = 0

    def dispatch(ci: int, now: float) -> None:
        nonlocal seq
        # the client trains on the global it pulls NOW; by the time its
        # update lands the server may have moved on -- that gap is the
        # staleness the aggregator discounts.  set_ranks copies, and no
        # fold writes into the state's tensors, so the snapshot holds.
        local_ad = None
        if rig.mode == "lora":
            local_ad = set_ranks(agg.state.adapters, clients[ci].rank,
                                 r_storage=cfg.r_max)
        heapq.heappush(heap, (now + latency.sample(ci), seq, ci, agg.version,
                              now, (local_ad, agg.state.base_trainable), seq))
        seq += 1

    for ci in range(cfg.n_clients):
        dispatch(ci, 0.0)

    hist = FLHistory()
    losses: list[float] = []
    stale_mark = 0.0
    eval_mark = 0                  # uploads already covered by an eval
    received = 0
    t_wall = time.time()
    while received < total:
        now, _, ci, version, pulled_at, (local_ad, base_snap), uid = \
            heapq.heappop(heap)
        # a buffered deadline may fall before this arrival: honour it at
        # its own simulated time
        due_t = agg.next_deadline()
        if due_t is not None and due_t < now:
            agg.maybe_flush(now=due_t)
        c = clients[ci]
        # CPU generator: the batch indices are the same on every device
        gen = torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31)))
        idx = (batch_indices(received, ci) if batch_indices is not None
               else None)
        res = rig.local_fit(rig.frozen_base, base_snap, local_ad,
                            rig.client_x[ci], rig.client_y[ci], c.n,
                            gen=gen, batch_idx=idx)
        losses.append(float(res.loss))
        upd = ClientUpdate(
            adapters=res.adapters if rig.mode == "lora" else None,
            base_trainable=res.base_trainable,
            n_examples=float(max(c.n, 1)), rank=c.rank)
        try:
            agg.submit(upd, model_version=version, now=now,
                       pulled_at=pulled_at, update_id=f"u{uid}")
        except ValueError:
            pass                    # rejected: counted by the aggregator
        received += 1
        dispatch(ci, now)

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
