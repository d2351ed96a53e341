"""In-process FLaaS simulator: the paper's synchronous experiment loop.

One simulation = (dataset, model, aggregation method, participation) ->
per-round global-model test accuracy, seeded and deterministic on a given
device.  Each round: the selected clients re-slice the global adapters to
their own rank (Alg. 2), train locally, and the server aggregates once
(Alg. 1) through the strategy registry; then the new global is evaluated.
The event-driven ``run_async_simulation`` waits for the async slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.strategy import ClientUpdate, ServerState, get_strategy
from repro_torch.data import make_dataset, staircase_partition
from repro_torch.fl.client import (make_local_fit, merge_base_params,
                                   split_base_params)
from repro_torch.fl.selection import select_clients
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
class FLHistory:
    test_acc: list[float] = field(default_factory=list)
    train_loss: list[float] = field(default_factory=list)
    round_time_s: list[float] = field(default_factory=list)

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
