"""Three synchronous FL rounds of the port against the JAX package's
``repro.fl.run_simulation`` for rbla, zeropad and fedavg.

The port starts from the JAX run's initial model (bridged) and trains on
the JAX run's batch indices (injected), both rebuilt exactly as
``repro.fl.simulator`` and ``repro.fl.client`` make them: ``key, pkey,
akey = jax.random.split(PRNGKey(seed), 3)`` for ``model.init`` /
``init_adapters``; per client per round ``fit_key = PRNGKey(int(
rng.integers(0, 2**31)))`` from ``np.random.default_rng(seed)``, then
``idx_key, _ = jax.random.split(fit_key)`` and ``sample_batch_indices``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_close, port_tree

from repro.core import strategy as js
from repro.data import make_dataset, staircase_partition
from repro.data.pipeline import sample_batch_indices
from repro.fl import FLConfig as JConfig
from repro.fl import run_simulation as j_run
from repro.fl.selection import select_clients
from repro.lora import init_adapters
from repro.models.paper_nets import PAPER_MODELS
from repro_torch.core import strategy as ts
from repro_torch.fl import FLConfig, run_simulation

CFG = dict(dataset="mnist", model="mlp", rounds=3, n_clients=4,
           n_per_class=20, n_test_per_class=10, local_epochs=1,
           batch_size=16, lr=0.01, r_max=8, seed=42)


def _reference_inputs(cfg):
    """The JAX run's initial model and every client's batch indices."""
    model = PAPER_MODELS[cfg.model]()
    _, pkey, akey = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    params = model.init(pkey)
    adapters = init_adapters(akey, model.lora_specs, cfg.r_max, cfg.r_max)
    train = make_dataset(cfg.dataset, cfg.n_per_class, cfg.seed, "train")
    clients = staircase_partition(train, cfg.n_clients, cfg.r_max,
                                  cfg.ratio_step, cfg.seed)
    max_n = max(len(c.x) for c in clients)
    steps = max(1, (max_n * cfg.local_epochs) // cfg.batch_size)
    rng = np.random.default_rng(cfg.seed)
    idx = {}
    for rnd in range(cfg.rounds):
        for ci in select_clients(cfg.n_clients, rnd, cfg.participation,
                                 cfg.seed):
            fit_key = jax.random.PRNGKey(int(rng.integers(0, 2 ** 31)))
            idx_key, _ = jax.random.split(fit_key)
            idx[rnd, ci] = np.array(sample_batch_indices(
                idx_key, jnp.asarray(clients[ci].n, jnp.int32),
                cfg.batch_size, steps))
    return params, adapters, idx


def _final_state(monkeypatch, strategy):
    """Record the server state each aggregate returns."""
    seen = {}
    orig = strategy.aggregate

    def spy(*a, **k):
        seen["state"] = orig(*a, **k)
        return seen["state"]
    monkeypatch.setattr(strategy, "aggregate", spy)
    return seen


@pytest.mark.parametrize("method", ["rbla", "zeropad", "fedavg"])
def test_three_rounds_match_reference(method, monkeypatch):
    jcfg = JConfig(method=method, **CFG)
    params, adapters, idx = _reference_inputs(jcfg)
    jseen = _final_state(monkeypatch, js.get_strategy(method))
    jhist = j_run(jcfg)

    tseen = _final_state(monkeypatch, ts.get_strategy(method))
    thist = run_simulation(
        FLConfig(method=method, **CFG), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda rnd, ci: torch.as_tensor(idx[rnd, ci]))

    assert len(thist.test_acc) == len(jhist.test_acc) == CFG["rounds"]
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    assert np.isfinite(jhist.train_loss).all()
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss,
                               rtol=1e-3)
    assert_trees_close(tseen["state"].adapters, jseen["state"].adapters,
                       tol=1e-3, msg=method)
    assert_trees_close(tseen["state"].base_trainable,
                       jseen["state"].base_trainable, tol=1e-3, msg=method)


def test_seeded_run_is_deterministic_and_learns():
    cfg = FLConfig(method="rbla", **dict(CFG, rounds=4))
    a = run_simulation(cfg, device="cpu")
    b = run_simulation(cfg, device="cpu")
    assert a.test_acc == b.test_acc and a.train_loss == b.train_loss
    assert a.train_loss[-1] < a.train_loss[0]


def test_run_simulation_defaults_to_the_card():
    cfg = FLConfig(rounds=1, n_clients=2, n_per_class=2, n_test_per_class=2)
    if torch.cuda.is_available():
        assert len(run_simulation(cfg).test_acc) == 1
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            run_simulation(cfg)
