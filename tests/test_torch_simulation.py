"""Three synchronous FL rounds of the port against the JAX package's
``repro.fl.run_simulation`` for rbla, zeropad and fedavg.

The port starts from the JAX run's initial model (bridged) and trains on
the JAX run's batch indices (injected), both rebuilt exactly as the JAX
package makes them (``_torch_parity.sim_reference_inputs``).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, port_tree,
                           sim_reference_inputs, spy_states)

from repro.core import strategy as js
from repro.fl import FLConfig as JConfig
from repro.fl import run_simulation as j_run
from repro_torch.core import strategy as ts
from repro_torch.fl import FLConfig, run_simulation

CFG = dict(dataset="mnist", model="mlp", rounds=3, n_clients=4,
           n_per_class=20, n_test_per_class=10, local_epochs=1,
           batch_size=16, lr=0.01, r_max=8, seed=42)


@pytest.mark.parametrize("method", ["rbla", "zeropad", "fedavg"])
def test_three_rounds_match_reference(method, monkeypatch):
    jcfg = JConfig(method=method, **CFG)
    params, adapters, idx = sim_reference_inputs(jcfg)
    jseen = spy_states(monkeypatch, js.AggregationStrategy)
    jhist = j_run(jcfg)

    tseen = spy_states(monkeypatch, ts.AggregationStrategy)
    thist = run_simulation(
        FLConfig(method=method, **CFG), device="cpu",
        params=port_tree(params), adapters=port_tree(adapters),
        batch_indices=lambda rnd, ci: torch.as_tensor(idx[rnd, ci]))

    assert len(thist.test_acc) == len(jhist.test_acc) == CFG["rounds"]
    np.testing.assert_allclose(thist.test_acc, jhist.test_acc, atol=0.01)
    assert np.isfinite(jhist.train_loss).all()
    np.testing.assert_allclose(thist.train_loss, jhist.train_loss,
                               rtol=1e-3)
    assert_trees_close(tseen[-1].adapters, jseen[-1].adapters,
                       tol=1e-3, msg=method)
    assert_trees_close(tseen[-1].base_trainable,
                       jseen[-1].base_trainable, tol=1e-3, msg=method)


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
