"""One client ``local_fit`` of the port against the JAX package's on the
same parameters and the same batch indices.  The JAX side draws its index
stream exactly as ``repro.fl.client`` does (``idx_key, _ =
jax.random.split(key)``; ``sample_batch_indices(idx_key, n, batch,
steps)``) and the port is handed that stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_trees_close, port_tree

from repro.data.pipeline import sample_batch_indices as j_sample
from repro.fl import client as jc
from repro.models import paper_nets as jn
from repro import optim as jo
from repro_torch import optim as to
from repro_torch.fl import client as tc
from repro_torch.models import paper_nets as tn

TOL = 1e-4
DIMS = dict(input_dim=48, hidden=16, n_classes=5)
R_MAX, RANK, BATCH, STEPS = 8, 3, 8, 6


def _setup(seed):
    rng = np.random.default_rng(seed)
    params = {k: {"w": (rng.normal(size=(fo, fi)) * 0.3).astype(np.float32),
                  "b": (rng.normal(size=(fo,)) * 0.1).astype(np.float32)}
              for k, (fo, fi) in jn.mlp(**DIMS).lora_specs.items()}
    adapters = {}
    for k, (fo, fi) in jn.mlp(**DIMS).lora_specs.items():
        a = (rng.normal(size=(R_MAX, fi)) * 0.1).astype(np.float32)
        b = (rng.normal(size=(fo, R_MAX)) * 0.1).astype(np.float32)
        a[RANK:] = 0.0
        b[:, RANK:] = 0.0
        adapters[k] = {"A": a, "B": b, "rank": np.int32(RANK)}
    x = rng.normal(size=(40, 48)).astype(np.float32)
    y = rng.integers(0, 5, 40).astype(np.int32)
    return params, adapters, x, y


@pytest.mark.parametrize("opt,mode", [("sgd", "lora"), ("adam", "lora"),
                                      ("sgd", "fft")])
def test_local_fit_matches_reference(opt, mode):
    params, adapters, x, y = _setup(0)
    n_true = 33
    jmodel, tmodel = jn.mlp(**DIMS), tn.mlp(**DIMS)
    make = {"sgd": lambda m: m.sgd(0.05), "adam": lambda m: m.adam(1e-2)}[opt]
    key = jax.random.PRNGKey(7)
    idx_key, _ = jax.random.split(key)
    idx = np.array(j_sample(idx_key, jnp.int32(n_true), BATCH, STEPS))

    if mode == "lora":
        jfrozen, jtrain = jc.split_base_params(params, jmodel.lora_specs)
        jad = adapters
    else:
        jfrozen, jtrain, jad = {}, params, None
    jfit = jc.make_local_fit(jmodel, make(jo), BATCH, STEPS, mode)
    jres = jfit(jax.tree.map(jnp.asarray, jfrozen),
                jax.tree.map(jnp.asarray, jtrain),
                None if jad is None else jax.tree.map(jnp.asarray, jad),
                jnp.asarray(x), jnp.asarray(y), jnp.int32(n_true), key)

    tfit = tc.make_local_fit(tmodel, make(to), BATCH, STEPS, mode,
                             device="cpu")
    tres = tfit(port_tree(jfrozen), port_tree(jtrain),
                None if jad is None else port_tree(jad),
                torch.as_tensor(x), torch.as_tensor(y), n_true,
                batch_idx=torch.as_tensor(idx))
    assert_close(tres.loss, jres.loss, TOL)
    assert_trees_close(tres.base_trainable, jres.base_trainable, TOL)
    if mode == "lora":
        assert_trees_close(tres.adapters, jres.adapters, TOL)
        # padded rows stay exactly zero after every re-mask
        for pair in tres.adapters.values():
            assert not pair["A"][RANK:].any() and not pair["B"][:, RANK:].any()


def test_split_merge_and_xent():
    params, _, _, _ = _setup(1)
    specs = tn.mlp(**DIMS).lora_specs
    frozen, train = tc.split_base_params(port_tree(params), specs)
    assert set(frozen["fc1"]) == {"w"} and set(train["fc1"]) == {"b"}
    merged = tc.merge_base_params(frozen, train)
    assert all(set(merged[k]) == {"w", "b"} for k in specs)
    logits = np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32)
    labels = np.array([0, 4, 2, 1, 3, 3], np.int32)
    assert_close(tc.softmax_xent(torch.as_tensor(logits),
                                 torch.as_tensor(labels)),
                 jc.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))


def test_local_fit_draws_from_generator_and_checks_inputs():
    params, adapters, x, y = _setup(2)
    tmodel = tn.mlp(**DIMS)
    frozen, train = tc.split_base_params(port_tree(params), tmodel.lora_specs)
    fit = tc.make_local_fit(tmodel, to.sgd(0.05), BATCH, STEPS,
                            device="cpu")
    run = [fit(frozen, train, port_tree(adapters), torch.as_tensor(x),
               torch.as_tensor(y), 30, gen=torch.Generator().manual_seed(4))
           for _ in range(2)]
    assert torch.equal(run[0].loss, run[1].loss)
    with pytest.raises(ValueError, match="generator or batch_idx"):
        fit(frozen, train, port_tree(adapters), torch.as_tensor(x),
            torch.as_tensor(y), 30)
    with pytest.raises(ValueError, match="batch_idx"):
        fit(frozen, train, port_tree(adapters), torch.as_tensor(x),
            torch.as_tensor(y), 30, batch_idx=torch.zeros(2, 2))
