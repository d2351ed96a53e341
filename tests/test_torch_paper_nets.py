"""Forward parity of the paper's models (``repro_torch.models.paper_nets``)
on parameters carried over from the JAX package through the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, port_tree

from repro.models import paper_nets as jn
from repro_torch.bridge import to_numpy
from repro_torch.models import paper_nets as tn

MODELS = {
    "mlp": ((jn.mlp, tn.mlp), {}, (4, 28, 28, 1)),
    "cnn_mnist": ((jn.cnn_mnist, tn.cnn_mnist), {}, (3, 28, 28, 1)),
    "cnn_cifar": ((jn.cnn_cifar, tn.cnn_cifar), dict(n_dense=2),
                  (3, 32, 32, 3)),
}


def _random_tree(shapes, seed):
    """numpy leaves of the given shapes (random, so no path is trivial)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes)


def _random_lora(model):
    """Adapters with both factors random and live rank 5 of 8."""
    rng = np.random.default_rng(0)
    return {k: {"A": rng.normal(size=(8, fi)).astype(np.float32) * 0.05,
                "B": rng.normal(size=(fo, 8)).astype(np.float32) * 0.05,
                "rank": np.int32(5)}
            for k, (fo, fi) in model.lora_specs.items()}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("with_lora", [False, True])
def test_forward_parity(name, with_lora):
    (jfn, tfn), kw, shape = MODELS[name]
    jmodel, tmodel = jfn(**kw), tfn(**kw)
    assert jmodel.lora_specs == tmodel.lora_specs
    params = _random_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)),
                          seed=3)
    lora = _random_lora(jmodel) if with_lora else None
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = jax.jit(lambda p, a, v: jmodel.apply(p, a, v, train=False))(
        params, lora, jnp.asarray(x))
    got = tmodel.apply(port_tree(params),
                       port_tree(lora) if with_lora else None,
                       torch.as_tensor(x), train=False)
    assert got.shape == want.shape
    assert_close(got, want)


def test_init_shapes_match_reference():
    for (jfn, tfn), kw, _ in MODELS.values():
        want = jax.tree.map(np.shape, jax.eval_shape(
            jfn(**kw).init, jax.random.PRNGKey(0)))
        got = to_numpy(tfn(**kw).init(torch.Generator().manual_seed(0)))
        assert jax.tree.map(np.shape, got) == want


def test_layer_ops_parity():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    assert_close(tn.maxpool2(torch.as_tensor(x)), jn.maxpool2(jnp.asarray(x)))
    scale = rng.normal(size=(5,)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    assert_close(tn.batch_stat_norm(*map(torch.as_tensor, (x, scale, bias))),
                 jn.batch_stat_norm(*map(jnp.asarray, (x, scale, bias))))
    p = {"w": rng.normal(size=(3, 3, 5, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    assert_close(tn.conv_apply(port_tree(p), torch.as_tensor(x)),
                 jn.conv_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


def test_dropout_keep_rate_and_identity():
    x = torch.ones(200, 100)
    assert tn.dropout(None, x, 0.25, train=False) is x
    y = tn.dropout(torch.Generator().manual_seed(0), x, 0.25, train=True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
