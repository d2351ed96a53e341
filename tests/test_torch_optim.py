"""The port's optimizers step by step against the JAX package's exact
formulas (SGD with momentum and Nesterov, Adam, AdamW, a schedule)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_trees_close, port_tree

from repro import optim as jo
from repro_torch import optim as to

CASES = {
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd_momentum": (lambda m: m.sgd(0.1, momentum=0.9)),
    "sgd_nesterov": (lambda m: m.sgd(0.1, momentum=0.9, nesterov=True)),
    "adam": (lambda m: m.adam(1e-2)),
    "adamw": (lambda m: m.adamw(1e-2, weight_decay=0.1)),
    "adam_cosine": (lambda m: m.adam(m.cosine(1e-2, 10, warmup=2))),
    "sgd_exponential": (lambda m: m.sgd(m.exponential(0.1, 0.5, 2))),
}


def _tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": {"v": rng.normal(size=(3,)).astype(np.float32)}}


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match(case):
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(jnp.asarray, _tree(rng))
    tparams = port_tree(jparams)
    jopt, topt = CASES[case](jo), CASES[case](to)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(5):
        grads = _tree(rng)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jparams)
        tu, tstate = topt.update(port_tree(grads), tstate, tparams)
        jparams = jo.apply_updates(jparams, ju)
        tparams = to.apply_updates(tparams, tu)
        assert_trees_close(tparams, jparams, msg=case)


def test_schedules_match():
    for c in (0, 1, 3, 9, 20):
        for jsch, tsch in ((jo.cosine(1.0, 10, 3, 0.1), to.cosine(1.0, 10, 3, 0.1)),
                           (jo.exponential(2.0, 0.9, 4),
                            to.exponential(2.0, 0.9, 4)),
                           (jo.constant(0.3), to.constant(0.3))):
            want = float(jsch(jnp.asarray(c, jnp.int32)))
            assert abs(float(tsch(c)) - want) <= 1e-6 * max(1.0, abs(want))


def test_updates_need_no_grad_state():
    p = {"w": torch.ones(2, requires_grad=False)}
    opt = to.sgd(0.5)
    u, s = opt.update({"w": torch.ones(2)}, opt.init(p))
    assert s["mu"] is None and s["count"] == 1
    assert torch.equal(to.apply_updates(p, u)["w"], torch.full((2,), 0.5))
