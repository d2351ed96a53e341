"""Activation checkpointing of the zoo's stages (``models/transformer.py``:
``REMAT_POLICIES``, ``stage_forward(remat=)``) against the JAX package's
``jax.checkpoint`` policies, on the CPU at reduced fp32 configs.

* ``Model.loss`` and its gradient w.r.t. every adapter factor, for a dense
  (h2o-danube-3-4b), an MoE (granite-moe-3b-a800m) and a mamba
  (mamba2-1.3b) arch, with ``remat`` in {False, True, "full", "dots"}:
  equal to JAX's ``Model.loss`` under the same ``remat`` and to the port's
  ``remat=False`` within F32_TOL (2e-5 of max|want|);
* "full" saves fewer tensor bytes for the backward than ``False``
  (counted with ``torch.autograd.graph.saved_tensors_hooks``), and the
  backward recomputes the forward (the blocks run twice);
* no checkpoint outside training: with autograd off, or in prefill;
* an unknown policy raises ``KeyError``, as the reference's lookup does;
* ``launch.train.train(remat="full")`` on a (2, 2) mesh of 4 spawned gloo
  ranks (``tests/_dist_child.py``, 120 s a rank): DTensors and the
  ``local_map`` regions (attention, the mamba core, the MoE) under the
  checkpoint; losses and trained adapters equal the one-device run's.

Parameters come from the JAX initialisers through ``repro_torch.bridge``,
tokens are numpy from a seed.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close, port_tree

from repro.configs import get_config as jax_get_config
from repro.lora import attach_ranks as jax_attach_ranks
from repro.lora import strip_ranks as jax_strip_ranks
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models import transformer as tt
from repro_torch.models.model import make_model
from repro_torch.tree import tree_leaves

ARCHS = ("h2o-danube-3-4b", "granite-moe-3b-a800m", "mamba2-1.3b")
POLICIES = (False, True, "full", "dots")
CHILD = Path(__file__).resolve().parent / "_dist_child.py"
CHILD_TIMEOUT = 120            # seconds, each rank of a spawned world
MESH_KW = dict(steps=2, batch=4, seq=16, rank=4, remat="full")


@functools.lru_cache(maxsize=None)
def _rig(arch):
    """JAX params and adapters (a live B at rank 4 of 8) and a batch of
    tokens, for one reduced arch."""
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_make_model(jcfg, remat=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    ja = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(5)

    def live(pair):
        b = np.asarray(pair["B"])
        m = (np.arange(b.shape[-1]) < 4).astype(np.float32)
        return dict(pair, B=jnp.asarray(
            (rng.normal(size=b.shape) * 0.05).astype(np.float32) * m))
    ja = {"stages": tuple({b: {k: live(v) for k, v in unit.items()}
                           for b, unit in st.items()}
                          for st in ja["stages"])}
    tokens = rng.integers(0, jcfg.vocab_size, (2, 17))
    return jcfg, jp, ja, tokens


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(arch, remat):
    jcfg, jp, ja, tokens = _rig(arch)
    jmodel = jax_make_model(jcfg, remat=remat)
    factors, ranks = jax_strip_ranks(ja)

    def loss(f):
        return jmodel.loss(jp, jax_attach_ranks(f, ranks),
                           {"tokens": jnp.asarray(tokens)})
    val, grad = jax.jit(jax.value_and_grad(loss))(factors)
    return np.asarray(val), jax.tree.map(np.asarray, grad)


def _port_loss_and_grad(arch, remat, count_saved=False):
    jcfg, jp, ja, tokens = _rig(arch)
    model = make_model(get_config(arch).reduced(), remat=remat,
                       scan_backend="ref")
    factors, ranks = strip_ranks(port_tree(ja))
    leaves = tree_leaves(factors)
    for t in leaves:
        t.requires_grad_(True)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.loss(port_tree(jp), attach_ranks(factors, ranks),
                          {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), factors, grads, saved[0]


def _grads_close(factors, grads, want, msg):
    got = iter(grads)
    by_leaf = {id(t): next(got) for t in tree_leaves(factors)}

    def walk(f, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(f[k], w[k], f"{path}/{k}")
        elif isinstance(w, (tuple, list)):
            for i, (a, b) in enumerate(zip(f, w)):
                walk(a, b, f"{path}/{i}")
        else:
            assert_close(by_leaf[id(f)], w, F32_TOL, f"{msg}{path}")
    walk(factors, want, "")


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_adapter_gradient_match_jax(arch, remat):
    loss, factors, grads, _ = _port_loss_and_grad(arch, remat)
    want_loss, want_grad = _jax_loss_and_grad(arch, remat)
    assert_close(loss, want_loss, F32_TOL, f"{arch} remat={remat} loss")
    _grads_close(factors, grads, want_grad, f"{arch} remat={remat}")


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch, remat):
    loss, factors, grads, _ = _port_loss_and_grad(arch, remat)
    want_loss, want_factors, want_grads, _ = _port_loss_and_grad(arch,
                                                                 False)
    assert_close(loss, want_loss, F32_TOL, f"{arch} loss")
    for g, w in zip(grads, want_grads):
        assert_close(g, w, F32_TOL, f"{arch} {remat} gradient")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_saves_fewer_bytes_and_recomputes(arch, monkeypatch):
    calls = []
    orig = tt.block_forward

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return orig(*a, **k)
    monkeypatch.setattr(tt, "block_forward", counted)
    *_, kept = _port_loss_and_grad(arch, False)
    plain_calls = len(calls)
    calls.clear()
    *_, saved = _port_loss_and_grad(arch, "full")
    assert saved < kept
    assert len(calls) == 2 * plain_calls          # the backward's rerun


def test_no_checkpoint_outside_training(monkeypatch):
    """With autograd off, and in prefill, the blocks run once, unwrapped;
    the logits equal the unrematerialised model's."""
    seen = []
    monkeypatch.setattr(tt, "checkpoint",
                        lambda *a, **k: seen.append(1) or None)
    jcfg, jp, ja, tokens = _rig(ARCHS[0])
    cfg = get_config(ARCHS[0]).reduced()
    p, a = port_tree(jp), port_tree(ja)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        got, _ = make_model(cfg, remat="full").forward(p, a, batch)
        want, _ = make_model(cfg, remat=False).forward(p, a, batch)
    make_model(cfg, remat="dots").prefill(p, a, batch)
    assert not seen
    assert torch.equal(got, want)


def test_unknown_policy_raises_as_the_reference():
    jcfg, jp, ja, tokens = _rig(ARCHS[0])
    model = make_model(get_config(ARCHS[0]).reduced(), remat="nothing")
    with pytest.raises(KeyError):
        model.loss(port_tree(jp), port_tree(ja),
                   {"tokens": torch.from_numpy(tokens)})
    with pytest.raises(KeyError):
        jax_make_model(jcfg, remat="nothing").loss(
            jp, ja, {"tokens": jnp.asarray(tokens)})
    assert sorted(tt.REMAT_POLICIES) == ["dots", "full"]


# ------------------------------------------------------- on a test mesh --
def _flat_np(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_np(v, f"{prefix}|{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flat_np(v, f"{prefix}|{i}", out)
    else:
        out[prefix] = tree.detach().float().numpy()
    return out


@pytest.fixture(scope="module")
def remat_world(tmp_path_factory):
    """4 gloo ranks spawned once, each running ``launch.train.train`` with
    ``remat="full"`` for every arch of ARCHS on a (2, 2) mesh."""
    tmp = tmp_path_factory.mktemp("remat_mesh")
    cases = [dict(name=arch, kind="train", arch=arch, mesh=[2, 2],
                  kw=MESH_KW) for arch in ARCHS]
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    world = 4
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), str(tmp / "inputs.pkl"),
         str(tmp / "store"), str(k), str(world), str(tmp / f"out{k}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(world)]
    errs = []
    try:
        for k, p in enumerate(procs):
            _, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                errs.append(f"rank {k} exited {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, "\n".join(errs)
    return [dict(np.load(tmp / f"out{k}.npz")) for k in range(world)]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_train_on_a_2x2_gloo_world_matches_one_device(arch,
                                                            remat_world):
    """``launch.train.train(remat="full")`` on a (2, 2) ("data", "model")
    mesh of 4 gloo ranks: every rank's losses, trained adapters and upload
    equal the one-device run's without remat within 2e-5 of max|want|."""
    kw = dict(MESH_KW, remat=False)
    want = train.train(get_config(arch).reduced(), None, device="cpu", **kw)
    flat = _flat_np({"trained": want["trained"],
                     "adapters": want["adapters"]}, arch, {})
    for rank, arrays in enumerate(remat_world):
        got = {k: v for k, v in arrays.items() if k.split("|")[0] == arch}
        assert_close(got[f"{arch}|losses"], np.asarray(want["losses"]),
                     F32_TOL, f"losses on rank {rank}")
        assert set(got) == set(flat) | {f"{arch}|losses"}
        for key, w in flat.items():
            assert_close(got[key], w, F32_TOL, f"{key} on rank {rank}")
