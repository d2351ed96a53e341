"""The port's dense zoo (h2o-danube-3-4b, yi-34b, chatglm3-6b, gemma2-9b)
against the JAX package on the CPU, at the reduced fp32 configs:

* ``Model`` logits, prefill caches, decode logits and ``loss`` (value and
  gradient with respect to the adapters) against JAX's ``Model``, with the
  JAX parameters and adapters (a live B, per-layer ranks) carried across
  by ``repro_torch.bridge``, at F32_TOL (2e-5 of max|want|);
* twins of ``tests/test_arch_smoke.py`` (one forward and one LoRA train
  step with the port's ``adam`` through autograd, the four archs and
  mamba2), ``tests/test_model_properties.py`` (causality, SWA locality,
  the RoPE properties, the softcap bounds) and
  ``tests/test_serve_consistency.py`` (prefill + decode = the full forward,
  the SWA ring wrapping inside the window);
* ``init_cache``'s layout and ``seq_len`` rule, and a bridge round trip of
  a GQA/dense parameter and adapter tree.

Each arch's JAX reference is built once per module (the ``jax_rigs``
fixture).
"""
import dataclasses

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
from repro_torch.bridge import from_jax_params, to_numpy
from repro_torch.configs import BlockSpec, Stage, get_config
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models.common import apply_rope, softcap
from repro_torch.models.model import make_model
from repro_torch.optim import adam, apply_updates
from repro_torch.tree import tree_leaves, tree_map

DENSE = ("h2o-danube-3-4b", "yi-34b", "chatglm3-6b", "gemma2-9b")
PREFILL, DECODE = 24, 8
TOTAL = PREFILL + DECODE


def _live_b(pair, rng, ranks):
    b = np.asarray(pair["B"])
    live = (np.arange(b.shape[-1]) < ranks[:, None, None]).astype(
        np.float32)
    nb = (rng.normal(size=b.shape) * 0.05).astype(np.float32) * live
    return dict(pair, B=jnp.asarray(nb), rank=jnp.asarray(ranks, jnp.int32))


def _jax_rig(name):
    """JAX params and adapters (nonzero B, ranks 2..) of the reduced config
    and its outputs on one token batch."""
    jcfg = jax_get_config(name).reduced()
    jmodel = jax_make_model(jcfg, remat=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    ja = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(7)
    ja = {"stages": tuple(
        {b: {k: _live_b(v, rng, np.arange(v["rank"].shape[0]) * 3 + 2)
             for k, v in unit.items()} for b, unit in st.items()}
        for st in ja["stages"])}
    tokens = rng.integers(0, jcfg.vocab_size, (2, TOTAL)).astype(np.int32)
    full, _ = jmodel.forward(jp, ja, {"tokens": jnp.asarray(tokens)})
    last, jcaches = jmodel.prefill(
        jp, ja, {"tokens": jnp.asarray(tokens[:, :PREFILL])},
        capacity=TOTAL)
    pre_caches = jcaches
    decoded = []
    for t in range(PREFILL, TOTAL):
        logits, jcaches = jmodel.decode_step(
            jp, ja, jcaches, jnp.asarray(tokens[:, t]),
            jnp.asarray(t, jnp.int32))
        decoded.append(np.asarray(logits))
    factors, ranks = jax_strip_ranks(ja)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(
        lambda f: jmodel.loss(jp, jax_attach_ranks(f, ranks), batch))(factors)
    return dict(jcfg=jcfg, jmodel=jmodel, jp=jp, ja=ja, tokens=tokens,
                full=np.asarray(full), last=np.asarray(last),
                pre_caches=jax.tree.map(np.asarray, pre_caches),
                caches=jax.tree.map(np.asarray, jcaches), decoded=decoded,
                loss=float(loss), grads=jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def jax_rigs():
    """``jax_rigs(name)``: the arch's JAX reference, built once per
    module."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _jax_rig(name)
        return built[name]
    return get


def _port(rig, name):
    cfg = get_config(name).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rig["jcfg"])
    return (rig, cfg, make_model(cfg, remat=False), port_tree(rig["jp"]),
            port_tree(rig["ja"]))


# ----------------------------------------------------- against JAX Model --
@pytest.mark.parametrize("name", DENSE)
def test_forward_logits_match_jax(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    got, caches = model.forward(p, a, {"tokens": torch.from_numpy(
        rig["tokens"])})
    assert caches is None
    assert got.shape == (2, TOTAL, cfg.vocab_size)
    assert_close(got, rig["full"], F32_TOL, f"{name} logits")


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_jax(jax_rigs, name):
    """Prefill's last logits and every layer's KV cache (padded to the
    capacity, the SWA layers' in ring order), then the decode logits and
    the caches after the last step."""
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    tokens = torch.from_numpy(rig["tokens"])
    last, caches = model.prefill(p, a, {"tokens": tokens[:, :PREFILL]},
                                 capacity=TOTAL)
    assert_close(last, rig["last"], F32_TOL, f"{name} prefill logits")
    want = rig["pre_caches"]
    assert len(caches) == len(want)
    for got_stage, want_stage in zip(caches, want):
        assert set(got_stage) == set(want_stage)
        for b in want_stage:
            for k in ("k", "v"):
                assert_close(got_stage[b][k], want_stage[b][k], F32_TOL,
                             f"{name} prefill cache {b}/{k}")
    for i, t in enumerate(range(PREFILL, TOTAL)):
        logits, caches = model.decode_step(p, a, caches, tokens[:, t], t)
        assert_close(logits, rig["decoded"][i], F32_TOL,
                     f"{name} decode logits at {t}")
    for got_stage, want_stage in zip(caches, rig["caches"]):
        for b in want_stage:
            for k in ("k", "v"):
                assert_close(got_stage[b][k], want_stage[b][k], F32_TOL,
                             f"{name} cache {b}/{k} after decode")


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_its_adapter_gradient_match_jax(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    factors, ranks = strip_ranks(a)
    factors = tree_map(lambda t: t.requires_grad_(True), factors)
    loss = model.loss(p, attach_ranks(factors, ranks),
                      {"tokens": torch.from_numpy(rig["tokens"])})
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert_close(loss.detach(), np.float32(rig["loss"]), F32_TOL,
                 f"{name} loss")
    grads = torch.autograd.grad(loss, tree_leaves(factors))
    want = jax.tree.leaves(rig["grads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert_close(g, w, F32_TOL, f"{name} dloss/dadapter")


# ----------------------------------------------- tests/test_arch_smoke.py --
@pytest.mark.parametrize("name", DENSE + ("mamba2-1.3b",))
def test_smoke_forward_and_train_step(name):
    """One forward and one LoRA-only Adam step through autograd, as the
    JAX package's arch smoke test takes it: B starts at 0 and must move."""
    cfg = get_config(name).reduced()
    assert cfg.n_layers <= 2 and cfg.d_model <= 256
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=4)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 64)))}
    logits, _ = model.forward(params, adapters, batch)
    assert logits.shape == (2, 64, cfg.vocab_size)
    assert torch.isfinite(logits).all()

    factors, ranks = strip_ranks(adapters)
    opt = adam(1e-3)
    state = opt.init(factors)
    live = tree_map(lambda t: t.detach().requires_grad_(True), factors)
    loss = model.loss(params, attach_ranks(live, ranks), batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), factors)
    updates, state = opt.update(grads, state, factors)
    moved_to = apply_updates(factors, updates)
    assert np.isfinite(float(loss.detach()))
    moved = sum(float((x - y).abs().sum()) for x, y in
                zip(tree_leaves(moved_to), tree_leaves(factors)))
    assert moved > 0.0


# ------------------------------------------ tests/test_model_properties.py --
def _params(cfg):
    model = make_model(cfg, remat=False)
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "gemma2-9b"])
def test_causality(name):
    """Changing tokens after position t must not change logits at <= t."""
    model, params = _params(get_config(name).reduced())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab_size, (1, 32))
    t = 16
    toks2 = toks.copy()
    toks2[:, t + 1:] = rng.integers(0, model.cfg.vocab_size,
                                    toks2[:, t + 1:].shape)
    l1, _ = model.forward(params, None, {"tokens": torch.as_tensor(toks)})
    l2, _ = model.forward(params, None, {"tokens": torch.as_tensor(toks2)})
    assert_close(l1[:, :t + 1], l2[:, :t + 1], F32_TOL, "causality")
    assert float((l1[:, t + 1:] - l2[:, t + 1:]).abs().max()) > 1e-3


def _windowed(name, window):
    cfg = get_config(name).reduced()
    return cfg.reduced(stages=tuple(Stage(unit=tuple(
        BlockSpec(kind=b.kind, ffn=b.ffn, window=window) for b in s.unit),
        repeat=s.repeat) for s in cfg.stages))


def test_swa_locality():
    """With window w, logits at t depend only on tokens in (t-w, t]."""
    model, params = _params(_windowed("h2o-danube-3-4b", 4))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, model.cfg.vocab_size, (1, 32))
    toks2 = toks.copy()
    toks2[:, :8] = rng.integers(0, model.cfg.vocab_size, (1, 8))  # far past
    l1, _ = model.forward(params, None, {"tokens": torch.as_tensor(toks)})
    l2, _ = model.forward(params, None, {"tokens": torch.as_tensor(toks2)})
    # window 4 over the reduced config's one layer: the last position sees
    # the last 4 tokens
    assert_close(l1[:, -1], l2[:, -1], F32_TOL, "swa locality")
    assert float((l1[:, 8] - l2[:, 8]).abs().max()) > 1e-3


def test_rope_relative_property():
    """<rope(q,i), rope(k,j)> depends only on i-j (the rope invariant)."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(1, 1, 1, 64)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 1, 1, 64)), dtype=torch.float32)

    def dot_at(i, j):
        qr = apply_rope(q, torch.tensor([[i]]), 10000.0, "full")
        kr = apply_rope(k, torch.tensor([[j]]), 10000.0, "full")
        return float((qr * kr).sum())

    assert dot_at(5, 3) == pytest.approx(dot_at(15, 13), rel=1e-4)
    assert dot_at(0, 0) == pytest.approx(dot_at(9, 9), rel=1e-4)
    assert dot_at(5, 3) != pytest.approx(dot_at(5, 4), rel=1e-3)


def test_rope_half_leaves_second_half_unrotated():
    x = torch.ones((1, 1, 1, 8))
    out = apply_rope(x, torch.tensor([[7]]), 10000.0, "half")
    assert torch.equal(out[..., 4:], torch.ones(1, 1, 1, 4))
    assert not torch.allclose(out[..., :4], torch.ones(1, 1, 1, 4))


def test_softcap_bounds():
    x = torch.tensor([-1e6, -1.0, 0.0, 1.0, 1e6])
    y = softcap(x, 30.0)
    assert (y.abs() <= 30.0 + 1e-4).all()
    assert float(y[2]) == 0.0 and abs(float(y[1] + y[3])) < 1e-6
    assert torch.equal(softcap(x, 0.0), x)


# ----------------------------------------- tests/test_serve_consistency.py --
@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "gemma2-9b",
                                  "chatglm3-6b"])
def test_decode_matches_full_forward(name):
    """Prefill PREFILL tokens into caches of TOTAL slots, decode the rest:
    each position's logits equal the full forward's there."""
    cfg = get_config(name).reduced()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=4)
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, TOTAL)))
    full, _ = model.forward(params, adapters, {"tokens": tokens})
    assert torch.isfinite(full).all()
    last, caches = model.prefill(params, adapters,
                                 {"tokens": tokens[:, :PREFILL]},
                                 capacity=TOTAL)
    assert_close(last, full[:, PREFILL - 1], F32_TOL,
                 f"{name}: prefill logits diverge")
    for t in range(PREFILL, TOTAL):
        logits, caches = model.decode_step(params, adapters, caches,
                                           tokens[:, t], t)
        assert_close(logits, full[:, t], F32_TOL,
                     f"{name}: decode diverges at t={t}")


def test_swa_ring_wraps_correctly():
    """With window < context, ring-buffer decode must still match the full
    forward (the window mask hides everything the ring evicted)."""
    cfg = _windowed("h2o-danube-3-4b", 8)
    model, params = _params(cfg)
    rng = np.random.default_rng(5)
    total = 32
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, total)))
    full, _ = model.forward(params, None, {"tokens": tokens})
    _, caches = model.prefill(params, None, {"tokens": tokens[:, :16]},
                              capacity=total)
    assert caches[0]["b0"]["k"].shape[2] == 8
    for t in range(16, total):
        logits, caches = model.decode_step(params, None, caches,
                                           tokens[:, t], t)
        assert_close(logits, full[:, t], F32_TOL,
                     f"ring decode diverges at t={t}")


# ------------------------------------------------------ caches and bridge --
@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "gemma2-9b"])
def test_init_cache_matches_jax_layout_and_starts_a_sequence(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    with pytest.raises(ValueError, match="seq_len"):
        model.init_cache(2, device="cpu")
    caches = model.init_cache(2, 12, device="cpu")
    want = rig["jmodel"].init_cache(2, 12)
    got_leaves = tree_leaves(caches)
    want_leaves = jax.tree.leaves(want)
    assert [tuple(t.shape) for t in got_leaves] == \
        [tuple(w.shape) for w in want_leaves]
    assert not any(t.any() for t in got_leaves)
    tokens = torch.from_numpy(rig["tokens"][:, :6])
    full, _ = model.forward(p, a, {"tokens": tokens})
    for t in range(6):
        logits, caches = model.decode_step(p, a, caches, tokens[:, t], t)
        assert_close(logits, full[:, t], F32_TOL, f"decode at {t}")


def test_bridge_round_trips_a_dense_tree(jax_rigs):
    """A GQA/dense parameter and adapter tree crosses leaf for leaf and
    comes back bit for bit, its keys ("mix/q", "ffn/gate", ...) kept."""
    rig = jax_rigs("gemma2-9b")
    for tree in (rig["jp"], rig["ja"]):
        src = jax.tree.map(np.asarray, tree)
        port = from_jax_params(src, "cpu")
        back = to_numpy(port)
        flat_s = jax.tree_util.tree_flatten_with_path(src)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_s] == [p for p, _ in flat_b]
        for (path, s), (_, b) in zip(flat_s, flat_b):
            assert s.dtype == b.dtype and np.array_equal(s, b), path
    unit = from_jax_params(jax.tree.map(np.asarray, rig["ja"]),
                           "cpu")["stages"][0]["b0"]
    assert {"mix/q", "mix/k", "mix/v", "mix/o", "ffn/gate", "ffn/up",
            "ffn/down"} == set(unit)


def test_ssd_scan_kernel_refuses_a_backward():
    """The ssd_scan kernel has no backward: asked for one, its launch path
    raises before it builds, pointing at the plain version, and a mamba
    model's loss trains on the CPU path (test_smoke_forward_and_train_step
    above)."""
    from repro_torch.kernels.ssd_scan import ops
    x = torch.zeros(1, 8, 2, 4, requires_grad=True)
    dta = torch.zeros(1, 8, 2)
    bm = torch.zeros(1, 8, 4)
    with pytest.raises(NotImplementedError, match="scan_backend='ref'"):
        ops._ssd_cuda(x, dta, bm, bm, 8)
