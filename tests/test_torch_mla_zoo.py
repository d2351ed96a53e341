"""The port's latent attention (MLA), multi-token prediction and the three
MoE archs (granite-moe-3b-a800m, jamba-1.5-large-398b, deepseek-v3-671b)
against the JAX package on the CPU, at the reduced fp32 configs:

* ``mla_forward`` in full, prefill and decode, naive and absorbed, with a
  live LoRA on every projection, against JAX's (the absorbed decode also
  against the naive one at the reference's 2e-2); ``mla_init`` and
  ``mla_init_cache`` have JAX's layout;
* ``Model`` logits, prefill caches, decode logits and ``loss`` (value and
  gradient with respect to the adapters; deepseek's with its MTP term)
  against JAX's ``Model``, with the JAX parameters and adapters (a live
  B, per-layer ranks) carried across by ``repro_torch.bridge``;
* twins of ``tests/test_arch_smoke.py`` (one forward and one LoRA train
  step; the full configs' metadata) and ``tests/test_serve_consistency.py``
  (prefill + decode = the full forward; ``test_mla_absorbed_matches_naive``)
  for the three archs;
* the bridge carries the router (fp32), the expert ``(E, d, f)`` leaves,
  the MLA leaves and the ``mtp`` subtree leaf for leaf.

Tolerance F32_TOL (2e-5 of max|want|) unless stated.  Each arch's JAX
reference is built once per module (the ``jax_rigs`` fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close, port_tree

from repro.configs import BlockSpec as JBlockSpec
from repro.configs import get_config as jax_get_config
from repro.lora import attach_ranks as jax_attach_ranks
from repro.lora import init_pair as jax_init_pair
from repro.lora import strip_ranks as jax_strip_ranks
from repro.models import attention as ja
from repro.models.model import make_model as jax_make_model
from repro_torch.bridge import from_jax_params, to_numpy
from repro_torch.configs import BlockSpec, get_config
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models import attention as ta
from repro_torch.models.model import make_model
from repro_torch.optim import adam, apply_updates
from repro_torch.tree import tree_leaves, tree_map

MOE_ARCHS = ("granite-moe-3b-a800m", "jamba-1.5-large-398b",
             "deepseek-v3-671b")
DEEPSEEK = "deepseek-v3-671b"
PREFILL, DECODE = 24, 8
TOTAL = PREFILL + DECODE
#: the reference's absorbed-against-naive tolerance
ABSORBED_TOL = 2e-2
#: JAX's mla_forward, compiled (the config and block spec are hashable)
_jax_mla = jax.jit(ja.mla_forward, static_argnums=(3, 4),
                   static_argnames=("mode", "absorbed", "capacity"))


def _live_b(pair, rng, ranks):
    b = np.asarray(pair["B"])
    live = (np.arange(b.shape[-1]) < np.reshape(ranks, np.shape(ranks)
                                                + (1, 1))).astype(np.float32)
    if b.ndim == 4 and np.ndim(ranks) == 1:      # (repeat, E, out, r)
        live = live[:, None]
    nb = (rng.normal(size=b.shape) * 0.05).astype(np.float32) * live
    return dict(pair, B=jnp.asarray(nb), rank=jnp.asarray(ranks, jnp.int32))


# ------------------------------------------------------------------- MLA --
def _mla_rig(seed=0):
    """deepseek's reduced MLA block with a live LoRA on every target, and
    a token batch (2, TOTAL)."""
    jcfg = jax_get_config(DEEPSEEK).reduced()
    block = JBlockSpec(kind="mla", ffn="none")
    jp = ja.mla_init(jax.random.PRNGKey(seed), jcfg, block)
    specs = {"q_a": (jcfg.q_lora_rank, jcfg.d_model),
             "q_b": (jcfg.n_heads * (jcfg.qk_nope_dim + jcfg.qk_rope_dim),
                     jcfg.q_lora_rank),
             "kv_a": (jcfg.kv_lora_rank + jcfg.qk_rope_dim, jcfg.d_model),
             "kv_b": (jcfg.n_heads * (jcfg.qk_nope_dim + jcfg.v_head_dim),
                      jcfg.kv_lora_rank),
             "o": (jcfg.d_model, jcfg.n_heads * jcfg.v_head_dim)}
    rng = np.random.default_rng(seed + 1)
    lora = {k: _live_b(jax_init_pair(jax.random.PRNGKey(i), fo, fi, 8, 5),
                       rng, 5)
            for i, (k, (fo, fi)) in enumerate(specs.items())}
    x = rng.normal(size=(2, TOTAL, jcfg.d_model)).astype(np.float32)
    return jcfg, block, jp, lora, x


def test_mla_geometry_differs_from_gqa():
    """The reduced deepseek's values are narrower than its queries and
    keys, so the attention products take each operand's own head dim."""
    cfg = get_config(DEEPSEEK).reduced()
    assert cfg.v_head_dim != cfg.qk_nope_dim + cfg.qk_rope_dim
    full = get_config(DEEPSEEK)
    assert (full.v_head_dim, full.qk_nope_dim + full.qk_rope_dim) == (128,
                                                                      192)


@pytest.mark.parametrize("mode", ["full", "prefill"])
def test_mla_forward_matches_jax(mode):
    jcfg, jblock, jp, lora, x = _mla_rig()
    cfg, block = get_config(DEEPSEEK).reduced(), BlockSpec(kind="mla",
                                                           ffn="none")
    want, wcache = _jax_mla(jp, lora, jnp.asarray(x), jcfg, jblock,
                                  mode=mode, capacity=TOTAL + 4)
    got, gcache = ta.mla_forward(port_tree(jp), port_tree(lora),
                                 torch.from_numpy(x), cfg, block, mode=mode,
                                 capacity=TOTAL + 4)
    assert_close(got, want, F32_TOL, f"mla {mode}")
    if mode == "full":
        assert gcache is None and wcache is None
        return
    assert set(gcache) == {"ckv", "kr"}
    for k in gcache:
        assert gcache[k].shape[1] == TOTAL + 4
        assert_close(gcache[k], wcache[k], F32_TOL, f"prefill cache {k}")


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_matches_jax(absorbed):
    """Prefill PREFILL tokens, then decode the rest one at a time, naive or
    absorbed, against JAX's same steps (outputs and latent caches)."""
    jcfg, jblock, jp, lora, x = _mla_rig(2)
    cfg, block = get_config(DEEPSEEK).reduced(), BlockSpec(kind="mla",
                                                           ffn="none")
    p, tl = port_tree(jp), port_tree(lora)
    _, jc = _jax_mla(jp, lora, jnp.asarray(x[:, :PREFILL]), jcfg,
                           jblock, mode="prefill", capacity=TOTAL)
    _, tc = ta.mla_forward(p, tl, torch.from_numpy(x[:, :PREFILL]), cfg,
                           block, mode="prefill", capacity=TOTAL)
    for t in range(PREFILL, TOTAL):
        want, jc = _jax_mla(jp, lora, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  jblock, mode="decode", cache=jc,
                                  pos=jnp.asarray(t, jnp.int32),
                                  absorbed=absorbed)
        got, tc = ta.mla_forward(p, tl, torch.from_numpy(x[:, t:t + 1]),
                                 cfg, block, mode="decode", cache=tc, pos=t,
                                 absorbed=absorbed)
        assert_close(got, want, F32_TOL, f"decode at {t}")
    for k in ("ckv", "kr"):
        assert_close(tc[k], jc[k], F32_TOL, f"cache {k}")


def test_mla_absorbed_decode_matches_naive_decode():
    """The absorbed step against the naive one from the same cache (the
    absorbed form skips kv_b's adapter, so this holds without one)."""
    jcfg, jblock, jp, lora, x = _mla_rig(3)
    lora = dict(lora)
    del lora["kv_b"]
    cfg, block = get_config(DEEPSEEK).reduced(), BlockSpec(kind="mla",
                                                           ffn="none")
    p, tl = port_tree(jp), port_tree(lora)
    _, c = ta.mla_forward(p, tl, torch.from_numpy(x[:, :PREFILL]), cfg,
                          block, mode="prefill", capacity=TOTAL)
    step = torch.from_numpy(x[:, PREFILL:PREFILL + 1])
    naive, _ = ta.mla_forward(p, tl, step, cfg, block, mode="decode",
                              cache=c, pos=PREFILL)
    absorbed, _ = ta.mla_forward(p, tl, step, cfg, block, mode="decode",
                                 cache=c, pos=PREFILL, absorbed=True)
    assert_close(absorbed, naive, F32_TOL, "absorbed against naive")


def test_mla_init_and_cache_match_jax_layout():
    jcfg = jax_get_config(DEEPSEEK).reduced()
    cfg = get_config(DEEPSEEK).reduced()
    block, jblock = BlockSpec(kind="mla"), JBlockSpec(kind="mla")
    got = ta.mla_init(torch.Generator().manual_seed(0), cfg, block)
    want = ja.mla_init(jax.random.PRNGKey(0), jcfg, jblock)
    assert set(got) == set(want)
    for k in want:
        for leaf in want[k]:
            assert tuple(got[k][leaf].shape) == want[k][leaf].shape, k
    for seq_len in (5, 12):
        c = ta.mla_init_cache(cfg, block, 3, seq_len, torch.float32)
        jc = ja.mla_init_cache(jcfg, jblock, 3, seq_len, jnp.float32)
        assert {k: tuple(v.shape) for k, v in c.items()} == \
            {k: v.shape for k, v in jc.items()}
        assert not any(t.any() for t in c.values())
    assert ta.MLA_LORA_TARGETS == ja.MLA_LORA_TARGETS


# ----------------------------------------------------- against JAX Model --
def _jax_rig(name):
    """JAX params and adapters (nonzero B, ranks 2..) of the reduced config
    and its outputs on one token batch."""
    jcfg = jax_get_config(name).reduced()
    jmodel = jax_make_model(jcfg, remat=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    ja_ = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(7)
    ja_ = {"stages": tuple(
        {b: {k: _live_b(v, rng, np.arange(v["rank"].shape[0]) * 3 + 2)
             for k, v in unit.items()} for b, unit in st.items()}
        for st in ja_["stages"])}
    tokens = rng.integers(0, jcfg.vocab_size, (2, TOTAL)).astype(np.int32)
    full, _ = jax.jit(jmodel.forward)(jp, ja_,
                                      {"tokens": jnp.asarray(tokens)})
    last, jcaches = jax.jit(jmodel.prefill, static_argnames="capacity")(
        jp, ja_, {"tokens": jnp.asarray(tokens[:, :PREFILL])},
        capacity=TOTAL)
    pre_caches = jcaches
    decoded = []
    step = jax.jit(jmodel.decode_step)
    for t in range(PREFILL, TOTAL):
        logits, jcaches = step(jp, ja_, jcaches, jnp.asarray(tokens[:, t]),
                               jnp.asarray(t, jnp.int32))
        decoded.append(np.asarray(logits))
    factors, ranks = jax_strip_ranks(ja_)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda f: jmodel.loss(jp, jax_attach_ranks(f, ranks), batch)))(
            factors)
    return dict(jcfg=jcfg, jmodel=jmodel, jp=jp, ja=ja_, tokens=tokens,
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


def _port(rig, name, **model_kw):
    cfg = get_config(name).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rig["jcfg"])
    return (rig, cfg, make_model(cfg, remat=False, **model_kw),
            port_tree(rig["jp"]), port_tree(rig["ja"]))


def _same_caches(got, want, msg):
    assert len(got) == len(want)
    for got_stage, want_stage in zip(got, want):
        assert set(got_stage) == set(want_stage)
        for b in want_stage:
            assert set(got_stage[b]) == set(want_stage[b])
            for k in want_stage[b]:
                assert_close(got_stage[b][k], want_stage[b][k], F32_TOL,
                             f"{msg} {b}/{k}")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_forward_logits_match_jax(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    got, caches = model.forward(p, a, {"tokens": torch.from_numpy(
        rig["tokens"])})
    assert caches is None
    assert got.shape == (2, TOTAL, cfg.vocab_size)
    assert_close(got, rig["full"], F32_TOL, f"{name} logits")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_prefill_and_decode_match_jax(jax_rigs, name):
    """Prefill's last logits and every layer's cache (GQA's KV, MLA's
    latent ckv/kr, mamba's conv and SSM state), then the decode logits and
    the caches after the last step."""
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    tokens = torch.from_numpy(rig["tokens"])
    last, caches = model.prefill(p, a, {"tokens": tokens[:, :PREFILL]},
                                 capacity=TOTAL)
    assert_close(last, rig["last"], F32_TOL, f"{name} prefill logits")
    _same_caches(caches, rig["pre_caches"], f"{name} prefill cache")
    for i, t in enumerate(range(PREFILL, TOTAL)):
        logits, caches = model.decode_step(p, a, caches, tokens[:, t], t)
        assert_close(logits, rig["decoded"][i], F32_TOL,
                     f"{name} decode logits at {t}")
    _same_caches(caches, rig["caches"], f"{name} cache after decode")


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_loss_and_its_adapter_gradient_match_jax(jax_rigs, name):
    """Model.loss (deepseek's with 0.3 x its MTP term) and its gradient
    with respect to every adapter factor, the expert pairs' included."""
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    assert ("mtp" in p) == bool(cfg.mtp_depth) == (name == DEEPSEEK)
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


def test_mtp_term_matches_jax(jax_rigs):
    """deepseek's MTP term alone: the re-embedding, mtp/proj and the MLA +
    MoE block without adapters, against JAX's ``_mtp_loss``."""
    rig, cfg, model, p, a = _port(jax_rigs(DEEPSEEK), DEEPSEEK)
    batch = {"tokens": jnp.asarray(rig["tokens"])}
    want = rig["jmodel"]._mtp_loss(rig["jp"], rig["ja"], batch, None)
    got = model._mtp_loss(p, a, {"tokens": torch.from_numpy(
        rig["tokens"])}, None)
    assert_close(got, np.float32(want), F32_TOL, "mtp loss")


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", DEEPSEEK])
def test_init_cache_matches_jax_layout_and_starts_a_sequence(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    caches = model.init_cache(2, 12, device="cpu")
    want = rig["jmodel"].init_cache(2, 12)
    assert [tuple(t.shape) for t in tree_leaves(caches)] == \
        [tuple(w.shape) for w in jax.tree.leaves(want)]
    assert not any(t.any() for t in tree_leaves(caches))
    tokens = torch.from_numpy(rig["tokens"][:, :6])
    full, _ = model.forward(p, a, {"tokens": tokens})
    for t in range(6):
        logits, caches = model.decode_step(p, a, caches, tokens[:, t], t)
        assert_close(logits, full[:, t], F32_TOL, f"decode at {t}")


def test_bridge_carries_moe_mla_and_mtp_leaves(jax_rigs):
    """The router (fp32), the expert (E, d, f) kernels, the MLA leaves and
    the mtp subtree cross leaf for leaf and come back bit for bit."""
    rig = jax_rigs(DEEPSEEK)
    for tree in (rig["jp"], rig["ja"]):
        src = jax.tree.map(np.asarray, tree)
        back = to_numpy(from_jax_params(src, "cpu"))
        flat_s = jax.tree_util.tree_flatten_with_path(src)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [q for q, _ in flat_s] == [q for q, _ in flat_b]
        for (path, s), (_, b) in zip(flat_s, flat_b):
            assert s.dtype == b.dtype and np.array_equal(s, b), path
    p = from_jax_params(jax.tree.map(np.asarray, rig["jp"]), "cpu")
    cfg = rig["jcfg"]
    moe = p["stages"][1]["b0"]["ffn"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["experts"]["gate"]["w"].shape == (
        1, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert set(p["stages"][0]["b0"]["mix"]) == {
        "ln", "q_a", "q_ln", "q_b", "kv_a", "kv_ln", "kv_b", "o"}
    assert set(p["mtp"]) == {"proj", "block", "ln"}
    assert set(p["mtp"]["block"]["ffn"]) >= {"router", "experts", "shared"}
    unit = from_jax_params(jax.tree.map(np.asarray, rig["ja"]),
                           "cpu")["stages"][1]["b0"]
    assert unit["ffn/experts/up"]["A"].shape[:2] == (1, cfg.n_experts)


# ----------------------------------------------- tests/test_arch_smoke.py --
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_smoke_forward_and_train_step(name):
    """One forward and one LoRA-only Adam step through autograd, as the
    JAX package's arch smoke test takes it: B starts at 0 and must move."""
    cfg = get_config(name).reduced()
    assert cfg.n_layers <= 2 and cfg.d_model <= 256 and cfg.n_experts <= 4
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


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_full_config_metadata(name):
    cfg = get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config(name))
    assert cfg.n_layers >= 24 and cfg.vocab_size >= 32000
    table = {"deepseek-v3-671b": (61, 7168, 128, 128),
             "jamba-1.5-large-398b": (72, 8192, 64, 8),
             "granite-moe-3b-a800m": (32, 1536, 24, 8)}
    l, d, h, kv = table[name]
    assert cfg.n_layers == l and cfg.d_model == d
    assert cfg.n_heads == h and cfg.n_kv_heads == kv


# ----------------------------------------- tests/test_serve_consistency.py --
def _setup(name, **model_kw):
    cfg = get_config(name).reduced()
    model = make_model(cfg, remat=False, **model_kw)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=4)
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, TOTAL)))
    return cfg, model, params, adapters, tokens


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_full_forward(name):
    """Prefill PREFILL tokens into caches of TOTAL slots, decode the rest:
    each position's logits equal the full forward's there (the reduced
    configs' capacity factor 8.0 drops no token)."""
    cfg, model, params, adapters, tokens = _setup(name)
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


def test_mla_absorbed_matches_naive():
    """Decode every position from an empty cache with the naive and the
    absorbed MLA: the last logits agree within the reference's 2e-2."""
    cfg, model, params, adapters, tokens = _setup(DEEPSEEK)
    model_abs = make_model(cfg, remat=False, mla_absorbed=True)
    caches = model.init_cache(2, TOTAL, device="cpu")
    caches2 = model.init_cache(2, TOTAL, device="cpu")
    for t in range(TOTAL):
        logits_naive, caches = model.decode_step(params, adapters, caches,
                                                 tokens[:, t], t)
        logits_abs, caches2 = model_abs.decode_step(params, adapters,
                                                    caches2, tokens[:, t], t)
    assert_close(logits_abs, logits_naive, ABSORBED_TOL, "absorbed")


def test_mla_absorbed_model_matches_jax(jax_rigs):
    """The absorbed decode through the whole model against JAX's absorbed
    model, step for step from the same prefill."""
    rig, cfg, model, p, a = _port(jax_rigs(DEEPSEEK), DEEPSEEK,
                                  mla_absorbed=True)
    jmodel = jax_make_model(rig["jcfg"], remat=False, mla_absorbed=True)
    tokens = rig["tokens"]
    _, jc = jmodel.prefill(rig["jp"], rig["ja"],
                           {"tokens": jnp.asarray(tokens[:, :PREFILL])},
                           capacity=TOTAL)
    _, tc = model.prefill(p, a, {"tokens": torch.from_numpy(
        tokens[:, :PREFILL])}, capacity=TOTAL)
    for t in range(PREFILL, PREFILL + 3):
        want, jc = jmodel.decode_step(rig["jp"], rig["ja"], jc,
                                      jnp.asarray(tokens[:, t]),
                                      jnp.asarray(t, jnp.int32))
        got, tc = model.decode_step(p, a, tc, torch.from_numpy(tokens[:, t]),
                                    t)
        assert_close(got, want, F32_TOL, f"absorbed decode at {t}")
