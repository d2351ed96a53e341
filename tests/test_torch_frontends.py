"""The port's front-ends and encoder-decoder (whisper-large-v3,
phi-3-vision-4.2b) against the JAX package on the CPU, at the reduced fp32
configs:

* ``models.attention.gqa_forward``'s cross-attention block in full,
  prefill and decode modes, and the non-causal encoder stage;
* ``Model._encode`` (frames through ``frontend.proj``, the learned
  positions, the encoder stages, ``enc.final_ln``) and
  ``Model._embed_inputs`` (the projected patches before the tokens);
* ``Model`` logits, prefill caches (the cross-attention ``xk``/``xv``
  too), decode logits, ``loss`` and its gradient with respect to the
  adapters (``enc`` and ``frontend`` subtrees included);
* twins of ``tests/test_serve_consistency.py::test_decode_matches_full_
  forward`` and ``tests/test_arch_smoke.py::test_smoke_forward_and_train_
  step`` for both archs;
* the planned rbla round over both archs' adapter trees (``enc``,
  ``frontend``, ``stages``) against JAX's ``ref`` and interpreted
  ``pallas`` rounds.

Parameters and adapters come from the JAX initialisers (biases and norm
scales redrawn nonzero, every B live on its ranks) through
``repro_torch.bridge``; inputs are numpy from a seed.  Tolerance F32_TOL
(2e-5 of max|want|).  Each arch's JAX reference is built once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close, assert_trees_close, port_tree

from repro.configs import BlockSpec as JBlockSpec
from repro.configs import Stage as JStage
from repro.configs import get_config as jax_get_config
from repro.core import strategy as js
from repro.lora import attach_ranks as jax_attach_ranks
from repro.lora import init_pair as jax_init_pair
from repro.lora import strip_ranks as jax_strip_ranks
from repro.models import attention as ja
from repro.models import transformer as jt
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import BlockSpec, Stage, get_config
from repro_torch.core import strategy as ts
from repro_torch.kernels import runtime
from repro_torch.launch import serve
from repro_torch.lora import attach_ranks, strip_ranks
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.models.model import make_model
from repro_torch.optim import adam, apply_updates
from repro_torch.tree import tree_leaves, tree_map

WHISPER, PHI = "whisper-large-v3", "phi-3-vision-4.2b"
ARCHS = (WHISPER, PHI)
PREFILL, DECODE = 24, 8
TOTAL = PREFILL + DECODE


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _redraw(tree, rng):
    """Biases and norm scales drawn nonzero (the inits are constants)."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray((rng.normal(size=v.shape) * 0.3
                                 + (k == "scale")).astype(np.float32))
                    if k in ("b", "scale", "bias") and not isinstance(v, dict)
                    else _redraw(v, rng)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_redraw(v, rng) for v in tree)
    return tree


def _live(tree, rng):
    """Every pair with per-layer ranks 2, 5, ... (a pair without a layer
    axis at rank 3) and B drawn nonzero on its live columns."""
    if isinstance(tree, dict) and "B" in tree:
        b = np.asarray(tree["B"])
        lead = np.asarray(tree["rank"]).shape
        ranks = (np.arange(lead[0]) * 3 + 2 if lead else np.asarray(3))
        r = ranks.reshape(ranks.shape + (1,) * (b.ndim - ranks.ndim))
        m = (np.arange(b.shape[-1]) < r).astype(np.float32)
        return dict(tree, B=jnp.asarray((rng.normal(size=b.shape) * 0.05)
                                        .astype(np.float32) * m),
                    rank=jnp.asarray(ranks, jnp.int32))
    if isinstance(tree, dict):
        return {k: _live(v, rng) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_live(v, rng) for v in tree)
    return tree


def _batch(cfg, rng, b=2, s=TOTAL):
    """tokens, then whisper's frames or phi's patches (fp32 numpy)."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(b, cfg.encoder_seq,
                                         cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.normal(size=(b, cfg.n_prefix_tokens,
                                          cfg.frontend_dim)).astype(
                                              np.float32)
    return out


def _jb(batch, **over):
    return {k: jnp.asarray(v) for k, v in dict(batch, **over).items()}


def _tb(batch, **over):
    return {k: _t(v) for k, v in dict(batch, **over).items()}


def _n_prefix(cfg):
    return cfg.n_prefix_tokens if cfg.frontend == "vision_patches" else 0


def _jax_rig(name):
    """JAX params (biases and scales nonzero), adapters (live B, per-layer
    ranks), one batch and the reference's outputs on it."""
    jcfg = jax_get_config(name).reduced()
    jmodel = jax_make_model(jcfg, remat=False)
    rng = _rng(7)
    jp = _redraw(jmodel.init(jax.random.PRNGKey(0)), rng)
    ja_ = _live(jmodel.init_adapters(jax.random.PRNGKey(1), rank=4), rng)
    batch = _batch(jcfg, rng)
    npf = _n_prefix(jcfg)
    full, _ = jmodel.forward(jp, ja_, _jb(batch))
    pre = _jb(batch, tokens=batch["tokens"][:, :PREFILL])
    last, jcaches = jmodel.prefill(jp, ja_, pre, capacity=TOTAL + npf)
    pre_caches = jax.tree.map(np.asarray, jcaches)
    decoded = []
    for t in range(PREFILL, TOTAL):
        logits, jcaches = jmodel.decode_step(
            jp, ja_, jcaches, jnp.asarray(batch["tokens"][:, t]),
            jnp.asarray(t + npf, jnp.int32))
        decoded.append(np.asarray(logits))
    factors, ranks = jax_strip_ranks(ja_)
    loss, grads = jax.value_and_grad(
        lambda f: jmodel.loss(jp, jax_attach_ranks(f, ranks), _jb(batch)))(
            factors)
    return dict(jcfg=jcfg, jmodel=jmodel, jp=jp, ja=ja_, batch=batch,
                full=np.asarray(full), last=np.asarray(last),
                pre_caches=pre_caches,
                caches=jax.tree.map(np.asarray, jcaches), decoded=decoded,
                loss=float(loss), grads=grads)


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


def _trees_close(got, want, msg):
    """A port tree against a JAX (or numpy) tree leaf by leaf, walking
    each JAX leaf's path into the port tree."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(tree_leaves(got)) == len(flat), msg
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        assert_close(g, w, F32_TOL, f"{msg} {jax.tree_util.keystr(path)}")


# ------------------------------------------------- cross-attention block --
#: (label, config overrides)
CROSS_CASES = [("whisper", {}),
               ("bias_cap_post", dict(attn_softcap=5.0, post_block_norm=True,
                                      query_scale=0.1, n_kv_heads=1))]


def _cross_rig(over, seed=0):
    cfg = get_config(WHISPER).reduced(**over)
    jcfg = jax_get_config(WHISPER).reduced(**over)
    block = BlockSpec(kind="gqa", cross_attn=True)
    jblock = JBlockSpec(kind="gqa", cross_attn=True)
    rng = _rng(seed)
    jp = _redraw(ja.gqa_init(jax.random.PRNGKey(seed), jcfg, jblock), rng)
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dims = {"q": (h * hd, d), "k": (kv * hd, d), "v": (kv * hd, d),
            "o": (d, h * hd), "xq": (h * hd, d), "xk": (kv * hd, d),
            "xv": (kv * hd, d), "xo": (d, h * hd)}
    jl = {t: _live(jax_init_pair(jax.random.PRNGKey(10 + i), *dims[t],
                                 cfg.lora_r_max, 4), rng)
          for i, t in enumerate(ja.gqa_lora_targets(jblock))}
    enc = rng.normal(size=(2, cfg.encoder_seq, d)).astype(np.float32)
    return cfg, jcfg, block, jblock, jp, jl, enc, rng


@pytest.mark.parametrize("label,over", CROSS_CASES,
                         ids=[c[0] for c in CROSS_CASES])
@pytest.mark.parametrize("mode", ["full", "prefill"])
def test_cross_attention_forward_matches_jax(label, over, mode):
    cfg, jcfg, block, jblock, jp, jl, enc, rng = _cross_rig(over)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    kw = dict(mode=mode, capacity=16) if mode == "prefill" else dict(
        mode=mode)
    want, wc = ja.gqa_forward(jp, jl, jnp.asarray(x), jcfg, jblock,
                              enc_out=jnp.asarray(enc), **kw)
    got, gc = ta.gqa_forward(port_tree(jp), port_tree(jl), _t(x), cfg,
                             block, enc_out=_t(enc), **kw)
    assert_close(got, want, F32_TOL, f"{label} y")
    if mode == "full":
        assert gc is None and wc is None
        return
    assert set(gc) == set(wc) == {"k", "v", "xk", "xv"}
    assert_trees_close(gc, jax.tree.map(np.asarray, wc), F32_TOL, label)
    assert gc["xk"].shape == (2, cfg.encoder_seq, cfg.n_kv_heads,
                              cfg.head_dim)
    no_lora = ta.gqa_forward(port_tree(jp), None, _t(x), cfg, block,
                             enc_out=_t(enc), **kw)[0]
    assert float((got - no_lora).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="enc_out"):
        ta.gqa_forward(port_tree(jp), None, _t(x), cfg, block, **kw)


@pytest.mark.parametrize("label,over", CROSS_CASES,
                         ids=[c[0] for c in CROSS_CASES])
def test_cross_attention_decode_matches_jax(label, over):
    """Four decode steps from the JAX prefill cache: the cross keys and
    values come from the cache and pass through unchanged."""
    cfg, jcfg, block, jblock, jp, jl, enc, rng = _cross_rig(over, seed=2)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    _, jcache = ja.gqa_forward(jp, jl, jnp.asarray(x), jcfg, jblock,
                               mode="prefill", capacity=16,
                               enc_out=jnp.asarray(enc))
    cache = port_tree(jcache)
    for pos in range(12, 16):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = ja.gqa_forward(jp, jl, jnp.asarray(x1), jcfg, jblock,
                                      mode="decode", cache=jcache,
                                      pos=jnp.asarray(pos, jnp.int32))
        got, cache = ta.gqa_forward(port_tree(jp), port_tree(jl), _t(x1),
                                    cfg, block, mode="decode", cache=cache,
                                    pos=pos)
        assert_close(got, want, F32_TOL, f"{label} y at {pos}")
        assert_trees_close(cache, jax.tree.map(np.asarray, jcache),
                           F32_TOL, f"{label} cache at {pos}")


def test_encoder_stage_matches_jax():
    """whisper's encoder stage: non-causal GQA blocks with the plain GELU
    MLP and LayerNorms, two repeats, each layer's adapters live."""
    cfg = get_config(WHISPER).reduced()
    jcfg = jax_get_config(WHISPER).reduced()
    stage = Stage(unit=cfg.encoder_stages[0].unit, repeat=2)
    jstage = JStage(unit=jcfg.encoder_stages[0].unit, repeat=2)
    assert not stage.unit[0].causal
    rng = _rng(4)
    jp = _redraw(jt.stage_init(jax.random.PRNGKey(0), jcfg, jstage), rng)
    jl = _live(jt.stage_lora_init(jax.random.PRNGKey(1), jcfg, jstage, 8, 4),
               rng)
    x = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    pos = np.arange(cfg.encoder_seq)
    want, wc = jt.stage_forward(jp, jl, jnp.asarray(x), jcfg, jstage,
                                mode="full", positions=jnp.asarray(pos))
    got, gc = tt.stage_forward(port_tree(jp), port_tree(jl), _t(x), cfg,
                               stage, mode="full", positions=_t(pos))
    assert wc is None and gc is None
    assert_close(got, want, F32_TOL, "encoder stage")
    # non-causal: the first position sees the last
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = tt.stage_forward(port_tree(jp), port_tree(jl), _t(x2), cfg,
                             stage, mode="full", positions=_t(pos))[0]
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-6


def test_encode_matches_jax(jax_rigs):
    rig, cfg, model, p, a = _port(jax_rigs(WHISPER), WHISPER)
    frames = rig["batch"]["frames"]
    want = rig["jmodel"]._encode(rig["jp"], rig["ja"], jnp.asarray(frames))
    got = model._encode(p, a, _t(frames))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert_close(got, want, F32_TOL, "encode")
    # fewer frames than encoder_seq take the first positions
    short = model._encode(p, a, _t(frames[:, :10]))
    assert_close(short, rig["jmodel"]._encode(
        rig["jp"], rig["ja"], jnp.asarray(frames[:, :10])), F32_TOL,
        "encode 10 frames")
    assert_close(model._encode(p, None, _t(frames)), rig["jmodel"]._encode(
        rig["jp"], None, jnp.asarray(frames)), F32_TOL, "encode, no LoRA")


def test_embed_inputs_matches_jax(jax_rigs):
    rig, cfg, model, p, a = _port(jax_rigs(PHI), PHI)
    want, wn = rig["jmodel"]._embed_inputs(rig["jp"], rig["ja"],
                                           _jb(rig["batch"]))
    got, n = model._embed_inputs(p, a, _tb(rig["batch"]))
    assert n == wn == cfg.n_prefix_tokens
    assert got.shape == (2, cfg.n_prefix_tokens + TOTAL, cfg.d_model)
    assert_close(got, want, F32_TOL, "embed_inputs")
    wcfg = get_config(WHISPER).reduced()
    wmodel = make_model(wcfg)
    wp = wmodel.init(torch.Generator().manual_seed(0))
    x, n = wmodel._embed_inputs(wp, None, {"tokens": torch.zeros(
        (1, 3), dtype=torch.long)})
    assert n == 0 and x.shape == (1, 3, wcfg.d_model)


# ----------------------------------------------------- against JAX Model --
@pytest.mark.parametrize("name", ARCHS)
def test_init_and_adapters_match_jax_layout(jax_rigs, name):
    """``init``, ``init_adapters`` (the ``enc`` and ``frontend`` subtrees;
    the front-end pair has no layer axis) and ``init_cache`` (cross-
    attention ``xk``/``xv`` of ``encoder_seq``) as JAX lays them out."""
    rig, cfg, model, _, _ = _port(jax_rigs(name), name)
    jm = rig["jmodel"]
    for got, want in (
            (model.init(torch.Generator().manual_seed(0)),
             jm.init(jax.random.PRNGKey(0))),
            (model.init_adapters(torch.Generator().manual_seed(1), rank=4),
             jm.init_adapters(jax.random.PRNGKey(1), rank=4)),
            (model.init_cache(2, 16, device="cpu"), jm.init_cache(2, 16))):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(tree_leaves(got)) == len(flat_w)
        for path, w in flat_w:
            g = got
            for k in path:
                g = g[k.key if hasattr(k, "key") else k.idx]
            assert tuple(g.shape) == tuple(w.shape), path
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    ad = model.init_adapters(torch.Generator().manual_seed(1), rank=4)
    assert ad["frontend"]["proj"]["A"].shape == (cfg.lora_r_max,
                                                 cfg.frontend_dim)
    assert ("enc" in ad) == cfg.is_encdec


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_jax(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    got, caches = model.forward(p, a, _tb(rig["batch"]))
    assert caches is None
    assert got.shape == (2, TOTAL, cfg.vocab_size)
    assert_close(got, rig["full"], F32_TOL, f"{name} logits")


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(jax_rigs, name):
    """Prefill's last logits and every layer's caches (whisper's cross
    keys and values too; phi's padded to prompt + new + prefix), then each
    decode step's logits at position ``t + n_prefix`` and the caches after
    the last step."""
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    npf = _n_prefix(cfg)
    batch = _tb(rig["batch"])
    tokens = batch["tokens"]
    last, caches = model.prefill(p, a, dict(batch, tokens=tokens[:, :PREFILL]),
                                 capacity=TOTAL + npf)
    assert_close(last, rig["last"], F32_TOL, f"{name} prefill logits")
    _trees_close(caches, rig["pre_caches"], f"{name} prefill caches")
    if cfg.is_encdec:
        assert caches[0]["b0"]["xk"].shape[2] == cfg.encoder_seq
    for i, t in enumerate(range(PREFILL, TOTAL)):
        logits, caches = model.decode_step(p, a, caches, tokens[:, t],
                                           t + npf)
        assert_close(logits, rig["decoded"][i], F32_TOL,
                     f"{name} decode logits at {t}")
    _trees_close(caches, rig["caches"], f"{name} caches after decode")


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_its_adapter_gradient_match_jax(jax_rigs, name):
    rig, cfg, model, p, a = _port(jax_rigs(name), name)
    factors, ranks = strip_ranks(a)
    factors = tree_map(lambda t: t.requires_grad_(True), factors)
    loss = model.loss(p, attach_ranks(factors, ranks), _tb(rig["batch"]))
    assert_close(loss.detach(), np.float32(rig["loss"]), F32_TOL,
                 f"{name} loss")
    got = iter(torch.autograd.grad(loss, tree_leaves(factors)))
    got = tree_map(lambda _: next(got), factors)
    _trees_close(got, rig["grads"], f"{name} dloss/dadapter")
    assert float(got["frontend"]["proj"]["B"].abs().max()) > 0.0


# ----------------------------------------- tests/test_serve_consistency.py --
@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_full_forward(name):
    """Prefill + step-by-step decode reproduce the full forward, the
    port's own weights (a VLM decodes at ``t + n_prefix``)."""
    cfg = get_config(name).reduced()
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=4)
    batch = _tb(_batch(cfg, _rng(3)))
    npf = _n_prefix(cfg)
    full, _ = model.forward(params, adapters, batch)
    assert torch.isfinite(full).all()
    last, caches = model.prefill(
        params, adapters, dict(batch, tokens=batch["tokens"][:, :PREFILL]),
        capacity=TOTAL + npf)
    assert_close(last, full[:, PREFILL - 1], 1e-4, f"{name} prefill")
    for t in range(PREFILL, TOTAL):
        logits, caches = model.decode_step(params, adapters, caches,
                                           batch["tokens"][:, t], t + npf)
        assert_close(logits, full[:, t], 1e-4, f"{name} decode at {t}")


# ----------------------------------------------- tests/test_arch_smoke.py --
@pytest.mark.parametrize("name", ARCHS)
def test_smoke_forward_and_train_step(name):
    """One forward and one LoRA-only Adam step through autograd, as the
    JAX package's arch smoke test takes it: B starts at 0 and must move,
    the front-end pair's too."""
    cfg = get_config(name).reduced()
    assert cfg.n_layers <= 2 and cfg.d_model <= 256
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=4)
    batch = _tb(_batch(cfg, _rng(0), s=64))
    logits, _ = model.forward(params, adapters, batch)
    assert logits.shape == (2, 64, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    factors, ranks = strip_ranks(adapters)
    opt = adam(1e-3)
    state = opt.init(factors)
    live = tree_map(lambda t: t.detach().requires_grad_(True), factors)
    loss = model.loss(params, attach_ranks(live, ranks), batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    grads = tree_map(lambda _: next(grads), factors)
    updates, state = opt.update(grads, state, factors)
    moved_to = apply_updates(factors, updates)
    assert np.isfinite(float(loss.detach()))
    moved = sum(float((x - y).abs().sum()) for x, y in
                zip(tree_leaves(moved_to), tree_leaves(factors)))
    assert moved > 0.0
    assert float((moved_to["frontend"]["proj"]["B"]
                  - factors["frontend"]["proj"]["B"]).abs().sum()) > 0.0


def test_serve_whisper_greedy_tokens_are_the_full_forward_argmax(capsys):
    """``launch.serve`` on whisper: the encoder runs once in the prefill
    and every decode step reads its keys and values from the caches."""
    res = serve.main(["--arch", WHISPER, "--preset", "reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "12", "--new",
                      "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: ") and out[1].startswith(
        "decode: 4 steps, ")
    cfg = get_config(WHISPER).reduced()
    assert res["caches"][0]["b0"]["xk"].shape == (
        1, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    model = make_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    adapters = model.init_adapters(torch.Generator().manual_seed(1), rank=8)
    batch = serve.make_batch(cfg, 2, 12, "cpu")
    seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], 1)
    full, _ = model.forward(params, adapters, dict(batch, tokens=seq))
    assert torch.equal(full[:, 11:].argmax(-1), res["tokens"])


def test_make_batch_draws_the_reference_stream():
    """tokens, then frames, then patches from one ``default_rng(0)``, in
    the reference launcher's order."""
    for name in ARCHS:
        cfg = get_config(name).reduced()
        got = serve.make_batch(cfg, 2, 7, "cpu")
        rng = np.random.default_rng(0)
        assert torch.equal(got["tokens"], torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 7))))
        key = "frames" if cfg.is_encdec else "patches"
        n = cfg.encoder_seq if cfg.is_encdec else cfg.n_prefix_tokens
        want = rng.normal(size=(2, n, cfg.frontend_dim)).astype(np.float32)
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], torch.from_numpy(want))
        assert set(got) == {"tokens", key}


# --------------------------------------------------- the planned rbla round --
@pytest.fixture(scope="module")
def rbla_rigs():
    built = {}

    def get(name):
        if name not in built:
            jcfg = jax_get_config(name).reduced()
            jmodel = jax_make_model(jcfg, remat=False)
            rng = _rng(11)
            clients = []
            for i, r in enumerate((2, 5, 8)):
                ad = jmodel.init_adapters(jax.random.PRNGKey(20 + i), rank=r)

                def live(tree, r=r):
                    if isinstance(tree, dict) and "B" in tree:
                        b = np.asarray(tree["B"])
                        m = (np.arange(b.shape[-1]) < r).astype(np.float32)
                        return dict(tree, B=jnp.asarray(
                            (rng.normal(size=b.shape) * 0.05).astype(
                                np.float32) * m))
                    if isinstance(tree, dict):
                        return {k: live(v) for k, v in tree.items()}
                    if isinstance(tree, tuple):
                        return tuple(live(v) for v in tree)
                    return tree
                clients.append(live(ad))
            w = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
            wants = [jax.tree.map(np.asarray, js.get_strategy(
                "rbla").aggregate_adapters(clients, w, r_max=8, backend=jb))
                for jb in ("ref", "pallas")]
            built[name] = (clients, w, wants)
        return built[name]
    return get


@pytest.mark.parametrize("backend", ["ref", "auto"])
@pytest.mark.parametrize("name", ARCHS)
def test_rbla_round_over_the_adapter_tree_matches_jax(rbla_rigs, name,
                                                      backend):
    """Three clients' whole adapter trees (ranks 2, 5, 8; whisper's
    ``enc``, ``frontend`` and ``stages``, phi's ``frontend`` and
    ``stages``) through the port's planned rbla round -- one plain
    packed_agg call on the CPU -- against JAX's ``ref`` and interpreted
    ``pallas`` rounds."""
    clients, w, wants = rbla_rigs(name)
    assert set(clients[0]) == ({"enc", "frontend", "stages"}
                               if name == WHISPER else {"frontend", "stages"})
    runtime.reset_counts()
    got = ts.get_strategy("rbla").with_options().aggregate_adapters(
        [port_tree(c) for c in clients], torch.tensor(np.asarray(w)),
        r_max=8, backend=backend)
    assert runtime.PLAIN_CALLS["packed_agg"] == 1
    assert sum(runtime.LAUNCHES.values()) == 0
    for want in wants:
        _trees_close(got, want, name)
