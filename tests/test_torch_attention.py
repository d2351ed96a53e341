"""The port's attention, RoPE and dense MLP modules against the JAX package
on the CPU: ``models.common.rope_freqs``/``apply_rope`` (full, half,
none), ``models.attention`` (``gqa_forward`` in full, prefill and decode,
``_ring_from_tail``, ``gqa_init``, ``gqa_init_cache``, ``_choose_q_chunk``)
and ``models.mlp`` (``mlp_forward`` with silu, gelu and gelu_plain).

Parameters come from the JAX package's initialisers, with biases and norm
scales redrawn nonzero and LoRA pairs with a live B, carried across with
``repro_torch.bridge``; inputs are numpy from a seed.  Everything runs in
fp32 (``reduced()`` configs) and is held at F32_TOL, 2e-5 of max|want|.
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
from repro.lora import init_pair as jax_init_pair
from repro.models import attention as ja
from repro.models import common as jc
from repro.models import mlp as jm
from repro_torch.configs import BlockSpec, get_config
from repro_torch.models import attention as ta
from repro_torch.models import common as tc
from repro_torch.models import mlp as tm
from repro_torch.tree import tree_leaves


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ rope --
@pytest.mark.parametrize("head_dim,theta", [(32, 10_000.0), (128, 5e6)])
def test_rope_freqs_match_jax(head_dim, theta):
    assert_close(tc.rope_freqs(head_dim, theta),
                 jc.rope_freqs(head_dim, theta), F32_TOL, "freqs")


@pytest.mark.parametrize("kind", ["full", "half", "none"])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope_matches_jax(kind, decode):
    """(B, S, H, D) with positions (1, S) as full/prefill pass them, and
    (B, 1, H, D) at one position (1, 1) as decode does."""
    rng = _rng(0)
    s = 1 if decode else 40
    x = rng.normal(size=(2, s, 3, 32)).astype(np.float32)
    pos = (np.full((1, 1), 1234) if decode
           else np.arange(100, 100 + s)[None]).astype(np.int32)
    want = jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, kind)
    got = tc.apply_rope(_t(x), _t(pos), 10_000.0, kind)
    assert_close(got, want, F32_TOL, f"rope {kind}")
    if kind == "none":
        assert torch.equal(got, _t(x))
    if kind == "half":
        assert torch.equal(got[..., 16:], _t(x)[..., 16:])


def test_apply_rope_keeps_the_input_dtype():
    x = torch.randn(1, 4, 2, 16, generator=torch.Generator().manual_seed(0))
    out = tc.apply_rope(x.bfloat16(), torch.arange(4)[None], 10_000.0)
    assert out.dtype == torch.bfloat16
    assert_close(out, tc.apply_rope(x, torch.arange(4)[None], 10_000.0),
                 2e-2, "bf16 rope")


# --------------------------------------------------------------- helpers --
def _cfgs(**over):
    """The reduced h2o-danube config in both packages, with overrides."""
    return (get_config("h2o-danube-3-4b").reduced(**over),
            jax_get_config("h2o-danube-3-4b").reduced(**over))


def _live_b(pair, rng):
    b = np.asarray(pair["B"])
    live = (np.arange(b.shape[-1]) < np.asarray(pair["rank"])).astype(
        np.float32)
    nb = (rng.normal(size=b.shape) * 0.05).astype(np.float32) * live
    return dict(pair, B=jnp.asarray(nb))


def _redraw(tree, rng, names=("b", "scale")):
    """Biases and norm scales drawn nonzero (the inits are constants)."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                                * 0.3 + (k == "scale"))
                    if k in names and not isinstance(v, dict)
                    else _redraw(v, rng, names)) for k, v in tree.items()}
    return tree


def _lora(targets, dims, cfg, rng, seed):
    out = {}
    for i, t in enumerate(targets):
        fo, fi = dims[t]
        pair = jax_init_pair(jax.random.PRNGKey(seed + i), fo, fi,
                             cfg.lora_r_max, 3 + i % 4)
        out[t] = _live_b(pair, rng)
    return out


#: (label, config overrides, block window, prompt length)
GQA_CASES = [
    ("global", {}, 0, 24),
    ("swa_short", {}, 8, 24),
    ("bias_scale_cap", dict(qkv_bias=True, query_scale=0.1,
                            attn_softcap=5.0, post_block_norm=True), 0, 24),
    ("half_rope_kv1", dict(rope_kind="half", n_kv_heads=1, qkv_bias=True),
     6, 20),
    ("gemma_like", dict(query_scale=32 ** -0.5, attn_softcap=50.0,
                        post_block_norm=True, mlp_act="gelu",
                        rope_theta=1e6), 8, 24),
]


def _gqa_rig(over, window, seed=0):
    cfg, jcfg = _cfgs(**over)
    block = BlockSpec(kind="gqa", ffn="dense", window=window)
    jblock = JBlockSpec(kind="gqa", ffn="dense", window=window)
    rng = _rng(seed)
    jp = _redraw(ja.gqa_init(jax.random.PRNGKey(seed), jcfg, jblock), rng)
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dims = {"q": (h * hd, d), "k": (kv * hd, d), "v": (kv * hd, d),
            "o": (d, h * hd)}
    jl = _lora(ja.gqa_lora_targets(jblock), dims, cfg, rng, 10)
    return cfg, jcfg, block, jblock, jp, jl


def _gqa_call(cfg, jcfg, block, jblock, jp, jl, x, **kw):
    want, wc = ja.gqa_forward(jp, jl, jnp.asarray(x), jcfg, jblock, **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    tkw = dict(kw)
    if "positions" in tkw:
        tkw["positions"] = _t(tkw["positions"])
    if "cache" in tkw:
        tkw["cache"] = port_tree(kw["cache"])
    got, gc = ta.gqa_forward(port_tree(jp), port_tree(jl), _t(x), cfg,
                             block, **tkw)
    return got, gc, want, wc


# ------------------------------------------------------------------- gqa --
@pytest.mark.parametrize("label,over,window,s", GQA_CASES,
                         ids=[c[0] for c in GQA_CASES])
@pytest.mark.parametrize("mode", ["full", "prefill"])
def test_gqa_forward_matches_jax(label, over, window, s, mode):
    cfg, jcfg, block, jblock, jp, jl = _gqa_rig(over, window)
    x = _rng(1).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    kw = dict(mode=mode)
    if mode == "prefill":
        kw["capacity"] = s + 8
    got, gc, want, wc = _gqa_call(cfg, jcfg, block, jblock, jp, jl, x, **kw)
    assert_close(got, want, F32_TOL, f"{label} y")
    if mode == "full":
        assert gc is None and wc is None
        return
    assert set(gc) == set(wc) == {"k", "v"}
    for k in ("k", "v"):
        assert_close(gc[k], wc[k], F32_TOL, f"{label} cache {k}")
    t_want = min(window, s + 8) if window else s + 8
    assert gc["k"].shape == (2, t_want, cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("label,over,window,s", GQA_CASES,
                         ids=[c[0] for c in GQA_CASES])
def test_gqa_decode_matches_jax(label, over, window, s):
    """Four decode steps from the JAX prefill cache: an SWA window smaller
    than the prompt wraps the ring at once."""
    cfg, jcfg, block, jblock, jp, jl = _gqa_rig(over, window, seed=2)
    rng = _rng(3)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    _, jcache = ja.gqa_forward(jp, jl, jnp.asarray(x), jcfg, jblock,
                               mode="prefill", capacity=s + 4)
    cache = port_tree(jcache)
    for pos in range(s, s + 4):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = ja.gqa_forward(jp, jl, jnp.asarray(x1), jcfg, jblock,
                                      mode="decode", cache=jcache,
                                      pos=jnp.asarray(pos, jnp.int32))
        got, cache = ta.gqa_forward(port_tree(jp), port_tree(jl), _t(x1),
                                    cfg, block, mode="decode", cache=cache,
                                    pos=pos)
        assert_close(got, want, F32_TOL, f"{label} y at {pos}")
        for k in ("k", "v"):
            assert_close(cache[k], jcache[k], F32_TOL,
                         f"{label} cache {k} at {pos}")


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_clamps_the_write_like_jax(window):
    """A position past a full cache's end writes its last slot, and a
    negative one counts once from the end, then clamps (the reference's
    dynamic_update_slice places its start so); the port places the write
    the same way and leaves the caller's cache untouched."""
    cfg, jcfg, block, jblock, jp, jl = _gqa_rig({}, window, seed=4)
    rng = _rng(4)
    t = 16
    jcache = {k: jnp.asarray(rng.normal(size=(1, min(t, window or t),
                                              cfg.n_kv_heads, cfg.head_dim))
                             .astype(np.float32)) for k in ("k", "v")}
    cache = port_tree(jcache)
    before = {k: v.clone() for k, v in cache.items()}
    x1 = rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
    for pos in (t + 3, -1, -t - 5):
        want, wc = ja.gqa_forward(jp, jl, jnp.asarray(x1), jcfg, jblock,
                                  mode="decode", cache=jcache,
                                  pos=jnp.asarray(pos, jnp.int32))
        got, gc = ta.gqa_forward(port_tree(jp), port_tree(jl), _t(x1), cfg,
                                 block, mode="decode", cache=cache, pos=pos)
        assert_close(got, want, F32_TOL, f"y at {pos}")
        for k in ("k", "v"):
            assert_close(gc[k], wc[k], F32_TOL, f"cache {k} at {pos}")
            assert torch.equal(cache[k], before[k])


def test_gqa_forward_chunks_long_queries_like_jax():
    """A prompt over 1024 tokens goes in query chunks (1100 = 2 x 550)."""
    assert ta._choose_q_chunk(1100) == 550
    cfg, jcfg, block, jblock, jp, jl = _gqa_rig(
        dict(attn_softcap=5.0, n_heads=2, n_kv_heads=1), 300)
    x = _rng(5).normal(size=(1, 1100, cfg.d_model)).astype(np.float32)
    got, _, want, _ = _gqa_call(cfg, jcfg, block, jblock, jp, jl, x,
                                mode="full")
    assert_close(got, want, F32_TOL, "chunked y")


@pytest.mark.parametrize("s", [1, 7, 1024, 1025, 1100, 2048, 4099, 8192])
def test_choose_q_chunk_matches_jax(s):
    assert ta._choose_q_chunk(s) == ja._choose_q_chunk(s)


@pytest.mark.parametrize("t,w", [(5, 8), (8, 8), (13, 8), (24, 5)])
def test_ring_from_tail_matches_jax(t, w):
    rng = _rng(t)
    kk = rng.normal(size=(2, t, 2, 4)).astype(np.float32)
    vv = rng.normal(size=(2, t, 2, 4)).astype(np.float32)
    positions = np.arange(t).astype(np.int32)
    want = ja._ring_from_tail(jnp.asarray(kk), jnp.asarray(vv),
                              jnp.asarray(positions), w)
    got = ta._ring_from_tail(_t(kk), _t(vv), _t(positions), w)
    for g, wv, name in zip(got, want, ("k", "v", "positions")):
        assert_close(g, wv, 0.0, name)
    if t > w:       # slot = pos % w holds position pos
        kept = got[2]
        assert torch.equal(got[0][:, kept % w], _t(kk)[:, -w:])


def _same_layout(got, want):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(tree_leaves(got)) == len(flat_w)
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


@pytest.mark.parametrize("over", [{}, dict(qkv_bias=True,
                                           post_block_norm=True)])
def test_gqa_init_matches_jax_layout(over):
    cfg, jcfg = _cfgs(**over)
    for window in (0, 8):
        block = BlockSpec(kind="gqa", window=window)
        jblock = JBlockSpec(kind="gqa", window=window)
        got = ta.gqa_init(torch.Generator().manual_seed(0), cfg, block)
        _same_layout(got, ja.gqa_init(jax.random.PRNGKey(0), jcfg, jblock))
        if "q" in got and "b" in got["q"]:
            assert not got["q"]["b"].any()
        for seq_len in (5, 8, 20):
            cache = ta.gqa_init_cache(cfg, block, 3, seq_len, torch.float32)
            _same_layout(cache, ja.gqa_init_cache(jcfg, jblock, 3, seq_len,
                                                  jnp.float32))
            assert not any(t.any() for t in tree_leaves(cache))
    assert ta.gqa_lora_targets(BlockSpec()) == ja.gqa_lora_targets(
        JBlockSpec())


def test_gqa_cross_attention_raises():
    """A cross-attention block (whisper's decoder) builds as JAX's: the
    cross leaves ``xq``/``xk``/``xv`` (with ``qkv_bias``), ``xo`` and
    ``xln``, the LoRA targets with the ``x*`` projections, and a cache with
    zero ``xk``/``xv`` of ``(batch, encoder_seq, kv, hd)``."""
    for over in ({}, dict(qkv_bias=True, post_block_norm=True)):
        cfg = get_config("whisper-large-v3").reduced(**over)
        jcfg = jax_get_config("whisper-large-v3").reduced(**over)
        block = BlockSpec(kind="gqa", cross_attn=True)
        jblock = JBlockSpec(kind="gqa", cross_attn=True)
        got = ta.gqa_init(torch.Generator().manual_seed(0), cfg, block)
        _same_layout(got, ja.gqa_init(jax.random.PRNGKey(0), jcfg, jblock))
        assert {"xq", "xk", "xv", "xo", "xln"} <= set(got)
        assert ("b" in got["xk"]) == cfg.qkv_bias and "b" not in got["xo"]
        cache = ta.gqa_init_cache(cfg, block, 3, 8, torch.float32)
        _same_layout(cache, ja.gqa_init_cache(jcfg, jblock, 3, 8,
                                              jnp.float32))
        assert cache["xk"].shape == (3, cfg.encoder_seq, cfg.n_kv_heads,
                                     cfg.head_dim)
        assert not any(t.any() for t in tree_leaves(cache))
    assert ta.gqa_lora_targets(block) == ja.gqa_lora_targets(jblock) == (
        "q", "k", "v", "o", "xq", "xk", "xv", "xo")


# ------------------------------------------------------------------- mlp --
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain"])
@pytest.mark.parametrize("post", [False, True])
def test_mlp_forward_matches_jax(act, post):
    cfg, jcfg = _cfgs(mlp_act=act, post_block_norm=post)
    rng = _rng(6)
    jp = _redraw(jm.mlp_init(jax.random.PRNGKey(0), jcfg), rng)
    _same_layout(tm.mlp_init(torch.Generator().manual_seed(0), cfg), jp)
    d, f = cfg.d_model, cfg.d_ff
    dims = {"fc1": (f, d), "fc2": (d, f), "gate": (f, d), "up": (f, d),
            "down": (d, f)}
    assert tm.mlp_lora_targets(cfg) == jm.mlp_lora_targets(jcfg)
    jl = _lora(jm.mlp_lora_targets(jcfg), dims, cfg, rng, 20)
    x = (rng.normal(size=(2, 9, d)) * 2).astype(np.float32)
    want = jm.mlp_forward(jp, jl, jnp.asarray(x), jcfg)
    got = tm.mlp_forward(port_tree(jp), port_tree(jl), _t(x), cfg)
    assert_close(got, want, F32_TOL, f"mlp {act}")
    no_lora = tm.mlp_forward(port_tree(jp), None, _t(x), cfg)
    assert_close(no_lora, jm.mlp_forward(jp, None, jnp.asarray(x), jcfg),
                 F32_TOL, f"mlp {act} without adapters")
    assert float((got - no_lora).abs().max()) > 1e-4


def test_config_overrides_keep_both_packages_equal():
    """The rigs above build both packages' configs from one override set."""
    for _, over, _, _ in GQA_CASES:
        cfg, jcfg = _cfgs(**over)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
