"""The port's Mamba2 serving slice against the JAX package on the CPU:
``models.common``, ``models.mamba.mamba_forward`` in its three modes, and
``models.model.Model`` (forward, prefill, decode_step) with two stacked
layers, nonzero LoRA B and per-layer ranks; the configs; and the port's own
prefill + decode = full forward invariant.

Parameters and adapters come from the JAX package's initialisers and are
carried across with ``repro_torch.bridge``; inputs are numpy from a seed.
Everything runs in fp32 (``reduced()`` configs) and is held at F32_TOL
(2e-5 of max|want|), the scans included: the two frameworks sum the SSD's
chunks in other orders, but over two layers that drift stays near 4e-6 of
the logits' largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_TOL, assert_close, port_tree

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import BlockSpec as JBlockSpec
from repro.configs import Stage as JStage
from repro.configs import get_config as jax_get_config
from repro.lora import init_pair as jax_init_pair
from repro.models import common as jc
from repro.models import mamba as jm
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import ARCHS, NOT_PORTED, BlockSpec, Stage, get_config
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models import common as tc
from repro_torch.models import mamba as tm
from repro_torch.models import transformer as tt
from repro_torch.models.model import Model, make_model
from repro_torch.tree import tree_leaves

ARCH = "mamba2-1.3b"


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_cfg(layers=1):
    cfg = jax_get_config(ARCH).reduced()
    if layers != 1:
        cfg = cfg.reduced(stages=(JStage(
            unit=(JBlockSpec(kind="mamba", ffn="none"),), repeat=layers),))
    return cfg


def _port_cfg(layers=1):
    cfg = get_config(ARCH).reduced()
    if layers != 1:
        cfg = cfg.reduced(stages=(Stage(
            unit=(BlockSpec(kind="mamba", ffn="none"),), repeat=layers),))
    return cfg


def _live_b(pair, rng):
    """A JAX LoRA pair with B drawn nonzero on its live columns."""
    b = np.asarray(pair["B"])
    r_max = b.shape[-1]
    rank = np.asarray(pair["rank"])
    live = (np.arange(r_max) < rank[..., None, None]).astype(np.float32)
    nb = (rng.normal(size=b.shape) * 0.05).astype(np.float32) * live
    return dict(pair, B=jnp.asarray(nb, b.dtype))


# ---------------------------------------------------------------- configs --
def test_config_equals_the_jax_config_field_by_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(jax_get_config(ARCH).reduced())
    assert dataclasses.asdict(_port_cfg(2)) == dataclasses.asdict(_jax_cfg(2))
    assert set(ARCHS) | set(NOT_PORTED) == set(JAX_ARCHS)


#: the JAX package's nine other archs, fixed so that each keeps its test
#: as the port's configs arrive
OTHER_ARCHS = ("chatglm3-6b", "deepseek-v3-671b", "gemma2-9b",
               "granite-moe-3b-a800m", "h2o-danube-3-4b",
               "jamba-1.5-large-398b", "phi-3-vision-4.2b",
               "whisper-large-v3", "yi-34b")


@pytest.mark.parametrize("name", OTHER_ARCHS)
def test_other_archs_raise_not_implemented(name):
    """Every other arch of the JAX package is ported (the front-end archs
    with item 19b-iii): its config equals JAX's field by field, full and
    reduced."""
    assert name in ARCHS and name not in NOT_PORTED
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_get_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == \
        dataclasses.asdict(jax_get_config(name).reduced())


def test_not_ported_holds_the_five_archs_still_missing():
    """Of the five archs that waited for item 19b, the three MoE archs came
    with 19b-ii and the two front-end archs with 19b-iii: none is left, and
    the port registers the JAX package's ten."""
    assert NOT_PORTED == ()
    assert sorted(ARCHS) == sorted(JAX_ARCHS) == sorted(OTHER_ARCHS
                                                        + (ARCH,))
    assert {"phi-3-vision-4.2b", "whisper-large-v3"} <= set(ARCHS)


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _shapes(tree, path=""):
    """{path: shape} of a port or JAX tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    return {path: tuple(tree.shape)}


def test_unported_blocks_raise():
    """MLA blocks and MoE feed-forwards (item 19b-ii) build and run, their
    parameters, LoRA specs and caches laid out as JAX's; cross-attention
    still waits for item 19b."""
    from repro.models import transformer as jt
    gen = torch.Generator().manual_seed(0)
    for arch, kw in (("deepseek-v3-671b", dict(kind="mla", ffn="none")),
                     ("deepseek-v3-671b", dict(kind="mla", ffn="dense")),
                     ("jamba-1.5-large-398b", dict(kind="mamba", ffn="moe")),
                     ("granite-moe-3b-a800m", dict(kind="gqa", ffn="moe"))):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        spec, jspec = BlockSpec(**kw), JBlockSpec(**kw)
        assert tt.block_lora_specs(cfg, spec) == jt.block_lora_specs(jcfg,
                                                                     jspec)
        bp = tt.block_init(gen, cfg, spec)
        assert _shapes(bp) == _shapes(jt.block_init(jax.random.PRNGKey(0),
                                                    jcfg, jspec))
        cache = tt.block_init_cache(cfg, spec, 1, 8, torch.float32)
        assert _shapes(cache) == _shapes(jt.block_init_cache(
            jcfg, jspec, 1, 8, jnp.float32))
        x = torch.randn((1, 8, cfg.d_model), generator=gen)
        y, c = tt.block_forward(bp, None, x, cfg, spec, mode="prefill",
                                capacity=8)
        assert y.shape == x.shape and torch.isfinite(y).all()
        assert _shapes(c) == _shapes(cache)
    # cross-attention (item 19b-iii): a GQA block gains its cross leaves; a
    # mamba block ignores the flag, as the reference's does
    for arch, kw in (("whisper-large-v3", dict(kind="gqa", ffn="dense",
                                               cross_attn=True)),
                     (ARCH, dict(kind="mamba", ffn="none",
                                 cross_attn=True))):
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        spec, jspec = BlockSpec(**kw), JBlockSpec(**kw)
        assert tt.block_lora_specs(cfg, spec) == jt.block_lora_specs(jcfg,
                                                                     jspec)
        bp = tt.block_init(gen, cfg, spec)
        assert _shapes(bp) == _shapes(jt.block_init(jax.random.PRNGKey(0),
                                                    jcfg, jspec))
        cache = tt.block_init_cache(cfg, spec, 1, 8, torch.float32)
        assert _shapes(cache) == _shapes(jt.block_init_cache(
            jcfg, jspec, 1, 8, jnp.float32))
        x = torch.randn((1, 8, cfg.d_model), generator=gen)
        enc = torch.randn((1, cfg.encoder_seq or 4, cfg.d_model),
                          generator=gen)
        y, c = tt.block_forward(bp, None, x, cfg, spec, mode="prefill",
                                capacity=8, enc_out=enc)
        assert y.shape == x.shape and torch.isfinite(y).all()
        assert _shapes(c) == _shapes(cache)
    assert "mix/xq" in tt.block_lora_specs(
        get_config("whisper-large-v3").reduced(),
        BlockSpec(kind="gqa", cross_attn=True))


def test_model_loss_waits_for_training():
    """Model.loss runs (tests/test_torch_dense_zoo.py); multi-token
    prediction, its extra term, builds with item 19b-ii and equals JAX's
    (a mamba MTP block here; deepseek's MLA + MoE one in
    tests/test_torch_mla_zoo.py); the encoder-decoder and the vision
    front-end build with item 19b-iii, their loss equal to JAX's."""
    jcfg = dataclasses.replace(_jax_cfg(), mtp_depth=1)
    cfg = dataclasses.replace(_port_cfg(), mtp_depth=1)
    jmodel = jax_make_model(jcfg, remat=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    ja = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
    tokens = _rng(5).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want = jmodel.loss(jp, ja, {"tokens": jnp.asarray(tokens)})
    model = make_model(cfg)
    p, a = port_tree(jp), port_tree(ja)
    assert set(p["mtp"]) == {"proj", "block", "ln"}
    got = model.loss(p, a, {"tokens": torch.from_numpy(tokens)})
    assert_close(got.detach(), np.float32(want), F32_TOL, "loss with MTP")
    assert float(model._mtp_loss(p, a, {"tokens": torch.from_numpy(
        tokens)}, None)) > 0.0
    for arch in ("whisper-large-v3", "phi-3-vision-4.2b"):
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        jmodel, model = jax_make_model(jcfg, remat=False), make_model(cfg)
        jp = jmodel.init(jax.random.PRNGKey(0))
        ja = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
        rng = _rng(6)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
            np.int32)}
        if cfg.is_encdec:
            batch["frames"] = rng.normal(size=(2, cfg.encoder_seq,
                                               cfg.frontend_dim))
        else:
            batch["patches"] = rng.normal(size=(2, cfg.n_prefix_tokens,
                                                cfg.frontend_dim))
        batch = {k: v.astype(np.float32) if k != "tokens" else v
                 for k, v in batch.items()}
        want = jmodel.loss(jp, ja, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        got = model.loss(port_tree(jp), port_tree(ja),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_close(got.detach(), np.float32(want), F32_TOL, f"{arch} loss")


# ----------------------------------------------------------------- common --
def test_dtype_of():
    assert tc.dtype_of(get_config(ARCH)) == torch.bfloat16
    assert tc.dtype_of(_port_cfg()) == torch.float32


@pytest.mark.parametrize("with_lora,bias", [(False, False), (True, False),
                                            (True, True)])
def test_dense_matches_jax(with_lora, bias):
    rng = _rng(3)
    p = {"w": rng.normal(size=(24, 40)).astype(np.float32) / 5}
    if bias:
        p["b"] = rng.normal(size=(40,)).astype(np.float32)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    pair = None
    if with_lora:
        pair = _live_b(jax_init_pair(jax.random.PRNGKey(0), 40, 24, 8, 5),
                       rng)
        assert np.abs(np.asarray(pair["B"])).max() > 0
    want = jc.dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x), pair, 16.0)
    got = tc.dense(port_tree(p), torch.from_numpy(x),
                   None if pair is None else port_tree(pair), 16.0)
    assert_close(got, want, F32_TOL, "dense")


def test_dense_init_layout_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = tc.dense_init(gen, 256, 64, torch.float32, bias=True)
    assert p["w"].shape == (256, 64) and p["b"].shape == (64,)
    assert abs(float(p["w"].std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert not p["b"].any()
    bf = tc.dense_init(gen, 16, 8, torch.bfloat16, scale=0.5)
    assert bf["w"].dtype == torch.bfloat16 and "b" not in bf


@pytest.mark.parametrize("layer", [False, True])
def test_norm_matches_jax_on_both_branches(layer):
    rng = _rng(4)
    x = (rng.normal(size=(3, 7, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(32,)).astype(np.float32)}
    if layer:
        p["bias"] = rng.normal(size=(32,)).astype(np.float32)
    want = jc.norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-6)
    got = tc.norm(port_tree(p), torch.from_numpy(x), 1e-6)
    assert_close(got, want, F32_TOL, "norm")
    if not layer:
        assert_close(tc.rmsnorm(port_tree(p), torch.from_numpy(x)),
                     jc.rmsnorm(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x)), F32_TOL, "rmsnorm")


def test_norm_inits_match_jax():
    cfg, jcfg = _port_cfg(), _jax_cfg()
    for got, want in ((tc.rmsnorm_init(12), jc.rmsnorm_init(12)),
                      (tc.layernorm_init(12), jc.layernorm_init(12)),
                      (tc.norm_init(cfg), jc.norm_init(jcfg)),
                      (tc.norm_init(dataclasses.replace(cfg,
                                                        mlp_act="gelu_plain"),
                                    16),
                       jc.norm_init(dataclasses.replace(jcfg,
                                                        mlp_act="gelu_plain"),
                                    16))):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            assert_close(got[k], want[k], 0.0, k)


def test_softcap_embed_unembed_match_jax():
    rng = _rng(5)
    x = (rng.normal(size=(4, 9)) * 40).astype(np.float32)
    assert_close(tc.softcap(torch.from_numpy(x), 30.0),
                 jc.softcap(jnp.asarray(x), 30.0), F32_TOL, "softcap")
    assert torch.equal(tc.softcap(torch.from_numpy(x), 0.0),
                       torch.from_numpy(x))
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 6))
    assert_close(tc.embed({"table": torch.from_numpy(table)},
                          torch.from_numpy(ids)),
                 jc.embed({"table": jnp.asarray(table)}, jnp.asarray(ids)),
                 0.0, "embed")
    h = rng.normal(size=(3, 6, 16)).astype(np.float32)
    assert_close(tc.unembed({"table": torch.from_numpy(table)},
                            torch.from_numpy(h)),
                 jc.unembed({"table": jnp.asarray(table)}, jnp.asarray(h)),
                 F32_TOL, "unembed")
    e = tc.embed_init(torch.Generator().manual_seed(0), 50, 16,
                      torch.float32)["table"]
    assert e.shape == (50, 16) and float(e.std()) < 0.05


# ------------------------------------------------------------------ mamba --
def _mamba_rig(seed=0):
    cfg, jcfg = _port_cfg(), _jax_cfg()
    jp = jm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    # nontrivial A, D and dt_bias (the init's are constants)
    rng = _rng(seed)
    h = jp["A_log"].shape[0]
    jp = dict(jp, A_log=jnp.asarray(rng.normal(size=h) * 0.5, jnp.float32),
              D=jnp.asarray(rng.normal(size=h), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(size=h) * 0.5, jnp.float32))
    specs = tt.block_lora_specs(cfg, BlockSpec(kind="mamba", ffn="none"))
    jl = {}
    for i, (path, (fo, fi, _)) in enumerate(sorted(specs.items())):
        pair = jax_init_pair(jax.random.PRNGKey(10 + i), fo, fi,
                             cfg.lora_r_max, 3 + i)
        jl[path.split("/")[1]] = _live_b(pair, rng)
    return cfg, jcfg, jp, jl


@pytest.mark.parametrize("mode", ["full", "prefill"])
def test_mamba_forward_matches_jax(mode):
    cfg, jcfg, jp, jl = _mamba_rig()
    x = _rng(1).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    want, wcache = jm.mamba_forward(jp, jl, jnp.asarray(x), jcfg, mode=mode)
    got, gcache = tm.mamba_forward(port_tree(jp), port_tree(jl),
                                   torch.from_numpy(x), cfg, mode=mode)
    assert_close(got, want, F32_TOL, "y")
    if mode == "full":
        assert gcache is None and wcache is None
    else:
        assert_close(gcache["conv"], wcache["conv"], F32_TOL, "conv cache")
        assert_close(gcache["ssm"], wcache["ssm"], F32_TOL, "ssm cache")


def test_mamba_decode_matches_jax():
    cfg, jcfg, jp, jl = _mamba_rig(2)
    rng = _rng(2)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    _, jcache = jm.mamba_forward(jp, jl, jnp.asarray(x), jcfg, mode="prefill")
    cache = port_tree(jcache)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want, wnew = jm.mamba_forward(jp, jl, jnp.asarray(x1), jcfg,
                                  mode="decode", cache=jcache)
    got, gnew = tm.mamba_forward(port_tree(jp), port_tree(jl),
                                 torch.from_numpy(x1), cfg, mode="decode",
                                 cache=cache)
    assert_close(got, want, F32_TOL, "y")
    assert_close(gnew["conv"], wnew["conv"], F32_TOL, "conv cache")
    assert_close(gnew["ssm"], wnew["ssm"], F32_TOL, "ssm cache")


def test_mamba_scan_backends_agree_on_the_cpu():
    """``auto`` reaches ssd_scan (its plain version on the CPU) and ``ref``
    calls the plain version directly: one plain call each, no launch."""
    cfg, _, jp, jl = _mamba_rig()
    p, lora = port_tree(jp), port_tree(jl)
    x = torch.from_numpy(_rng(3).normal(size=(1, 32, cfg.d_model)).astype(
        np.float32))
    runtime.reset_counts()
    a, _ = tm.mamba_forward(p, lora, x, cfg, mode="full")
    b, _ = tm.mamba_forward(p, lora, x, cfg, mode="full", scan_backend="ref")
    assert torch.equal(a, b)
    assert runtime.PLAIN_CALLS["ssd_scan"] == 2
    assert runtime.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tm.mamba_forward(p, lora, x, cfg, mode="full", scan_backend="kernel")


def test_mamba_ref_backend_calls_the_given_plain_scan():
    """``scan_backend="ref"`` calls ``plain_scan`` with the scan's
    operands; an oracle passed in stands in for ssd_scan_ref."""
    cfg, _, jp, jl = _mamba_rig()
    p, lora = port_tree(jp), port_tree(jl)
    x = torch.from_numpy(_rng(4).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32))
    seen = []

    def oracle(xdt, dta, bm, cm, chunk):
        seen.append((tuple(xdt.shape), tuple(dta.shape), tuple(bm.shape),
                     tuple(cm.shape), chunk))
        y, h_last = ssd_scan_ref(xdt.double(), dta.double(), bm.double(),
                                 cm.double(), chunk)
        return y.to(xdt.dtype), h_last.to(xdt.dtype)
    got, _ = tm.mamba_forward(p, lora, x, cfg, mode="full",
                              scan_backend="ref", plain_scan=oracle)
    want, _ = tm.mamba_forward(p, lora, x, cfg, mode="full",
                               scan_backend="ref")
    _, h, n, pd = tm._dims(cfg)
    assert seen == [((2, 16, h, pd), (2, 16, h), (2, 16, n), (2, 16, n),
                     cfg.ssm_chunk)]
    assert_close(got, want, F32_TOL, "y with a float64 oracle")


def test_mamba_init_matches_jax_layout():
    cfg, jcfg = _port_cfg(), _jax_cfg()
    got = tm.mamba_init(torch.Generator().manual_seed(0), cfg)
    want = jm.mamba_init(jax.random.PRNGKey(0), jcfg)
    _same_layout(got, want)
    cache = tm.mamba_init_cache(cfg, 3, torch.float32)
    wcache = jm.mamba_init_cache(jcfg, 3, jnp.float32)
    _same_layout(cache, wcache)
    assert not any(t.any() for t in tree_leaves(cache))


def _same_layout(got, want):
    """Same keys, shapes and dtypes leaf for leaf."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(tree_leaves(got)) == len(flat_w)
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


# ------------------------------------------------------------------ model --
def _model_rig(layers=2, seq=40, batch=2):
    """Two stacked layers, JAX params and adapters with nonzero B and
    per-layer ranks, bridged to the port."""
    jcfg, cfg = _jax_cfg(layers), _port_cfg(layers)
    jmodel = jax_make_model(jcfg, remat=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    ja = jmodel.init_adapters(jax.random.PRNGKey(1), rank=4)
    rng = _rng(7)
    ranks = jnp.asarray(np.arange(layers) * 3 + 2, jnp.int32)

    def relive(pair):
        return _live_b(dict(pair, rank=ranks), rng)
    ja = {"stages": tuple({b: {k: relive(v) for k, v in unit.items()}
                           for b, unit in st.items()} for st in ja["stages"])}
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq))
    return (jcfg, jmodel, jp, ja, cfg, make_model(cfg, remat=False),
            port_tree(jp), port_tree(ja), tokens)


def test_model_init_and_adapters_match_jax_layout():
    jcfg, jmodel, jp, ja, cfg, model, _, _, _ = _model_rig()
    gen = torch.Generator().manual_seed(0)
    _same_layout(model.init(gen), jp)
    _same_layout(model.init_adapters(gen, rank=4),
                 jmodel.init_adapters(jax.random.PRNGKey(1), rank=4))
    _same_layout(model.init_cache(2, device="cpu"),
                 jmodel.init_cache(2, 16))
    ad = model.init_adapters(gen, rank=4)
    pair = ad["stages"][0]["b0"]["mix/in_proj"]
    assert pair["rank"].tolist() == [4, 4]
    assert not pair["B"].any() and not pair["A"][:, 4:].any()


def test_model_forward_matches_jax_with_two_layers():
    jcfg, jmodel, jp, ja, cfg, model, p, a, tokens = _model_rig()
    want, _ = jmodel.forward(jp, ja, {"tokens": jnp.asarray(tokens)})
    got, caches = model.forward(p, a, {"tokens": torch.from_numpy(tokens)})
    assert caches is None
    assert got.shape == (2, 40, cfg.vocab_size)
    assert_close(got, want, F32_TOL, "logits")


def test_model_prefill_and_decode_match_jax_with_two_layers():
    jcfg, jmodel, jp, ja, cfg, model, p, a, tokens = _model_rig()
    pre = 32
    want, jcaches = jmodel.prefill(jp, ja, {"tokens": jnp.asarray(
        tokens[:, :pre])})
    got, caches = model.prefill(p, a, {"tokens": torch.from_numpy(
        tokens[:, :pre])})
    assert_close(got, want, F32_TOL, "prefill logits")
    unit = caches[0]["b0"]
    assert unit["ssm"].shape[0] == 2 and unit["conv"].shape[0] == 2
    assert_close(unit["ssm"], jcaches[0]["b0"]["ssm"], F32_TOL, "ssm cache")
    assert_close(unit["conv"], jcaches[0]["b0"]["conv"], F32_TOL,
                 "conv cache")
    for t in range(pre, tokens.shape[1]):
        want, jcaches = jmodel.decode_step(
            jp, ja, jcaches, jnp.asarray(tokens[:, t]),
            jnp.asarray(t, jnp.int32))
        got, caches = model.decode_step(p, a, caches,
                                        torch.from_numpy(tokens[:, t]), t)
        assert_close(got, want, F32_TOL, f"decode logits at {t}")
    assert_close(caches[0]["b0"]["ssm"], jcaches[0]["b0"]["ssm"], F32_TOL,
                 "ssm cache after decode")


def test_lora_changes_the_logits():
    """The adapters' B is live: dropping the adapters moves the logits."""
    _, _, _, _, _, model, p, a, tokens = _model_rig(seq=16)
    batch = {"tokens": torch.from_numpy(tokens)}
    with_lora, _ = model.forward(p, a, batch)
    without, _ = model.forward(p, None, batch)
    assert float((with_lora - without).abs().max()) > 1e-4


def test_prefill_then_decode_matches_full_forward():
    """The serve invariant in the port alone (tests/test_serve_consistency.py
    for the JAX package): prefill P tokens, decode k, and each decoded
    position's logits equal the full forward's there."""
    _, _, _, _, cfg, model, p, a, tokens = _model_rig(seq=32)
    pre = 24
    full, _ = model.forward(p, a, {"tokens": torch.from_numpy(tokens)})
    last, caches = model.prefill(p, a, {"tokens": torch.from_numpy(
        tokens[:, :pre])})
    assert_close(last, full[:, pre - 1], F32_TOL, "prefill")
    for t in range(pre, tokens.shape[1]):
        logits, caches = model.decode_step(p, a, caches,
                                           torch.from_numpy(tokens[:, t]), t)
        assert_close(logits, full[:, t], F32_TOL, f"decode at {t}")


def test_decode_from_an_empty_cache_matches_full_forward():
    """init_cache's zero state is the start of a sequence."""
    _, _, _, _, cfg, model, p, a, tokens = _model_rig(seq=6)
    full, _ = model.forward(p, a, {"tokens": torch.from_numpy(tokens)})
    caches = model.init_cache(2, device="cpu")
    for t in range(tokens.shape[1]):
        logits, caches = model.decode_step(p, a, caches,
                                           torch.from_numpy(tokens[:, t]), t)
        assert_close(logits, full[:, t], F32_TOL, f"decode at {t}")


def test_model_on_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(_port_cfg()).init_cache(1)


def test_stage_params_stack_over_repeats():
    cfg = _port_cfg(3)
    p = Model(cfg).init(torch.Generator().manual_seed(0))
    w = p["stages"][0]["b0"]["mix"]["in_proj"]["w"]
    assert w.shape[0] == 3
    assert not torch.equal(w[0], w[1])
    assert all(t.shape[0] == 3 for t in tree_leaves(p["stages"][0]))
