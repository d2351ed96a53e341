"""Each plain reference against the port's CPU path at tiny widths, fp32.
(The tests may import both; the references import neither.)"""
from __future__ import annotations

import pytest
import torch

from gpubench.lib import program, seeded, spec
from gpubench.reference import (compare, dense_lm, lm, mamba2, precision,
                                rbla)

DENSE = {"n_layers": 2, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 8, "d_ff": 48, "vocab_size": 64, "window": 6,
         "rope_theta": 1e4, "norm_eps": 1e-6, "dtype": "float32"}
MAMBA = {"n_layers": 2, "d_model": 16, "vocab_size": 40, "ssm_state": 8,
         "ssm_head_dim": 8, "ssm_chunk": 4, "dtype": "float32"}
CPU = torch.device("cpu")


def tiny(config_name, over, r_max=8):
    config = spec.load_config(config_name)
    arch = program.build_arch(config, over)
    cfg = {**config["arch"], **over, **config["lora"], "r_max": r_max}
    pstruct, astruct = program.structures(arch, r_max)
    gen = seeded.generator(1234, CPU)
    weights = seeded.model_weights(pstruct, gen, CPU)
    ad = seeded.fill(astruct, gen, seeded.lora_rule(1.0, 0.05), CPU)
    return arch, cfg, weights, ad, gen


def test_build_arch_matches_the_file():
    config = spec.load_config("h2o-danube-3-4b")
    arch = program.build_arch(config)
    assert arch.n_layers == 24 and arch.d_model == 3840
    assert arch.stages[0].unit[0].window == 0
    assert (arch.n_heads, arch.n_kv_heads, arch.head_dim, arch.d_ff) == \
        (32, 8, 120, 10240)
    assert (arch.rope_theta, arch.norm_eps) == (1e5, 1e-5)
    m = program.build_arch(spec.load_config("mamba2-1.3b"))
    assert (m.n_layers, m.d_model, m.ssm_state, m.vocab_size) == \
        (48, 2048, 128, 50288)
    assert m.norm_eps == 1e-5


def test_build_arch_keeps_the_stages_of_a_file_without_depth():
    """A configuration of several blocks a stage (gemma2's local and global
    layers) is a file alone: without ``n_layers`` the program's stages
    stand, and ``window`` reaches every attention block."""
    from repro_torch.configs import get_config
    base = get_config("gemma2-9b")
    arch = program.build_arch({"name": "gemma2-9b", "program_arch":
                               "gemma2-9b", "arch": {"d_model": 64,
                                                     "window": 8}})
    assert arch.d_model == 64 and arch.n_layers == base.n_layers
    assert [b.window for b in arch.stages[0].unit] == [8, 8]
    with pytest.raises(ValueError):
        program.build_arch({"name": "gemma2-9b", "program_arch":
                            "gemma2-9b", "arch": {"n_layers": 2}})


def test_eq7_matches_the_port():
    from repro_torch.core.strategy import get_strategy
    _, _, _, ad, gen = tiny("h2o-danube-3-4b", DENSE)
    _, astruct = program.structures(program.build_arch(
        spec.load_config("h2o-danube-3-4b"), DENSE), 8)
    ranks = [2, 8, 4, 2]
    ups = [seeded.set_rank(seeded.fill(astruct, gen, seeded.lora_rule(
        1.0, 0.05), CPU), r) for r in ranks]
    prev = seeded.set_rank(ad, 8)
    w = [rbla.staleness_weight(100.0 * (i + 1), i, 0.5) for i in range(4)]
    got = get_strategy("rbla").aggregate_adapters(
        ups, torch.tensor(w), r_max=8, client_ranks=torch.tensor(
            ranks, dtype=torch.int32), prev_global=prev, backend="ref")
    ref = rbla.eq7(prev, ups, w, ranks, 8, precision="fp64")
    gap, off = compare.tree_max_rel(rbla.pairs(got), ref)
    assert gap < 1e-6 and off == 0
    # rows no upload owns keep the previous global's (every rank < 8 here)
    low = rbla.eq7(prev, ups[:1], w[:1], ranks[:1], 8)
    path = next(iter(low))
    assert torch.equal(low[path]["A"][..., 2:, :].float(),
                       rbla.pairs(prev)[path]["A"][..., 2:, :])


def test_staleness_weight_matches_the_service():
    from repro_torch.core.strategy import ServerState
    from repro_torch.fl import AsyncAggregator
    svc = AsyncAggregator("rbla", ServerState(adapters=None,
                                              base_trainable={}),
                          staleness="polynomial", staleness_a=0.5)
    for tau in range(6):
        assert svc.staleness_weight(tau) * 270.0 == \
            rbla.staleness_weight(270.0, tau, 0.5)


def test_dense_lm_loss_and_gradient_match_the_port():
    from repro_torch.lora import attach_ranks, strip_ranks
    from repro_torch.models.model import make_model
    from repro_torch.tree import tree_leaves, tree_map
    arch, cfg, weights, ad, gen = tiny("h2o-danube-3-4b", DENSE)
    ad = seeded.set_rank(ad, 4)
    tokens = seeded.bigram_tokens(gen, 64, 2, 12, 0.9, CPU)
    factors, ranks = strip_ranks(ad)
    live = tree_map(lambda t: t.detach().requires_grad_(True), factors)
    model = make_model(arch, remat=False)
    loss = model.loss(weights, attach_ranks(live, ranks), {"tokens": tokens})
    grads = torch.autograd.grad(loss, tree_leaves(live))
    blk = ad["stages"][0]["b0"]
    ref_factors = {t: {"A": blk[t]["A"], "B": blk[t]["B"]} for t in blk}
    ref_loss, ref_grads = dense_lm.loss_and_grad(weights, ref_factors, 4,
                                                 tokens, cfg)
    assert abs(float(loss.detach()) - ref_loss) < 1e-5 * abs(ref_loss)
    got = dict(zip([(t, s) for t in sorted(blk) for s in ("A", "B")],
                   grads))
    for key, g in ref_grads.items():
        assert torch.allclose(got[key], g, rtol=1e-4, atol=1e-7), key


def test_mamba2_logits_match_the_port():
    from repro_torch.models.model import make_model
    arch, cfg, weights, ad, gen = tiny("mamba2-1.3b", MAMBA)
    ad = seeded.set_rank(ad, 8)
    tokens = seeded.bigram_tokens(gen, 40, 3, 16, 0.9, CPU)
    model = make_model(arch, remat=False, scan_backend="ref")
    with torch.inference_mode():
        got, _ = model.prefill(weights, ad, {"tokens": tokens})
    ref = mamba2.last_logits(weights, mamba2.adapter_pairs(ad), tokens,
                             cfg)
    assert compare.rel_l2(got, ref) < 1e-5


def test_dense_lm_logits_match_the_port():
    from repro_torch.models.model import make_model
    arch, cfg, weights, ad, gen = tiny("h2o-danube-3-4b", DENSE)
    ad = seeded.set_rank(ad, 8)
    tokens = seeded.bigram_tokens(gen, 64, 3, 12, 0.9, CPU)
    model = make_model(arch, remat=False)
    with torch.inference_mode():
        got, _ = model.prefill(weights, ad, {"tokens": tokens})
    ref = dense_lm.last_logits(weights, dense_lm.adapter_pairs(ad), tokens,
                               cfg)
    assert compare.rel_l2(got, ref) < 1e-5


def test_weight_rules_of_a_configuration_come_first():
    """A configuration whose model has a leaf no rule names gives the
    rule in its file (``weight_rules``)."""
    meta = torch.empty((3, 4, 5), device="meta")
    tree = {"router": {"w": meta}, "gate_scale": meta}
    with pytest.raises(ValueError):
        seeded.model_weights(tree, torch.Generator().manual_seed(1), CPU)
    got = seeded.model_weights(tree, torch.Generator().manual_seed(1), CPU,
                               {"gate_scale": ["const", 0.5],
                                "w": ["normal_fan_in"]})
    assert torch.equal(got["gate_scale"], torch.full((3, 4, 5), 0.5))
    assert abs(float(got["router"]["w"].std()) - 0.5) < 0.2


def test_references_name_their_modules_in_the_configs():
    for name in ("h2o-danube-3-4b", "mamba2-1.3b"):
        config = spec.load_config(name)
        ref = spec.load_reference(config)
        assert all(hasattr(ref, f) for f in ("adapter_pairs",
                                             "loss_and_grad", "last_logits"))
        assert spec.load_count(config, "train").step_flops
        assert spec.load_count(config, "prefill").prefill_flops


def test_no_tf32_inside_and_the_flags_restored():
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        with precision.no_tf32():
            assert not matmul.allow_tf32
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved


def test_mamba2_loss_and_gradient_match_the_port():
    from repro_torch.lora import attach_ranks, strip_ranks
    from repro_torch.models.model import make_model
    from repro_torch.tree import tree_leaves, tree_map
    arch, cfg, weights, ad, gen = tiny("mamba2-1.3b", MAMBA)
    ad = seeded.set_rank(ad, 4)
    tokens = seeded.bigram_tokens(gen, 40, 2, 16, 0.9, CPU)
    factors, ranks = strip_ranks(ad)
    live = tree_map(lambda t: t.detach().requires_grad_(True), factors)
    model = make_model(arch, remat="full", scan_backend="ref")
    loss = model.loss(weights, attach_ranks(live, ranks), {"tokens": tokens})
    grads = torch.autograd.grad(loss, tree_leaves(live))
    blk = ad["stages"][0]["b0"]
    ref_factors = {t: {"A": blk[t]["A"], "B": blk[t]["B"]} for t in blk}
    ref_loss, ref_grads = mamba2.loss_and_grad(weights, ref_factors, 4,
                                               tokens, cfg)
    assert abs(float(loss.detach()) - ref_loss) < 1e-5 * abs(ref_loss)
    got = dict(zip([(t, s) for t in sorted(blk) for s in ("A", "B")],
                   grads))
    for key, g in ref_grads.items():
        assert torch.allclose(got[key], g, rtol=1e-4, atol=1e-7), key


def test_chunked_ssd_matches_the_recurrence():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, 3, 4, generator=g, dtype=torch.float64)
    dta = -torch.rand(2, 12, 3, generator=g, dtype=torch.float64)
    b = torch.randn(2, 12, 5, generator=g, dtype=torch.float64)
    c = torch.randn(2, 12, 5, generator=g, dtype=torch.float64)
    y1, h1 = mamba2.ssd_sequential(x, dta, b, c)
    y2, h2 = mamba2.ssd(x, dta, b, c, 4)
    assert torch.allclose(y1, y2, atol=1e-10)
    assert torch.allclose(h1, h2, atol=1e-10)


@pytest.mark.parametrize("prec,bound", [("fp32", 1e-6), ("bf16", 2e-2),
                                        ("fp8", 2e-1)])
def test_precision_of_a_product(prec, bound):
    g = torch.Generator().manual_seed(9)
    x, w = torch.randn(16, 32, generator=g), torch.randn(32, 8, generator=g)
    exact = x.double() @ w.double()
    got = precision.mm(x, w, prec)
    err = compare.rel_l2(got, exact)
    assert err < bound
    if prec != "fp32":
        assert err > 1e-4


def test_adam_first_update_is_signed_lr():
    g = torch.tensor([3.0, -2.0, 0.0])
    u = lm.adam_first_update(g, 1e-3)
    assert torch.allclose(u, torch.tensor([-1e-3, 1e-3, 0.0]))


def test_norm_gaps_leave_out_leaves_nought_to_rounding():
    ref = {"a": torch.ones(4), "b": 2 * torch.ones(4),
           "c": torch.full((4,), 1e-9)}
    prog = {"a": torch.ones(4) * 1.1, "b": 2 * torch.ones(4),
            "c": torch.full((4,), 5e-9)}
    worst, used, skipped = compare.norm_gaps(prog, ref)
    assert (used, skipped) == (2, 1)
    assert abs(worst - 0.1) < 1e-6

