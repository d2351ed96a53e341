"""Blocks and stages of the big-model zoo, on tensor dicts.

A stage's parameters (and adapters, and caches) are stacked over its
repeats: every leaf has a leading ``repeat`` axis, the JAX package's
layout, so ``repro_torch.bridge`` carries them leaf for leaf.  Where the
JAX package scans over that axis, :func:`stage_forward` loops: repeat ``i``
indexes layer ``i`` of every stacked leaf, and the new caches are stacked
again.  A block's mixer is GQA attention (``kind="gqa"``), DeepSeek's
latent attention (``"mla"``; ``mla_absorbed`` picks its absorbed decode)
or the Mamba2 mixer (``"mamba"``); its feed-forward is the dense MLP
(``ffn="dense"``), the MoE (``"moe"``: the sort path, or with
``cfg.moe_mode="ep_a2a"`` the expert-parallel all-to-all of
:mod:`.moe_ep`) or none.  A GQA block with ``cross_attn`` attends to
``enc_out``, the encoder's output, which :func:`stage_forward` hands to
every block (a mamba or MLA block ignores the flag, as the reference's
does).

``remat`` is the reference's activation checkpointing: in full mode, while
autograd records, each repeat of a stage runs under
``torch.utils.checkpoint.checkpoint`` (``use_reentrant=False``) with the
policy of :data:`REMAT_POLICIES` -- "full" (or ``True``) saves nothing
inside the repeat and recomputes its forward in the backward (JAX's
``nothing_saveable``); "dots" saves the outputs of the matmuls without a
batch dimension (``aten.mm``, ``aten.addmm``: the projections) and
recomputes the rest, the batched ones (``bmm``: attention's scores)
included (JAX's ``dots_with_no_batch_dims_saveable``).  It runs alike on
whole tensors and on DTensors, through the ``local_map`` regions.
"""
from __future__ import annotations

import functools
from typing import Any, Mapping

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.lora import init_pair
from repro_torch.tree import tree_map

from .common import settle
from .attention import (MLA_LORA_TARGETS, gqa_forward, gqa_init,
                        gqa_init_cache, gqa_lora_targets, mla_forward,
                        mla_init, mla_init_cache)
from .mamba import (MAMBA_LORA_TARGETS, mamba_forward, mamba_init,
                    mamba_init_cache)
from .mlp import mlp_forward, mlp_init, mlp_lora_targets
from .moe import MOE_LORA_TARGETS, moe_forward, moe_init
from .moe_ep import moe_forward_ep_wrapped

PyTree = Any


# ============================================================ block level ====
def block_init(gen: torch.Generator, cfg, spec) -> dict:
    if spec.kind == "mamba":
        p = {"mix": mamba_init(gen, cfg)}
    elif spec.kind == "mla":
        p = {"mix": mla_init(gen, cfg, spec)}
    else:
        p = {"mix": gqa_init(gen, cfg, spec)}
    if spec.ffn == "dense":
        p["ffn"] = mlp_init(gen, cfg)
    elif spec.ffn == "moe":
        p["ffn"] = moe_init(gen, cfg)
    return p


def block_forward(bp, blora, x, cfg, spec, *, mode, positions=None,
                  cache=None, pos=None, enc_out=None, alpha=16.0,
                  scan_backend="auto", mla_absorbed=False, capacity=None):
    blora = blora or {}
    x = settle(x)
    if spec.kind == "mamba":
        y, c = mamba_forward(bp["mix"], blora.get("mix"), x, cfg, mode=mode,
                             cache=cache, pos=pos, alpha=alpha,
                             scan_backend=scan_backend)
    elif spec.kind == "mla":
        y, c = mla_forward(bp["mix"], blora.get("mix"), x, cfg, spec,
                           mode=mode, positions=positions, cache=cache,
                           pos=pos, alpha=alpha, absorbed=mla_absorbed,
                           capacity=capacity)
    else:
        y, c = gqa_forward(bp["mix"], blora.get("mix"), x, cfg, spec,
                           mode=mode, positions=positions, cache=cache,
                           pos=pos, enc_out=enc_out, alpha=alpha,
                           capacity=capacity)
    x = settle(x + y)
    if spec.ffn == "dense":
        x = x + mlp_forward(bp["ffn"], blora.get("ffn"), x, cfg, alpha)
    elif spec.ffn == "moe":
        moe = (moe_forward_ep_wrapped if cfg.moe_mode == "ep_a2a"
               else moe_forward)
        x = x + moe(bp["ffn"], blora.get("ffn"), x, cfg, alpha)
    return settle(x), c


def block_init_cache(cfg, spec, batch: int, seq_len: int | None, dtype,
                     device=None) -> dict:
    """One block's zero decode state; an attention block's KV cache has
    ``seq_len`` slots (``min(window, seq_len)`` for an SWA layer); a
    cross-attention block's also ``xk``/``xv`` of ``cfg.encoder_seq``."""
    if spec.kind == "mamba":
        return mamba_init_cache(cfg, batch, dtype, device)
    if seq_len is None:
        raise ValueError("an attention block's KV cache needs seq_len")
    if spec.kind == "mla":
        return mla_init_cache(cfg, spec, batch, seq_len, dtype, device)
    return gqa_init_cache(cfg, spec, batch, seq_len, dtype, device)


def block_lora_specs(cfg, spec) -> dict[str, tuple]:
    """{relpath: (fan_out, fan_in, extra_leading)} for one block."""
    d = cfg.d_model
    out: dict[str, tuple] = {}
    if spec.kind == "mamba":
        d_in = cfg.ssm_expand * d
        h = d_in // cfg.ssm_head_dim
        n = cfg.ssm_state
        dims = {"in_proj": (2 * d_in + 2 * n + h, d), "out_proj": (d, d_in)}
        for t in MAMBA_LORA_TARGETS:
            out[f"mix/{t}"] = dims[t] + ((),)
    elif spec.kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        dims = {
            "q_a": (cfg.q_lora_rank, d),
            "q_b": (cfg.n_heads * qk, cfg.q_lora_rank),
            "kv_a": (cfg.kv_lora_rank + cfg.qk_rope_dim, d),
            "kv_b": (cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                     cfg.kv_lora_rank),
            "o": (d, cfg.n_heads * cfg.v_head_dim),
        }
        for t in MLA_LORA_TARGETS:
            out[f"mix/{t}"] = dims[t] + ((),)
    else:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dims = {"q": (h * hd, d), "k": (kv * hd, d), "v": (kv * hd, d),
                "o": (d, h * hd), "xq": (h * hd, d), "xk": (kv * hd, d),
                "xv": (kv * hd, d), "xo": (d, h * hd)}
        for t in gqa_lora_targets(spec):
            out[f"mix/{t}"] = dims[t] + ((),)
    if spec.ffn == "dense":
        f = cfg.d_ff
        dims = {"fc1": (f, d), "fc2": (d, f), "gate": (f, d), "up": (f, d),
                "down": (d, f)}
        for t in mlp_lora_targets(cfg):
            out[f"ffn/{t}"] = dims[t] + ((),)
    elif spec.ffn == "moe":
        # per-expert pairs carry the expert axis: A (E, r, in), B (E, out, r)
        f = cfg.moe_d_ff or cfg.d_ff
        e = cfg.n_experts + cfg.moe_pad_experts
        for t in MOE_LORA_TARGETS:
            fo, fi = (d, f) if t.endswith("down") else (f, d)
            out[f"ffn/{t}"] = (fo, fi, (e,))
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            out["ffn/shared/gate"] = (fs, d, ())
            out["ffn/shared/up"] = (fs, d, ())
            out["ffn/shared/down"] = (d, fs, ())
    return out


def _get_lora(blora: Mapping | None, prefix: str):
    """Project 'mix/q'-style flat keys into the sub-dict for one module."""
    if not blora:
        return None
    sub = {}
    for k, v in blora.items():
        if k.startswith(prefix + "/"):
            sub[k[len(prefix) + 1:]] = v
    return sub or None


# ============================================================ stage level ====
def stage_init(gen: torch.Generator, cfg, stage) -> dict:
    """The stage's unit, initialised ``stage.repeat`` times and stacked
    leaf by leaf."""
    units = [{f"b{i}": block_init(gen, cfg, spec)
              for i, spec in enumerate(stage.unit)}
             for _ in range(stage.repeat)]
    return tree_map(lambda *leaves: torch.stack(leaves), *units)


def stage_lora_init(gen: torch.Generator, cfg, stage, r_max: int,
                    rank) -> dict:
    out = {}
    for i, spec in enumerate(stage.unit):
        specs = block_lora_specs(cfg, spec)
        out[f"b{i}"] = {
            path: init_pair(gen, fo, fi, r_max, rank,
                            leading=(stage.repeat,) + extra)
            for path, (fo, fi, extra) in sorted(specs.items())}
    return out


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


#: the matmuls without a batch dimension, whose outputs "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: checkpoint policy name -> the ``context_fn`` of
#: ``torch.utils.checkpoint.checkpoint`` (None: save nothing)
REMAT_POLICIES = {
    "full": lambda: None,
    "dots": lambda: functools.partial(create_selective_checkpoint_contexts,
                                      _dots_policy),
}


def stage_forward(sp, slora, x, cfg, stage, *, mode, positions=None,
                  caches=None, pos=None, enc_out=None, alpha=16.0,
                  remat=False, scan_backend="auto", mla_absorbed=False,
                  capacity=None):
    """Loop over the stage's repeats. Returns (x, new_caches or None), the
    caches stacked over the repeats; ``enc_out`` goes to every block.

    ``remat``: False | True ("full") | "full" | "dots" -- the checkpoint
    policy of each repeat in full mode while autograd records (an unknown
    name raises ``KeyError``, as the reference's lookup does)."""

    def unit(x, r):
        bp_unit = _layer(sp, r)
        bl_unit = _layer(slora, r) if slora is not None else None
        cache_unit = _layer(caches, r) if caches is not None else None
        new_caches = {}
        for i, spec in enumerate(stage.unit):
            bl = None
            if bl_unit is not None:
                flat = bl_unit.get(f"b{i}")
                bl = {"mix": _get_lora(flat, "mix"),
                      "ffn": _get_lora(flat, "ffn")} if flat else None
            c = cache_unit[f"b{i}"] if cache_unit is not None else None
            x, cnew = block_forward(
                bp_unit[f"b{i}"], bl, x, cfg, spec, mode=mode,
                positions=positions, cache=c, pos=pos, enc_out=enc_out,
                alpha=alpha, scan_backend=scan_backend, mla_absorbed=mla_absorbed,
                capacity=capacity)
            if cnew is not None:
                new_caches[f"b{i}"] = cnew
        return x, new_caches or None

    if remat and mode == "full":
        context = REMAT_POLICIES["full" if remat is True else remat]()
        if torch.is_grad_enabled():
            kw = {} if context is None else {"context_fn": context}
            plain = unit

            def unit(x, r):
                return checkpoint(plain, x, r, use_reentrant=False, **kw)
    per_layer = []
    for r in range(stage.repeat):
        x, new_caches = unit(x, r)
        per_layer.append(new_caches)
    if per_layer[0] is None:
        return x, None
    return x, tree_map(lambda *leaves: torch.stack(leaves), *per_layer)
