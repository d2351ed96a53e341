"""Blocks and stages of the big-model zoo, on tensor dicts.

A stage's parameters (and adapters, and caches) are stacked over its
repeats: every leaf has a leading ``repeat`` axis, the JAX package's
layout, so ``repro_torch.bridge`` carries them leaf for leaf.  Where the
JAX package scans over that axis, :func:`stage_forward` loops: repeat ``i``
indexes layer ``i`` of every stacked leaf, and the new caches are stacked
again.  The port has the mamba mixer without a feed-forward
(``kind="mamba"``, ``ffn="none"``); attention (gqa, mla, cross-attention)
and the dense and MoE feed-forwards wait for ROADMAP item 19b and raise
``NotImplementedError``.  Forward only: ``remat`` is accepted and does
nothing.  The reference's ``positions``, ``enc_out``, ``mla_absorbed`` and
``capacity`` (rope, cross-attention, MLA and MoE) and the cache's
``seq_len`` (a KV cache's length) return with the code that reads them.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.lora import init_pair
from repro_torch.tree import tree_map

from .mamba import (MAMBA_LORA_TARGETS, mamba_forward, mamba_init,
                    mamba_init_cache)

PyTree = Any


def _check_spec(spec) -> None:
    if spec.kind != "mamba":
        raise NotImplementedError(
            f"block kind {spec.kind!r} (attention) is not ported yet: it "
            "arrives with ROADMAP item 19b")
    if spec.ffn != "none":
        raise NotImplementedError(
            f"ffn {spec.ffn!r} is not ported yet: dense and MoE "
            "feed-forwards arrive with ROADMAP item 19b")
    if spec.cross_attn:
        raise NotImplementedError("cross-attention is not ported yet: it "
                                  "arrives with ROADMAP item 19b")


# ============================================================ block level ====
def block_init(gen: torch.Generator, cfg, spec) -> dict:
    _check_spec(spec)
    return {"mix": mamba_init(gen, cfg)}


def block_forward(bp, blora, x, cfg, spec, *, mode, cache=None, pos=None,
                  alpha=16.0, scan_backend="auto"):
    _check_spec(spec)
    blora = blora or {}
    y, c = mamba_forward(bp["mix"], blora.get("mix"), x, cfg, mode=mode,
                         cache=cache, pos=pos, alpha=alpha,
                         scan_backend=scan_backend)
    return x + y, c


def block_init_cache(cfg, spec, batch: int, dtype, device=None) -> dict:
    _check_spec(spec)
    return mamba_init_cache(cfg, batch, dtype, device)


def block_lora_specs(cfg, spec) -> dict[str, tuple]:
    """{relpath: (fan_out, fan_in, extra_leading)} for one block."""
    _check_spec(spec)
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    dims = {"in_proj": (2 * d_in + 2 * n + h, d), "out_proj": (d, d_in)}
    return {f"mix/{t}": dims[t] + ((),) for t in MAMBA_LORA_TARGETS}


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


def stage_forward(sp, slora, x, cfg, stage, *, mode, caches=None, pos=None,
                  alpha=16.0, remat=False, scan_backend="auto"):
    """Loop over the stage's repeats. Returns (x, new_caches or None), the
    caches stacked over the repeats."""
    per_layer = []
    for r in range(stage.repeat):
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
                bp_unit[f"b{i}"], bl, x, cfg, spec, mode=mode, cache=c,
                pos=pos, alpha=alpha, scan_backend=scan_backend)
            if cnew is not None:
                new_caches[f"b{i}"] = cnew
        per_layer.append(new_caches or None)
    if per_layer[0] is None:
        return x, None
    return x, tree_map(lambda *leaves: torch.stack(leaves), *per_layer)
