"""Mixture-of-Experts feed-forward on tensor dicts: capacity-based sort
routing with group-local dispatch.

The JAX package's ``repro.models.moe`` in plain PyTorch ops and the
reference's formulation:

* routing: fp32 router logits, softmax, top-k, the k weights renormalised
  by their sum ``+ 1e-9``;
* groups: the ``n`` tokens split into ``g = min(n_groups, n)`` routing
  groups, ``g`` lowered until it divides ``n``; each group dispatches its
  own ``ng = n / g`` tokens into ``cap = ceil(ng * k / E *
  capacity_factor)`` slots an expert;
* dispatch: a stable sort of the group's ``ng * k`` assignments by expert;
  an assignment's slot is its rank among its expert's, and one past the
  capacity drops (its values zeroed and sent to the slot ``(E - 1, cap -
  1)``); the ``(g, E, cap, d)`` dispatch tensor is filled by an
  accumulating ``index_put``, and the combine gathers each kept slot back,
  weighted, into its token by another;
* the experts: SwiGLU over the dispatch tensor, each expert's kernels
  ``(E, in, out)`` with a per-expert LoRA pair (A ``(E, r, in)``, B ``(E,
  out, r)``, scale ``alpha / max(rank, 1)``); then the shared experts
  (one dense SwiGLU of width ``moe_d_ff * n_shared_experts``) and the
  post-block norm.

``moe_mode="ep_hint"`` is a sharding hint in the reference (it pins the
dispatch tensor's expert axis to the mesh's ``model`` axis so that XLA
moves slots with an all-to-all): on one device it computes the sort path,
and so it does here.  ``"ep_a2a"`` is :mod:`repro_torch.models.moe_ep`.
Padded experts (``moe_pad_experts``) are never routed to.  The indices are
int64 (torch's), the reference's int32; the accumulating ``index_put``
sums in another order on the card (atomics), so the port is held to the
reference within a tolerance, not bit for bit.  No kernel lies on this
path: the reference computes it in plain ``jnp``.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from .common import dense, dense_init, dtype_of, norm, norm_init

MOE_LORA_TARGETS = ("experts/gate", "experts/up", "experts/down")


def moe_init(gen: torch.Generator, cfg) -> dict:
    d, f = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    # physical expert count may be padded so it divides the model axis
    # (padded experts are never routed to -- dead weights, EP-shardable)
    e = cfg.n_experts + cfg.moe_pad_experts
    dt = dtype_of(cfg)
    dev = gen.device
    s = (1.0 / d) ** 0.5

    def draw(shape, dtype, scale):
        # scaled in place: an expert leaf of a full config is gigabytes
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=dev).mul_(scale)
    p = {
        "ln": norm_init(cfg, device=dev),
        "router": {"w": draw((d, e), torch.float32, s)},
        "experts": {
            "gate": {"w": draw((e, d, f), dt, s)},
            "up": {"w": draw((e, d, f), dt, s)},
            "down": {"w": draw((e, f, d), dt, (1.0 / f) ** 0.5)},
        },
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"gate": dense_init(gen, d, fs, dt),
                       "up": dense_init(gen, d, fs, dt),
                       "down": dense_init(gen, fs, d, dt)}
    if cfg.post_block_norm:
        p["post_ln"] = norm_init(cfg, device=dev)
    return p


def expert_dense(w: torch.Tensor, x: torch.Tensor,
                 lora_pair: Mapping | None = None,
                 alpha: float = 16.0) -> torch.Tensor:
    """x: (G, E, C, in), w: (E, in, out) -> (G, E, C, out) with per-expert
    LoRA (A (E, r, in), B (E, out, r))."""
    y = torch.einsum("geci,eio->geco", x, w)
    if lora_pair is not None:
        scale = alpha / lora_pair["rank"].float().clamp(min=1.0)
        ax = torch.einsum("geci,eri->gecr", x, lora_pair["A"].to(x.dtype))
        y = y + torch.einsum("gecr,eor->geco", ax,
                             lora_pair["B"].to(x.dtype)) * scale.to(x.dtype)
    return y


def route(cfg, logits: torch.Tensor):
    """Top-k routing over the last axis.  Returns (weights (..., K) fp32,
    experts (..., K) int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, ix = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return w / (w.sum(-1, keepdim=True) + 1e-9), ix


def n_route_groups(n: int, n_groups: int) -> int:
    """The routing groups of ``n`` tokens: ``min(n_groups, n)``, lowered
    until it divides ``n``."""
    g = max(1, min(n_groups, n))
    while n % g:
        g -= 1
    return g


def expert_capacity(cfg, ng: int) -> int:
    """Slots an expert of a group of ``ng`` tokens."""
    e = cfg.n_experts + cfg.moe_pad_experts
    return int(math.ceil(ng * cfg.experts_per_token / e
                         * cfg.capacity_factor))


def dispatch_shape(cfg, n: int, n_groups: int = 32) -> tuple[int, ...]:
    """``(g, E, cap, d)``: the dispatch tensor of ``n`` tokens."""
    g = n_route_groups(n, n_groups)
    return (g, cfg.n_experts + cfg.moe_pad_experts,
            expert_capacity(cfg, n // g), cfg.d_model)


def dispatch(flat: torch.Tensor, ix: torch.Tensor, e: int, cap: int):
    """Each group's scatter into ``(E, cap, d)`` expert slots.

    flat: (g, ng, d) tokens, ix: (g, ng, K) their experts.  Returns the
    dispatch tensor ``(g, E, cap, d)`` and the slot plan ``(rows, cols,
    keep, token_of, order)``, each ``(g, ng * K)``: assignment ``j`` of a
    group in expert order (``order``, a stable argsort) sits in slot
    ``(rows[j], cols[j])`` and came from token ``token_of[j]``."""
    g, ng, d = flat.shape
    k = ix.shape[-1]
    ae = ix.reshape(g, ng * k)
    order = torch.argsort(ae, dim=-1, stable=True)
    ae_sorted = torch.gather(ae, 1, order).contiguous()
    first = torch.searchsorted(ae_sorted, ae_sorted, side="left")
    pos = torch.arange(ng * k, device=flat.device) - first
    keep = pos < cap
    token_of = order // k
    rows = torch.where(keep, ae_sorted, e - 1)
    cols = torch.where(keep, pos, cap - 1)
    gi = torch.arange(g, device=flat.device)[:, None].expand_as(rows)
    vals = torch.gather(flat, 1, token_of[..., None].expand(-1, -1, d)) \
        * keep[..., None].to(flat.dtype)
    einp = flat.new_zeros((g, e, cap, d)).index_put(
        (gi, rows, cols), vals, accumulate=True)
    return einp, (rows, cols, keep, token_of, order)


def combine(eo: torch.Tensor, w: torch.Tensor, plan, ng: int) -> torch.Tensor:
    """Each group's kept slots of ``eo`` (g, E, cap, d), weighted by the
    routing weights ``w`` (g, ng, K), summed back into their tokens:
    (g, ng, d)."""
    rows, cols, keep, token_of, order = plan
    g, m = rows.shape
    gi = torch.arange(g, device=eo.device)[:, None].expand_as(rows)
    gathered = eo[gi, rows, cols] * keep[..., None].to(eo.dtype)
    wflat = torch.gather(w.reshape(g, m), 1, order)
    contrib = gathered * wflat[..., None].to(eo.dtype)
    return eo.new_zeros((g, ng, eo.shape[-1])).index_put(
        (gi, token_of), contrib, accumulate=True)


def experts_forward(pe: Mapping, lora: Mapping, einp: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """SwiGLU of every expert over its slots: (G, E, C, d) -> (G, E, C, d)."""
    eg = expert_dense(pe["gate"]["w"], einp, lora.get("experts/gate"), alpha)
    eu = expert_dense(pe["up"]["w"], einp, lora.get("experts/up"), alpha)
    return expert_dense(pe["down"]["w"], F.silu(eg) * eu,
                        lora.get("experts/down"), alpha)


def shared_and_norm(p: Mapping, lora: Mapping, y: torch.Tensor,
                    flat: torch.Tensor, shape, cfg,
                    alpha: float) -> torch.Tensor:
    """Adds the shared experts' SwiGLU of ``flat`` (n, d) to the routed
    output ``y`` (n, d), reshapes to ``shape`` and applies the post-block
    norm: the tail both dispatch paths share."""
    if "shared" in p:
        sh = p["shared"]
        y = y + dense(sh["down"],
                      F.silu(dense(sh["gate"], flat, lora.get("shared/gate"),
                                   alpha))
                      * dense(sh["up"], flat, lora.get("shared/up"), alpha),
                      lora.get("shared/down"), alpha)
    y = y.reshape(shape)
    if cfg.post_block_norm:
        y = norm(p["post_ln"], y, cfg.norm_eps)
    return y


def moe_forward(p: Mapping, lora: Mapping | None, x: torch.Tensor, cfg,
                alpha: float = 16.0, n_groups: int = 32) -> torch.Tensor:
    """Capacity-based sort routing with group-local dispatch; x: (B, S, d)
    -> (B, S, d)."""
    lora = lora or {}
    b, s, d = x.shape
    e = cfg.n_experts + cfg.moe_pad_experts
    n = b * s
    g = n_route_groups(n, n_groups)
    ng = n // g
    cap = expert_capacity(cfg, ng)

    h = norm(p["ln"], x, cfg.norm_eps)
    flat = h.reshape(g, ng, d)
    logits = torch.einsum("gnd,de->gne", flat.float(), p["router"]["w"])
    w, ix = route(cfg, logits)                        # (g, ng, K)
    einp, plan = dispatch(flat, ix, e, cap)
    eo = experts_forward(p["experts"], lora, einp, alpha)
    y = combine(eo, w, plan, ng)
    return shared_and_norm(p, lora, y.reshape(n, d), flat.reshape(n, d),
                           (b, s, d), cfg, alpha)


__all__ = ["MOE_LORA_TARGETS", "moe_init", "expert_dense", "route",
           "n_route_groups", "expert_capacity", "dispatch_shape", "dispatch",
           "combine", "experts_forward", "moe_forward"]
