"""A decoder-only GQA language model with LoRA, plainly: the reference of
the h2o-danube-3-4b cells (llama-style blocks; causal attention, with
keys no further back than ``window`` where the configuration sets one).

Per layer ``l`` of a sequence ``h`` (S, d):

    a = rmsnorm(h) * g_attn;   q, k, v = a Wq + lora_q(a), ...
    q, k rotated by RoPE (the two contiguous halves of a head, base theta)
    head i attends with KV head i // (H / KV), scale head_dim^-1/2, causal,
    keys no further back than the window (if any); softmax in fp32
    h = h + (attn) Wo + lora_o(attn)
    m = rmsnorm(h) * g_ffn;    h = h + (silu(m Wg + .) * (m Wu + .)) Wd + .

then ``rmsnorm(h) * g_final`` times the output head, and the mean
next-token cross-entropy (:mod:`.lm`).  ``lora_t(x) = (alpha / rank) (x
A^T) B^T``.  Weights are the benchmark's tensors in the program's layout
(dense kernels ``(L, fan_in, fan_out)``), cast up to the compute type
layer by layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lm
from .lm import adapter_pairs as adapter_pairs
from .lm import rmsnorm
from .precision import mm

NEG = -1e30


def _block(weights):
    return weights["stages"][0]["b0"]


def rope(x, theta):
    """x: (S, heads, hd); the two contiguous halves rotated."""
    s, _, hd = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                          device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _proj(x, w, pair, l, cfg, prec, alpha):
    """``x W`` plus the target's LoRA term at layer ``l``."""
    y = mm(x, w[l], prec)
    if pair is not None:
        rank = pair["rank"]
        rank = int(rank[l]) if torch.is_tensor(rank) and rank.ndim \
            else int(rank)
        scale = alpha / max(rank, 1)
        y = y + mm(mm(x, pair["A"][l].transpose(0, 1), prec),
                   pair["B"][l].transpose(0, 1), prec) * scale
    return y


def layer(h, l, weights, lora, cfg, prec, alpha):
    """One layer over ``h`` (S, d) in the compute type."""
    blk = _block(weights)
    mix, ffn = blk["mix"], blk["ffn"]
    eps = cfg["norm_eps"]
    nh, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    s = h.shape[0]
    a = rmsnorm(h, mix["ln"]["scale"][l], eps)

    def proj(name, x, w):
        return _proj(x, w["w"], lora.get(name), l, cfg, prec, alpha)
    q = proj("mix/q", a, mix["q"]).reshape(s, nh, hd)
    k = proj("mix/k", a, mix["k"]).reshape(s, kv, hd)
    v = proj("mix/v", a, mix["v"]).reshape(s, kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = nh // kv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0), prec) * hd ** -0.5
    pos = torch.arange(s, device=h.device)
    allowed = pos[None, :] <= pos[:, None]
    if cfg.get("window", 0):
        allowed &= pos[None, :] > pos[:, None] - cfg["window"]
    scores = scores.float().masked_fill(~allowed, NEG)
    probs = torch.softmax(scores, -1).to(h.dtype)
    att = mm(probs, v.transpose(0, 1), prec).transpose(0, 1).reshape(s, -1)
    h = h + proj("mix/o", att, mix["o"])
    m = rmsnorm(h, ffn["ln"]["scale"][l], eps)
    gate = proj("ffn/gate", m, ffn["gate"])
    up = proj("ffn/up", m, ffn["up"])
    return h + proj("ffn/down", F.silu(gate) * up, ffn["down"])


def loss_and_grad(weights, factors, rank: int, tokens, cfg, prec="fp32",
                  alpha=16.0):
    """:func:`.lm.loss_and_grad` through this model's layers."""
    return lm.loss_and_grad(layer, weights, factors, rank, tokens, cfg,
                            prec, alpha)


def last_logits(weights, adapters, tokens, cfg, prec="fp32", alpha=16.0):
    """:func:`.lm.last_logits` through this model's layers."""
    return lm.last_logits(layer, weights, adapters, tokens, cfg, prec,
                          alpha)
