"""What the references' language models share: the norm, the loss of a
sequence through a stack of layers, and its gradient with respect to the
LoRA factors, one sequence at a time with each layer recomputed in the
backward (``torch.utils.checkpoint``), so that an fp32 reference of a
billion-parameter model fits beside its bf16 weights.

``layer(h, l, weights, lora, cfg, prec, alpha)`` maps a sequence's hidden
states ``h`` (S, d) through layer ``l``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .precision import dtype, mm, no_tf32


def adapter_pairs(tree) -> dict:
    """{target: pair} of an adapter tree of one stage of one block (the
    program's layout for the references' models)."""
    return dict(tree["stages"][0]["b0"])


def rmsnorm(x, scale, eps):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def head(weights, cfg):
    """The output head (d, V): the tied embedding's transpose or
    ``lm_head``."""
    return (weights["embed"]["table"].transpose(0, 1)
            if cfg.get("tie_embeddings") else weights["lm_head"]["w"])


def sequence_nll(layer, weights, lora, tokens, cfg, prec="fp32",
                 alpha=16.0, recompute=True):
    """Summed next-token negative log-likelihood of one sequence
    ``tokens`` (S,)."""
    h = weights["embed"]["table"][tokens].to(dtype(prec))
    for l in range(cfg["n_layers"]):
        if recompute and torch.is_grad_enabled():
            h = checkpoint(layer, h, l, weights, lora, cfg, prec, alpha,
                           use_reentrant=False)
        else:
            h = layer(h, l, weights, lora, cfg, prec, alpha)
    h = rmsnorm(h, weights["final_ln"]["scale"], cfg["norm_eps"])
    logits = mm(h[:-1], head(weights, cfg), prec).float()
    lp = torch.log_softmax(logits, -1)
    return -lp.gather(-1, tokens[1:, None])[:, 0].sum()


@no_tf32()
def loss_and_grad(layer, weights, factors, rank: int, tokens, cfg,
                  prec="fp32", alpha=16.0):
    """(mean next-token loss, {(target, side): gradient}) of adapter
    ``factors`` ``{target: {"A", "B"}}`` at live rank ``rank`` over the
    batch ``tokens`` (B, S), one sequence at a time."""
    dt = dtype(prec)
    live = {t: {side: factors[t][side].detach().to(dt).requires_grad_(True)
                for side in ("A", "B")} for t in factors}
    lora = {t: {"A": live[t]["A"], "B": live[t]["B"], "rank": rank}
            for t in live}
    count = tokens.shape[0] * (tokens.shape[1] - 1)
    total = 0.0
    for row in tokens:
        nll = sequence_nll(layer, weights, lora, row, cfg, prec, alpha)
        (nll / count).backward()
        total += float(nll.detach())
    grads = {(t, side): live[t][side].grad.float()
             for t in live for side in ("A", "B")}
    return total / count, grads


@torch.no_grad()
@no_tf32()
def last_logits(layer, weights, adapters, tokens, cfg, prec="fp32",
                alpha=16.0):
    """(B, V) logits at the last position of each prompt in ``tokens``
    (B, L), one prompt at a time through ``layer``; ``adapters`` is
    ``{target: {"A", "B", "rank"}}``."""
    out = []
    for row in tokens:
        h = weights["embed"]["table"][row].to(dtype(prec))
        for l in range(cfg["n_layers"]):
            h = layer(h, l, weights, adapters, cfg, prec, alpha)
        h = rmsnorm(h[-1:], weights["final_ln"]["scale"], cfg["norm_eps"])
        out.append(mm(h, head(weights, cfg), prec).float())
    return torch.cat(out)


def adam_first_update(grad: torch.Tensor, lr: float, eps: float = 1e-8):
    """Adam's first step from zero moments: the bias-corrected moments are
    ``g`` and ``g^2``, so the update is ``-lr g / (|g| + eps)``."""
    g = grad.double()
    return (-lr * g / (g.abs() + eps)).float()
