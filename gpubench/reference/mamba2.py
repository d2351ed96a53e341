"""Mamba-2 (SSD, arXiv:2405.21060) with LoRA on its projections, plainly:
the reference of the mamba2-1.3b cells.

Per layer of a batch ``h`` (B, L, d), one group, ``d_in = expand * d``,
``H = d_in / P`` heads of size ``P``, state ``N``:

    a = rmsnorm(h) * g;  [z, x, B, C, dt] = a W_in + lora_in(a)
    dt = softplus(dt + dt_bias);  A = -exp(A_log)           (per head)
    [x, B, C] = silu(causal depthwise conv_K([x, B, C]) + conv_b)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t + D x_t
    y = rmsnorm(y * silu(z)) * g_n;  h = h + y W_out + lora_out(y)

then ``rmsnorm(h) * g_final`` and the tied output head (the loss and its
gradient through :mod:`.lm`).  The recurrence is
evaluated by the paper's chunked algorithm (:func:`ssd`), which
:func:`ssd_sequential` checks step by step in the tests.  Weights are the
benchmark's tensors in the program's layout, cast up layer by layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lm
from .lm import adapter_pairs as adapter_pairs
from .lm import rmsnorm
from .precision import dtype, mm, no_tf32


def ssd_sequential(x, dt_a, b, c):
    """The recurrence one step at a time: x (B, L, H, P) already times dt,
    dt_a (B, L, H), b/c (B, L, N).  Returns (y (B, L, H, P), h (B, H, P,
    N))."""
    bsz, length, nh, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, nh, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(length):
        state = state * torch.exp(dt_a[:, t])[:, :, None, None] \
            + x[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append((state * c[:, t, None, None, :]).sum(-1))
    return torch.stack(ys, 1), state


def ssd(x, dt_a, b, c, chunk: int):
    """The same recurrence by chunks of ``chunk`` positions (``chunk``
    divides L): within a chunk the quadratic form on the causal triangle,
    across chunks the states carried with their decay."""
    bsz, length, nh, p = x.shape
    n = b.shape[-1]
    q = chunk
    nc = length // q
    xc = x.reshape(bsz, nc, q, nh, p)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)
    acs = torch.cumsum(dt_a.reshape(bsz, nc, q, nh), 2)      # (B,C,Q,H)
    idx = torch.arange(q, device=x.device)
    tri = idx[:, None] >= idx[None, :]                        # (Q,Q) i>=j
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]       # (B,C,i,j,H)
    decay = torch.where(tri[None, None, :, :, None],
                        torch.exp(torch.where(tri[None, None, :, :, None],
                                              seg, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay, xc)
    tail = torch.exp(acs[:, :, -1:, :] - acs)                 # (B,C,Q,H)
    states = torch.einsum("bcjh,bcjhp,bcjn->bchpn", tail, xc, bc)
    total = acs[:, :, -1, :]                                  # (B,C,H)
    h = torch.zeros((bsz, nh, p, n), dtype=x.dtype, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(h)
        h = h * torch.exp(total[:, k])[:, :, None, None] + states[:, k]
    entering = torch.stack(entering, 1)                       # (B,C,H,P,N)
    y = y + torch.einsum("bcin,bchpn,bcih->bcihp", cc, entering,
                         torch.exp(acs))
    return y.reshape(bsz, length, nh, p), h


def _lora(x, pair, l, prec, alpha):
    rank = pair["rank"]
    rank = int(rank[l]) if torch.is_tensor(rank) and rank.ndim else int(rank)
    scale = alpha / max(rank, 1)
    return mm(mm(x, pair["A"][l].transpose(0, 1), prec),
              pair["B"][l].transpose(0, 1), prec) * scale


def layer(h, l, weights, lora, cfg, prec, alpha):
    """One Mamba-2 layer over ``h`` (B, L, d) in the compute type."""
    mix = weights["stages"][0]["b0"]["mix"]
    dt_ = h.dtype
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    p = cfg["ssm_head_dim"]
    nh = d_in // p
    n = cfg["ssm_state"]
    eps = cfg["norm_eps"]
    a = rmsnorm(h, mix["ln"]["scale"][l], eps)
    zx = mm(a, mix["in_proj"]["w"][l], prec)
    if "mix/in_proj" in lora:
        zx = zx + _lora(a, lora["mix/in_proj"], l, prec, alpha)
    z, xin, bm, cm, dt = torch.split(zx, [d_in, d_in, n, n, nh], -1)
    dt = F.softplus(dt.float() + mix["dt_bias"][l].float()).to(dt_)
    a_head = -torch.exp(mix["A_log"][l].float()).to(dt_)
    conv_in = torch.cat([xin, bm, cm], -1)                    # (B,L,Cv)
    w = mix["conv_w"][l].to(dt_)                              # (K,Cv)
    k = w.shape[0]
    padded = F.pad(conv_in, (0, 0, k - 1, 0))
    conv = sum(padded[:, j:j + conv_in.shape[1]] * w[j] for j in range(k))
    conv = F.silu(conv + mix["conv_b"][l].to(dt_))
    xc, bc, cc = torch.split(conv, [d_in, n, n], -1)
    xh = xc.reshape(xc.shape[:2] + (nh, p))
    y, _ = ssd(xh * dt[..., None], dt * a_head, bc, cc, cfg["ssm_chunk"])
    y = y + mix["D"][l].to(dt_)[:, None] * xh
    y = y.reshape(h.shape[:2] + (d_in,))
    y = rmsnorm(y * F.silu(z), mix["gn"]["scale"][l], eps)
    out = mm(y, mix["out_proj"]["w"][l], prec)
    if "mix/out_proj" in lora:
        out = out + _lora(y, lora["mix/out_proj"], l, prec, alpha)
    return h + out


@torch.no_grad()
@no_tf32()
def last_logits(weights, adapters, tokens, cfg, prec="fp32", alpha=16.0):
    """(B, V) logits at the last position of each prompt in ``tokens``
    (B, L); ``adapters`` is ``{target: {"A", "B", "rank"}}``."""
    dt = dtype(prec)
    h = weights["embed"]["table"][tokens].to(dt)
    for l in range(cfg["n_layers"]):
        h = layer(h, l, weights, adapters, cfg, prec, alpha)
    h = rmsnorm(h[:, -1], weights["final_ln"]["scale"], cfg["norm_eps"])
    return mm(h, weights["embed"]["table"].transpose(0, 1), prec).float()


def _sequence_layer(h, l, weights, lora, cfg, prec, alpha):
    """:func:`layer` over one sequence's ``h`` (S, d)."""
    return layer(h[None], l, weights, lora, cfg, prec, alpha)[0]


def loss_and_grad(weights, factors, rank: int, tokens, cfg, prec="fp32",
                  alpha=16.0):
    """:func:`.lm.loss_and_grad` through this model's layers."""
    return lm.loss_and_grad(_sequence_layer, weights, factors, rank, tokens,
                            cfg, prec, alpha)
