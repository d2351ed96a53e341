"""Attention token mixers on tensor dicts: grouped-query attention (GQA:
SWA windows, softcaps, QKV bias, query scale and post-block norms, and
the encoder-decoder's cross-attention) and DeepSeek's multi-head latent
attention (MLA).

The JAX package's ``repro.models.attention`` GQA and MLA paths, in plain
PyTorch ops and the reference's formulation.  Three modes share one
parameter set:

* full    -- a whole sequence (training, the full forward);
* prefill -- full, plus the cache padded to ``capacity`` (an SWA layer's
  in ring order, ``slot = pos % w``; MLA's the latent ``ckv`` and the
  rotated ``kr``);
* decode  -- one new token against the cache (a ring buffer for an SWA
  layer; MLA re-expands K and V from its latent cache, or, absorbed,
  attends in the latent space).

Query head ``i`` reads KV head ``i // g`` (heads grouped ``(kv, g)`` by a
reshape).  Scores are ``q.k * scale`` in the input dtype, softcapped, then
fp32; masked entries are ``NEG_INF`` (not ``-inf``), the softmax runs in
fp32 and the probabilities are cast to v's dtype for the product with v.
Queries go in chunks (:func:`_choose_q_chunk`), so a long prefill never
holds an (S, S) score matrix per head group.  No kernel lies on this path:
``scaled_dot_product_attention`` has no score softcap and masks otherwise.
MLA's values are narrower than its queries and keys (``v_head_dim``
against ``qk_nope_dim + qk_rope_dim``): the products take each operand's
own head dim.

A GQA block with ``cross_attn`` (whisper's decoder) attends to the
encoder's output after its self-attention: ``xk``/``xv`` project
``enc_out`` (full and prefill; prefill caches them, decode reads them
back), the queries ``xq`` project ``norm(xln, x + y)``, every encoder
position is valid, and ``xo``'s output is added to ``y`` before the
post-block norm.  MLA and a mamba block ignore the flag, as the reference
does.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .common import (apply_rope, dense, dense_init, dtype_of, norm,
                     norm_init, softcap)

NEG_INF = -2.0 ** 30  # large-negative in f32, safe under bf16 casts


def _choose_q_chunk(s: int, target: int = 1024) -> int:
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


# =================================================================== GQA ====
def gqa_init(gen: torch.Generator, cfg, block,
             d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {
        "ln": norm_init(cfg, d, device=gen.device),
        "q": dense_init(gen, d, h * hd, dt, bias=cfg.qkv_bias),
        "k": dense_init(gen, d, kv * hd, dt, bias=cfg.qkv_bias),
        "v": dense_init(gen, d, kv * hd, dt, bias=cfg.qkv_bias),
        "o": dense_init(gen, h * hd, d, dt),
    }
    if block.cross_attn:
        p["xk"] = dense_init(gen, d, kv * hd, dt, bias=cfg.qkv_bias)
        p["xv"] = dense_init(gen, d, kv * hd, dt, bias=cfg.qkv_bias)
        p["xq"] = dense_init(gen, d, h * hd, dt, bias=cfg.qkv_bias)
        p["xo"] = dense_init(gen, h * hd, d, dt)
        p["xln"] = norm_init(cfg, d, device=gen.device)
    if cfg.post_block_norm:
        p["post_ln"] = norm_init(cfg, d, device=gen.device)
    return p


def gqa_lora_targets(block) -> tuple[str, ...]:
    t = ("q", "k", "v", "o")
    return t + ("xq", "xk", "xv", "xo") if block.cross_attn else t


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _masked_softmax_av(scores: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor, cap: float) -> torch.Tensor:
    """scores (B,K,G,Q,T) in the input dtype, mask broadcastable to it:
    softcap, fp32, NEG_INF where masked, softmax, probs in v's dtype, then
    ``(B,Q,K,G,D)`` = probs . v."""
    s = softcap(scores, cap).float()
    s = s.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", probs, v)


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, q_positions: torch.Tensor,
                    k_positions: torch.Tensor, scale: float,
                    cap: float) -> torch.Tensor:
    """q: (B,S,K,G,D); k/v: (B,T,K,D); positions give absolute indices.

    Loops over query chunks; masks built from absolute positions so the
    same path serves training (q_pos == k_pos) and prefill."""
    b, s, kh, g, d = q.shape
    qc = _choose_q_chunk(s)
    outs = []
    for c0 in range(0, s, qc):
        qi, qp = q[:, c0:c0 + qc], q_positions[c0:c0 + qc]
        scores = torch.einsum("bqkgd,btkd->bkgqt", qi, k) * scale
        mask = torch.ones((qp.shape[0], k.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_positions[None, :] <= qp[:, None]
        if window > 0:
            mask &= k_positions[None, :] > (qp[:, None] - window)
        outs.append(_masked_softmax_av(scores, mask, v, cap))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def _attend_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, scale: float,
                   cap: float) -> torch.Tensor:
    """q: (B,1,K,G,D); k/v: (B,T,K,D); valid: (T,) bool."""
    scores = torch.einsum("bqkgd,btkd->bkgqt", q, k) * scale
    return _masked_softmax_av(scores, valid, v, cap)


def gqa_forward(p: Mapping, lora: Mapping | None, x: torch.Tensor, cfg,
                block, *, mode: str, positions: torch.Tensor | None = None,
                cache: Mapping | None = None, pos=None,
                enc_out: torch.Tensor | None = None, alpha: float = 16.0,
                capacity: int | None = None):
    """Returns (y, new_cache or None).

    mode: 'full' | 'prefill' | 'decode'.  ``positions``: (S,) absolute
    positions for full/prefill.  ``pos``: the current index for decode (an
    int or a 0-d tensor).  ``enc_out``: (B, T_enc, d) the encoder's output,
    which a ``cross_attn`` block reads in full and prefill modes.
    ``capacity``: the prefill cache's length (>= S) so that decode can
    continue in it."""
    lora = lora or {}
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    scale = cfg.query_scale if cfg.query_scale is not None else hd ** -0.5
    hx = norm(p["ln"], x, cfg.norm_eps)

    def proj(name, inp):
        return dense(p[name], inp, lora.get(name), alpha)

    q = _split_heads(proj("q", hx), h)
    kk = _split_heads(proj("k", hx), kv)
    vv = _split_heads(proj("v", hx), kv)
    new_cache = {}
    if mode in ("full", "prefill"):
        s = x.shape[1]
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions[None], cfg.rope_theta, cfg.rope_kind)
        kk = apply_rope(kk, positions[None], cfg.rope_theta, cfg.rope_kind)
        qg = q.reshape(q.shape[:2] + (kv, g, hd))
        out = _attend_chunked(qg, kk, vv, causal=block.causal,
                              window=block.window, q_positions=positions,
                              k_positions=positions, scale=scale,
                              cap=cfg.attn_softcap)
        if mode == "prefill":
            t_cap = capacity or s
            if block.window > 0:
                w = min(block.window, t_cap)
                # keep the last `w` positions in ring order slot = pos % w
                tail_k, tail_v, _ = _ring_from_tail(kk, vv, positions, w)
                new_cache = {"k": tail_k, "v": tail_v}
            else:
                if t_cap < s:
                    raise ValueError(f"gqa_forward: capacity {t_cap} is "
                                     f"shorter than the prompt ({s})")
                pad = (0, 0, 0, 0, 0, t_cap - s)
                new_cache = {"k": torch.nn.functional.pad(kk, pad),
                             "v": torch.nn.functional.pad(vv, pad)}
    elif mode == "decode":
        pos = int(pos)
        posb = torch.full((1, 1), pos, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta, cfg.rope_kind)
        kk = apply_rope(kk, posb, cfg.rope_theta, cfg.rope_kind)
        t = cache["k"].shape[1]
        # ring buffer slot; the cache may be shorter than the window when
        # the serving context itself is (t == min(window, seq_len))
        slot = (pos % t) if block.window > 0 else pos
        ck = _write_slot(cache["k"], kk, slot)
        cv = _write_slot(cache["v"], vv, slot)
        iota = torch.arange(t, device=x.device)
        valid = iota < min(pos + 1, t) if block.window > 0 else iota <= pos
        qg = q.reshape(q.shape[:2] + (kv, g, hd))
        out = _attend_decode(qg, ck, cv, valid, scale, cfg.attn_softcap)
        new_cache = {"k": ck, "v": cv}
    else:
        raise ValueError(f"unknown mode {mode!r}; options: full | prefill | "
                         "decode")
    out = out.reshape(x.shape[:2] + (h * hd,))
    y = dense(p["o"], out, lora.get("o"), alpha)

    # ---------------- cross attention (encoder-decoder) ----------------
    if block.cross_attn:
        if mode == "decode":
            xk, xv = cache["xk"], cache["xv"]
            new_cache["xk"], new_cache["xv"] = xk, xv
        else:
            if enc_out is None:
                raise ValueError("a cross_attn block needs the encoder's "
                                 "output (enc_out)")
            xk = _split_heads(proj("xk", enc_out), kv)
            xv = _split_heads(proj("xv", enc_out), kv)
            if mode == "prefill":
                new_cache["xk"], new_cache["xv"] = xk, xv
        hx2 = norm(p["xln"], x + y, cfg.norm_eps)
        xq = _split_heads(proj("xq", hx2), h)
        xqg = xq.reshape(xq.shape[:2] + (kv, g, hd))
        every = torch.ones(xk.shape[1], dtype=torch.bool, device=x.device)
        xout = _attend_decode(xqg, xk, xv, every, scale, cfg.attn_softcap)
        xout = xout.reshape(x.shape[:2] + (h * hd,))
        y = y + dense(p["xo"], xout, lora.get("xo"), alpha)

    if cfg.post_block_norm:
        y = norm(p["post_ln"], y, cfg.norm_eps)
    return y, (new_cache or None)


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                slot: int) -> torch.Tensor:
    """A copy of ``cache`` (B, T, ...) with ``new`` (B, 1, ...) written at
    ``slot``, placed as ``lax.dynamic_update_slice_in_dim`` places it: a
    negative start counts once from the end, then clamps into [0, T - 1]."""
    t = cache.shape[1]
    slot = min(max(slot + t if slot < 0 else slot, 0), t - 1)
    out = cache.clone()
    out[:, slot] = new[:, 0]
    return out


def _ring_from_tail(kk: torch.Tensor, vv: torch.Tensor,
                    positions: torch.Tensor, w: int):
    """Arrange the last ``w`` timesteps of (B,T,KV,D) into ring order."""
    t = kk.shape[1]
    if t <= w:
        pad = (0, 0, 0, 0, 0, w - t)
        return (torch.nn.functional.pad(kk, pad),
                torch.nn.functional.pad(vv, pad), positions)
    # positions kept: last_pos-w+1 .. last_pos ; slot = pos % w
    kept_pos = positions[-w:]
    order = torch.argsort(kept_pos % w)
    return kk[:, -w:][:, order], vv[:, -w:][:, order], kept_pos


def gqa_init_cache(cfg, block, batch: int, seq_len: int, dtype,
                   device=None) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    t = min(block.window, seq_len) if block.window > 0 else seq_len
    c = {"k": torch.zeros((batch, t, kv, hd), dtype=dtype, device=device),
         "v": torch.zeros((batch, t, kv, hd), dtype=dtype, device=device)}
    if block.cross_attn:
        for name in ("xk", "xv"):
            c[name] = torch.zeros((batch, cfg.encoder_seq, kv, hd),
                                  dtype=dtype, device=device)
    return c


# =================================================================== MLA ====
def mla_init(gen: torch.Generator, cfg, block) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dt = dtype_of(cfg)
    dev = gen.device
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "ln": norm_init(cfg, d, device=dev),
        "q_a": dense_init(gen, d, cfg.q_lora_rank, dt),
        "q_ln": norm_init(cfg, cfg.q_lora_rank, device=dev),
        "q_b": dense_init(gen, cfg.q_lora_rank, h * qk_dim, dt),
        "kv_a": dense_init(gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim, dt),
        "kv_ln": norm_init(cfg, cfg.kv_lora_rank, device=dev),
        "kv_b": dense_init(gen, cfg.kv_lora_rank,
                           h * (cfg.qk_nope_dim + cfg.v_head_dim), dt),
        "o": dense_init(gen, h * cfg.v_head_dim, d, dt),
    }


MLA_LORA_TARGETS = ("q_a", "q_b", "kv_a", "kv_b", "o")


def _rope_key(k_rope: torch.Tensor, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """The one rotated key head MLA shares across heads: (B, S, rope_d)."""
    return apply_rope(k_rope[..., None, :], positions, theta, "full")[..., 0, :]


def _expand_kv(p, lora, ckv, kr, cfg, alpha):
    """K (B, T, H, nope + rope_d) and V (B, T, H, v_head_dim) from the
    latent ``ckv`` (B, T, kv_lora_rank) and the shared rotated key
    ``kr`` (B, T, rope_d)."""
    h, nope = cfg.n_heads, cfg.qk_nope_dim
    kv = dense(p["kv_b"], ckv, lora.get("kv_b"), alpha).reshape(
        ckv.shape[:2] + (h, nope + cfg.v_head_dim))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, kr[..., None, :].expand(
        k_nope.shape[:-1] + (cfg.qk_rope_dim,))], -1)
    return k, v


def mla_forward(p: Mapping, lora: Mapping | None, x: torch.Tensor, cfg,
                block, *, mode: str, positions: torch.Tensor | None = None,
                cache: Mapping | None = None, pos=None, alpha: float = 16.0,
                absorbed: bool = False, capacity: int | None = None):
    """DeepSeek-V3 multi-head latent attention.  Returns (y, new_cache or
    None); the cache is ``{"ckv": (B, T, kv_lora_rank), "kr": (B, T,
    qk_rope_dim)}``.

    Decode re-expands K and V from the latent cache every step (the
    reference implementation's form); ``absorbed=True`` folds ``kv_b``'s
    K half into the query and its V half into the output, attending in the
    latent space (``kv_b``'s adapter is then not applied, as in the
    reference)."""
    lora = lora or {}
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qk_dim = nope + rope_d
    scale = qk_dim ** -0.5
    hx = norm(p["ln"], x, cfg.norm_eps)

    def proj(name, inp):
        return dense(p[name], inp, lora.get(name), alpha)

    # query path
    cq = norm(p["q_ln"], proj("q_a", hx), cfg.norm_eps)
    q = proj("q_b", cq).reshape(hx.shape[:2] + (h, qk_dim))
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    # latent kv path
    ckv_full = proj("kv_a", hx)
    ckv, k_rope = (ckv_full[..., :cfg.kv_lora_rank],
                   ckv_full[..., cfg.kv_lora_rank:])
    ckv = norm(p["kv_ln"], ckv, cfg.norm_eps)

    if mode in ("full", "prefill"):
        s = x.shape[1]
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q_rope = apply_rope(q_rope, positions[None], cfg.rope_theta, "full")
        kr = _rope_key(k_rope, positions[None], cfg.rope_theta)
        k, v = _expand_kv(p, lora, ckv, kr, cfg, alpha)
        qg = torch.cat([q_nope, q_rope], -1).reshape(
            x.shape[:2] + (h, 1, qk_dim))
        out = _attend_chunked(qg, k, v, causal=block.causal, window=0,
                              q_positions=positions, k_positions=positions,
                              scale=scale, cap=0.0)
        y = dense(p["o"], out.reshape(x.shape[:2] + (h * vd,)),
                  lora.get("o"), alpha)
        new_cache = None
        if mode == "prefill":
            t_cap = capacity or s
            if t_cap < s:
                raise ValueError(f"mla_forward: capacity {t_cap} is shorter "
                                 f"than the prompt ({s})")
            pad = (0, 0, 0, t_cap - s)
            new_cache = {"ckv": torch.nn.functional.pad(ckv, pad),
                         "kr": torch.nn.functional.pad(kr, pad)}
        return y, new_cache
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}; options: full | prefill | "
                         "decode")

    pos = int(pos)
    posb = torch.full((1, 1), pos, device=x.device)
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta, "full")
    ckv_c = _write_slot(cache["ckv"], ckv, pos)
    kr_c = _write_slot(cache["kr"], _rope_key(k_rope, posb, cfg.rope_theta),
                       pos)
    t = ckv_c.shape[1]
    valid = torch.arange(t, device=x.device) <= pos
    if absorbed:
        # fold kv_b's K half into the query: q_lat = q_nope @ W_bk^T
        wkb = p["kv_b"]["w"].reshape(cfg.kv_lora_rank, h, nope + vd)
        wk, wv = wkb[..., :nope], wkb[..., nope:]
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk)    # (B,1,H,R)
        s_lat = torch.einsum("bqhr,btr->bhqt", q_lat, ckv_c)
        s_rope = torch.einsum("bqhd,btd->bhqt", q_rope, kr_c)
        scores = ((s_lat + s_rope) * scale).float().masked_fill_(
            ~valid, NEG_INF)
        probs = torch.softmax(scores, -1).to(x.dtype)
        ctx_lat = torch.einsum("bhqt,btr->bqhr", probs, ckv_c)  # (B,1,H,R)
        out = torch.einsum("bqhr,rhv->bqhv", ctx_lat, wv)
    else:
        k, v = _expand_kv(p, lora, ckv_c, kr_c, cfg, alpha)
        qg = torch.cat([q_nope, q_rope], -1).reshape(
            x.shape[:2] + (h, 1, qk_dim))
        out = _attend_decode(qg, k, v, valid, scale, 0.0)
    y = dense(p["o"], out.reshape(x.shape[:2] + (h * vd,)), lora.get("o"),
              alpha)
    return y, {"ckv": ckv_c, "kr": kr_c}


def mla_init_cache(cfg, block, batch: int, seq_len: int, dtype,
                   device=None) -> dict:
    return {"ckv": torch.zeros((batch, seq_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, seq_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device)}
