"""Operations one LoRA training step of a decoder-only GQA model needs,
from its shapes: batch ``b`` of sequences of ``s`` tokens, live rank
``rank``, one multiply-add counted as two.

* the frozen matmuls (q, k, v, o, gate, up, down a layer and the output
  head) forward, and once more for the activations' gradients (the frozen
  weights take none);
* attention's two products on the causal triangle (keys within the
  window) forward, and twice that backward (four products);
* each LoRA pair's two thin products forward, and twice that backward
  (the factors' gradients and the input's);

and nothing for a recompute: activation checkpointing is not work the
step needs."""
from __future__ import annotations


def _pairs(cfg: dict) -> list:
    """(fan_in, fan_out) of each adapted projection of a layer."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    q, kv, f = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, cfg["d_ff"]
    return [(d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f), (f, d)]


def attended(s: int, window: int) -> int:
    """Query-key pairs of a causal sequence of ``s`` with a window."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def forward(cfg: dict, b: int, s: int, rank: int) -> dict:
    t = b * s
    layers = cfg["n_layers"]
    dense = sum(2 * t * fi * fo for fi, fo in _pairs(cfg)) * layers
    head = 2 * t * cfg["d_model"] * cfg["vocab_size"]
    attn = (2 * 2 * b * attended(s, cfg.get("window", 0))
            * cfg["n_heads"] * cfg["head_dim"] * layers)
    lora = sum(2 * t * rank * (fi + fo) for fi, fo in _pairs(cfg)) * layers
    return {"dense": dense + head, "attention": attn, "lora": lora}


def step_flops(cfg: dict, b: int, s: int, rank: int) -> int:
    f = forward(cfg, b, s, rank)
    return 2 * f["dense"] + 3 * f["attention"] + 3 * f["lora"]
