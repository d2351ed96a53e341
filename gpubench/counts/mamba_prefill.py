"""Operations one prefill of a Mamba-2 model needs, from its shapes: batch
``b`` of prompts of ``l`` tokens, LoRA at live rank ``rank`` on the in and
out projections, one multiply-add counted as two: the projections and
their adapters, the causal conv, the chunked scan (``counts/ssd_scan``),
and the tied output head at each prompt's last position only."""
from __future__ import annotations

from . import ssd_scan


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    n = cfg["ssm_state"]
    h = d_in // cfg["ssm_head_dim"]
    return {"d": d, "d_in": d_in, "n": n, "h": h, "p": cfg["ssm_head_dim"],
            "proj": 2 * d_in + 2 * n + h, "conv": d_in + 2 * n}


def scan_flops(cfg: dict, b: int, l: int) -> int:
    m = dims(cfg)
    q = min(cfg["ssm_chunk"], l)
    return ssd_scan.flops(b, l, m["h"], m["p"], m["n"], q) * cfg["n_layers"]


def prefill_flops(cfg: dict, b: int, l: int, rank: int) -> int:
    m = dims(cfg)
    t = b * l
    per_layer = (2 * t * m["d"] * m["proj"] + 2 * t * m["d_in"] * m["d"]
                 + 2 * t * rank * (m["d"] + m["proj"])
                 + 2 * t * rank * (m["d_in"] + m["d"])
                 + 2 * t * cfg["ssm_conv"] * m["conv"])
    head = 2 * b * m["d"] * cfg["vocab_size"]
    return per_layer * cfg["n_layers"] + scan_flops(cfg, b, l) + head
