"""Operations one prefill of a decoder-only GQA language model needs, from
its shapes: batch ``b`` of prompts of ``s`` tokens, LoRA at live rank
``rank`` on every adapted projection, one multiply-add counted as two:
the projections and their adapters and attention over every position
(:func:`.lm_train.forward`), and the output head at each prompt's last
position only."""
from __future__ import annotations

from . import lm_train


def prefill_flops(cfg: dict, b: int, s: int, rank: int) -> int:
    f = lm_train.forward(cfg, b, s, rank)
    every_head = 2 * b * s * cfg["d_model"] * cfg["vocab_size"]
    last_head = 2 * b * cfg["d_model"] * cfg["vocab_size"]
    return f["dense"] - every_head + last_head + f["attention"] + f["lora"]
