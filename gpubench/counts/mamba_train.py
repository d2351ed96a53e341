"""Operations one LoRA training step of a Mamba-2 model needs, from its
shapes: batch ``b`` of sequences of ``l`` tokens, live rank ``rank``, one
multiply-add counted as two.

* the frozen projections (in and out a layer), the causal conv and the
  tied head over every position, forward and once more for the
  activations' gradients (the frozen weights take none);
* the chunked scan (``counts/ssd_scan``) forward, and twice that backward;
* each LoRA pair's thin products forward, and twice that backward;

and nothing for a recompute."""
from __future__ import annotations

from . import mamba_prefill


def step_flops(cfg: dict, b: int, l: int, rank: int) -> int:
    m = mamba_prefill.dims(cfg)
    t = b * l
    frozen = (2 * t * m["d"] * m["proj"] + 2 * t * m["d_in"] * m["d"]
              + 2 * t * cfg["ssm_conv"] * m["conv"]) * cfg["n_layers"] \
        + 2 * t * m["d"] * cfg["vocab_size"]
    lora = (2 * t * rank * (m["d"] + m["proj"])
            + 2 * t * rank * (m["d_in"] + m["d"])) * cfg["n_layers"]
    return 2 * frozen + 3 * mamba_prefill.scan_flops(cfg, b, l) + 3 * lora
