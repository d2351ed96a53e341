"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit): bf16 and
fp16 989 TFLOP/s, TF32 495, fp32 67 outside the tensor cores, HBM3 3.35
TB/s.  A card set below 700 W reads its share against the same peak,
with its power limit beside it."""
from __future__ import annotations

H100 = {"bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes": 3.35e12}


def for_device(kind: str | None) -> dict | None:
    """The peaks of the card called ``kind`` (None for a CPU or an unknown
    card: no share is read there)."""
    if kind and "H100" in kind:
        return H100
    return None
