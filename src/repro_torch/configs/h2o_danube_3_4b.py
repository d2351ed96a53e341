"""h2o-danube-3-4b [dense] -- llama+mistral mix with sliding-window
attention. [arXiv:2401.16818]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096
(mistral-style) on every layer -> qualifies for long_500k decode via the
ring-buffer window cache.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    source="arXiv:2401.16818",
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense", window=4096),),
                  repeat=24),),
    rope_kind="full",
    rope_theta=10_000.0,
    mlp_act="silu",
)
