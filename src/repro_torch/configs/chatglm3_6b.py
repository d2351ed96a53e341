"""chatglm3-6b [dense] -- 2d (half-dim) RoPE, extreme GQA (kv=2), QKV bias.
[arXiv:2406.12793]

28L d_model=4096 32H (GQA kv=2, head_dim 128) d_ff=13696 vocab=65024.
Pure full attention: the KV cache grows with the context, so long_500k
decode is skipped.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="chatglm3-6b",
    arch_type="dense",
    source="arXiv:2406.12793",
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense"),), repeat=28),),
    rope_kind="half",             # rotary on the first half of head_dim
    rope_theta=10_000.0,
    qkv_bias=True,
    mlp_act="silu",
)
