"""yi-34b [dense] -- llama-architecture GQA. [arXiv:2403.04652]

60L d_model=7168 56H (GQA kv=8, head_dim 128) d_ff=20480 vocab=64000.
Pure full attention: the KV cache grows with the context, so long_500k
decode is skipped.  Its bf16 weights alone are about 69 GB.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="yi-34b",
    arch_type="dense",
    source="arXiv:2403.04652",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense"),), repeat=60),),
    rope_kind="full",
    rope_theta=5_000_000.0,
    mlp_act="silu",
)
