"""granite-moe-3b-a800m [moe] -- 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512, vocab=49155,
MoE 40e top-8 on every layer.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="moe"),), repeat=32),),
    rope_kind="full",
    rope_theta=10_000.0,
    n_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    mlp_act="silu",
    tie_embeddings=True,
)
