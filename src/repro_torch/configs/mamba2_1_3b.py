"""mamba2-1.3b [ssm] -- attention-free SSD (state-space duality).
[arXiv:2405.21060]

48L d_model=2048, d_inner=4096 (expand 2), heads=64 x head_dim 64,
ssm_state=128, vocab=50280.  No MLP blocks (d_ff=0): the Mamba2 block is
the whole layer.  Sub-quadratic -> runs long_500k decode.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    stages=(Stage(unit=(BlockSpec(kind="mamba", ffn="none"),), repeat=48),),
    rope_kind="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
