"""jamba-1.5-large-398b [hybrid] -- Mamba+attention 1:7 interleave with MoE
every other layer. [arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8) d_ff=24576, MoE 16 experts top-2,
vocab=65536, ssm_state=128 (Mamba-1-style blocks in the real model; the
JAX package and the port use the Mamba2/SSD block, whose chunked scan is
the ``ssd_scan`` kernel's).  Unit of 8 layers: attention at index 4, MoE
on odd indices.
Sub-quadratic majority -> runs long_500k decode.
"""
from .base import ArchConfig, BlockSpec, Stage

_M = lambda ffn: BlockSpec(kind="mamba", ffn=ffn)
_A = lambda ffn: BlockSpec(kind="gqa", ffn=ffn)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    stages=(Stage(unit=(_M("dense"), _M("moe"), _M("dense"), _M("moe"),
                        _A("dense"), _M("moe"), _M("dense"), _M("moe")),
                  repeat=9),),
    rope_kind="none",             # jamba uses no positional encoding
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    mlp_act="silu",
)
