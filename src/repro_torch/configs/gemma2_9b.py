"""gemma2-9b [dense] -- local/global alternating attention, logit
softcapping, pre+post block norms, GeGLU. [arXiv:2408.00118]

42L d_model=3584 16H (GQA kv=8, head_dim 256) d_ff=14336 vocab=256000.
Alternation unit: (local SWA-4096, global); 21 repeats.  Half the layers
are sliding-window (a ring cache of 4096 slots); the global layers keep a
full KV cache.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="gemma2-9b",
    arch_type="dense",
    source="arXiv:2408.00118",
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense", window=4096),
                        BlockSpec(kind="gqa", ffn="dense")),
                  repeat=21),),
    rope_kind="full",
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=256 ** -0.5,      # query_pre_attn_scalar = head_dim
    post_block_norm=True,
    mlp_act="gelu",               # GeGLU
    tie_embeddings=True,
)
