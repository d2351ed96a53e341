"""deepseek-v3-671b [moe] -- MLA latent attention, 1 shared + 256 routed
experts top-8, dense prefix, MTP head. [arXiv:2412.19437]

61L d_model=7168 128H (MLA) per-expert d_ff=2048 vocab=129280.
First 3 layers dense (d_ff 18432 in the real model; the assignment pins
d_ff=2048 as the routed-expert width and we use the model card's 18432 for
the dense prefix/shared expert path scaled via moe conventions).
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,                 # v head dim; qk dims below (MLA)
    d_ff=18432,                   # dense-prefix MLP width (model card)
    vocab_size=129280,
    stages=(
        Stage(unit=(BlockSpec(kind="mla", ffn="dense"),), repeat=3),
        Stage(unit=(BlockSpec(kind="mla", ffn="moe"),), repeat=58),
    ),
    rope_kind="full",
    rope_theta=10_000.0,
    # MLA geometry (model card)
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    # MoE: 256 routed top-8 + 1 shared, expert width 2048 (assignment)
    n_experts=256,
    n_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    mlp_act="silu",
    mtp_depth=1,                  # one MTP module (paper's D=1 deployment)
)
