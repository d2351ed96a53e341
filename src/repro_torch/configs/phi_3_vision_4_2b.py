"""phi-3-vision-4.2b [vlm] -- phi3-mini backbone + CLIP vision stub.
[hf:microsoft/Phi-3-vision-128k-instruct]

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.  The ViT/CLIP
encoder is a STUB per the carve-out: ``input_specs()`` feeds precomputed
patch embeddings (batch, 576, 1024); the trainable projector
(1024 -> d_model, LoRA-able) and the language backbone are real.
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense"),), repeat=32),),
    rope_kind="full",
    rope_theta=10_000.0,
    mlp_act="silu",
    frontend="vision_patches",
    frontend_dim=1024,
    n_prefix_tokens=576,
)
