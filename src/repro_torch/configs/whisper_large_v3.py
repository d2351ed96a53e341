"""whisper-large-v3 [audio] -- encoder-decoder transformer backbone.
[arXiv:2212.04356]

32 encoder + 32 decoder layers, d_model=1280 20H (MHA) d_ff=5120
vocab=51866.  The mel-spectrogram + conv frontend is a STUB per the
assignment carve-out: ``input_specs()`` feeds precomputed frame embeddings
(batch, 1500, 1280).  GELU fc1/fc2 MLPs, learned positions (modeled as
sinusoidal-free: rope none + absolute embedding).
"""
from .base import ArchConfig, BlockSpec, Stage

CONFIG = ArchConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense",
                                  cross_attn=True),), repeat=32),),
    encoder_stages=(Stage(unit=(BlockSpec(kind="gqa", ffn="dense",
                                          causal=False),), repeat=32),),
    encoder_seq=1500,
    rope_kind="none",
    qkv_bias=True,
    mlp_act="gelu_plain",
    frontend="audio_frames",
    frontend_dim=1280,
    norm_eps=1e-5,
)
