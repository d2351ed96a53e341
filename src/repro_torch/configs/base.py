"""Architecture config schema + input-shape registry.

Every assigned architecture is expressed as an ``ArchConfig`` whose layer
stack is a sequence of *stages*; each stage is a repeating *unit* of block
specs whose parameters are stacked over its repeats (a leading ``repeat``
axis on every leaf), and the forward walks the repeats in a loop.

Heterogeneous interleaves (Jamba's 1-attn:7-mamba, gemma2's local/global
alternation, deepseek's dense prefix) are expressed as multi-block units or
multi-stage stacks -- never unrolled python loops over all layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

AttnKind = Literal["gqa", "mla", "mamba"]
FFNKind = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class BlockSpec:
    """One layer inside a repeating unit."""
    kind: AttnKind = "gqa"          # token mixer
    ffn: FFNKind = "dense"
    window: int = 0                 # 0 = global attention, >0 = SWA width
    cross_attn: bool = False        # decoder block attending to encoder
    causal: bool = True


@dataclass(frozen=True)
class Stage:
    unit: tuple[BlockSpec, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.unit) * self.repeat


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                        # dense|moe|ssm|audio|hybrid|vlm
    source: str                           # paper / model-card citation
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stages: tuple[Stage, ...]
    # encoder (enc-dec archs only)
    encoder_stages: tuple[Stage, ...] = ()
    encoder_seq: int = 0                  # native encoder length (whisper 1500)
    # attention details
    rope_kind: str = "full"               # full | half | none
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: float | None = None      # None -> 1/sqrt(head_dim)
    qkv_bias: bool = False                # chatglm3 uses qkv bias
    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    router_scale: float = 1.0
    capacity_factor: float = 1.25
    moe_mode: str = "sort"                # sort | ep_a2a (perf variant)
    moe_pad_experts: int = 0              # physical padding for EP
                                          # divisibility (SSPerf B1)
    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # modality frontend stub
    frontend: str = "none"                # none | audio_frames | vision_patches
    frontend_dim: int = 0                 # raw embedding dim fed by the stub
    n_prefix_tokens: int = 0              # vision patches prepended
    # MLP
    mlp_act: str = "silu"                 # silu (SwiGLU) | gelu (GeGLU) |
                                          # gelu_plain (fc1/fc2, whisper)
    # norms
    post_block_norm: bool = False         # gemma2 post-norms
    norm_eps: float = 1e-6
    # heads / misc
    tie_embeddings: bool = False
    mtp_depth: int = 0                    # deepseek multi-token prediction
    dtype: str = "bfloat16"
    # LoRA
    lora_targets: str = "all_dense"
    lora_r_max: int = 64

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def is_encdec(self) -> bool:
        return bool(self.encoder_stages)

    @property
    def has_full_attention(self) -> bool:
        return any(b.kind != "mamba" and b.window == 0
                   for s in self.stages for b in s.unit)

    @property
    def subquadratic(self) -> bool:
        """True if decode state does not grow linearly-unbounded with
        context for the *majority* mixer type (SSM / SWA)."""
        blocks = [b for s in self.stages for b in s.unit]
        unbounded = [b for b in blocks if b.kind != "mamba" and b.window == 0]
        return len(unbounded) < len(blocks)

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        small_stages = tuple(
            Stage(unit=s.unit, repeat=1) for s in self.stages[:2]) or \
            self.stages
        # keep at most 2 blocks total
        trimmed = []
        total = 0
        for s in small_stages:
            unit = s.unit[: max(1, 2 - total)]
            total += len(unit)
            trimmed.append(Stage(unit=unit, repeat=1))
            if total >= 2:
                break
        d = min(self.d_model, 256)
        hd = 32
        nh = max(2, min(self.n_heads, 4))
        nkv = max(1, min(self.n_kv_heads, 2))
        kw = dict(
            d_model=d, n_heads=nh, n_kv_heads=nkv, head_dim=hd,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            stages=tuple(trimmed),
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            # no token dropping in smoke/consistency tests: capacity-based
            # MoE drops depend on co-batch size, which would make decode
            # vs full-forward comparisons diverge by construction
            capacity_factor=8.0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=(min(self.kv_lora_rank, 32)
                          if self.kv_lora_rank else 0),
            qk_nope_dim=min(self.qk_nope_dim, 32) if self.qk_nope_dim else 0,
            qk_rope_dim=min(self.qk_rope_dim, 16) if self.qk_rope_dim else 0,
            v_head_dim=min(self.v_head_dim, 32) if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16),
            ssm_chunk=32,
            encoder_stages=tuple(Stage(unit=s.unit, repeat=1)
                                 for s in self.encoder_stages[:1]),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim
            else 0,
            n_prefix_tokens=(min(self.n_prefix_tokens, 8)
                             if self.n_prefix_tokens else 0),
            lora_r_max=8,
            mtp_depth=min(self.mtp_depth, 1),
            dtype="float32",
        )
        kw.update(overrides)
        return replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
