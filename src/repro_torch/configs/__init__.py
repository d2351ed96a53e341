"""Config registry: the port's copies of the JAX package's ten archs.

The port copies the JAX package's ``ArchConfig`` schema (``base``) and
every arch: ``mamba2-1.3b`` (the attention-free model whose serving path
runs the ``ssd_scan`` kernel), the four dense GQA archs
(``h2o-danube-3-4b``, ``yi-34b``, ``chatglm3-6b``, ``gemma2-9b``), the
three MoE archs (``granite-moe-3b-a800m``; ``jamba-1.5-large-398b``, mamba
and GQA blocks with MoE; ``deepseek-v3-671b``, MLA with MoE and multi-token
prediction), the encoder-decoder ``whisper-large-v3`` (audio frames) and
the VLM ``phi-3-vision-4.2b`` (vision patches).
"""
from __future__ import annotations

from .base import INPUT_SHAPES, ArchConfig, BlockSpec, InputShape, Stage
from .chatglm3_6b import CONFIG as chatglm3_6b
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .gemma2_9b import CONFIG as gemma2_9b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .h2o_danube_3_4b import CONFIG as h2o_danube_3_4b
from .jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from .mamba2_1_3b import CONFIG as mamba2_1_3b
from .phi_3_vision_4_2b import CONFIG as phi_3_vision_4_2b
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .yi_34b import CONFIG as yi_34b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [h2o_danube_3_4b, deepseek_v3_671b, mamba2_1_3b,
                        whisper_large_v3, jamba_1_5_large_398b,
                        granite_moe_3b_a800m, phi_3_vision_4_2b, gemma2_9b,
                        yi_34b, chatglm3_6b]}

#: archs of the JAX package that the port has no config for: none
NOT_PORTED: tuple[str, ...] = ()


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ArchConfig", "BlockSpec", "InputShape", "Stage", "INPUT_SHAPES",
           "ARCHS", "NOT_PORTED", "get_config"]
