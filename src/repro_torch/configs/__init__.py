"""Config registry of the archs the port runs.

The port copies the JAX package's ``ArchConfig`` schema (``base``) and, so
far, one architecture: ``mamba2-1.3b``, the attention-free model whose
serving path runs the ``ssd_scan`` kernel.  The JAX package's other nine
archs need attention, MLPs or MoE, which the port does not have yet; asking
for one raises ``NotImplementedError``.
"""
from __future__ import annotations

from .base import INPUT_SHAPES, ArchConfig, BlockSpec, InputShape, Stage
from .mamba2_1_3b import CONFIG as mamba2_1_3b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [mamba2_1_3b]}

#: archs of the JAX package that wait for attention, MLPs and MoE in the
#: port (ROADMAP item 19b)
NOT_PORTED = ("h2o-danube-3-4b", "deepseek-v3-671b", "whisper-large-v3",
              "jamba-1.5-large-398b", "granite-moe-3b-a800m",
              "phi-3-vision-4.2b", "gemma2-9b", "yi-34b", "chatglm3-6b")


def get_config(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it needs attention, MLP or "
            "MoE blocks, which arrive with ROADMAP item 19b; ported: "
            f"{sorted(ARCHS)}")
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ArchConfig", "BlockSpec", "InputShape", "Stage", "INPUT_SHAPES",
           "ARCHS", "NOT_PORTED", "get_config"]
