"""Dense feed-forward blocks on tensor dicts: SwiGLU (``silu``: llama, yi,
h2o-danube, chatglm3), GeGLU (``gelu``, the tanh approximation: gemma2)
and the plain GELU fc1/fc2 pair (``gelu_plain``: whisper).

The JAX package's ``repro.models.mlp`` in plain PyTorch ops; no kernel
lies on this path."""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from .common import dense, dense_init, dtype_of, norm, norm_init


def mlp_init(gen: torch.Generator, cfg, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    dt = dtype_of(cfg)
    p = {"ln": norm_init(cfg, device=gen.device)}
    if cfg.mlp_act == "gelu_plain":
        p["fc1"] = dense_init(gen, d, f, dt, bias=True)
        p["fc2"] = dense_init(gen, f, d, dt, bias=True)
    else:
        p["gate"] = dense_init(gen, d, f, dt)
        p["up"] = dense_init(gen, d, f, dt)
        p["down"] = dense_init(gen, f, d, dt)
    if cfg.post_block_norm:
        p["post_ln"] = norm_init(cfg, device=gen.device)
    return p


def mlp_lora_targets(cfg) -> tuple[str, ...]:
    return (("fc1", "fc2") if cfg.mlp_act == "gelu_plain"
            else ("gate", "up", "down"))


def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_forward(p: Mapping, lora: Mapping | None, x: torch.Tensor, cfg,
                alpha: float = 16.0) -> torch.Tensor:
    lora = lora or {}
    h = norm(p["ln"], x, cfg.norm_eps)
    if cfg.mlp_act == "gelu_plain":
        y = dense(p["fc2"], F.gelu(dense(p["fc1"], h, lora.get("fc1"), alpha),
                                   approximate="tanh"),
                  lora.get("fc2"), alpha)
    else:
        y = dense(p["down"],
                  _act(cfg, dense(p["gate"], h, lora.get("gate"), alpha))
                  * dense(p["up"], h, lora.get("up"), alpha),
                  lora.get("down"), alpha)
    if cfg.post_block_norm:
        y = norm(p["post_ln"], y, cfg.norm_eps)
    return y
