"""Shared building blocks of the big-model zoo, as functions on tensor dicts.

The JAX package's conventions, kept at every public function:

* dense kernels are stored ``(..., fan_in, fan_out)`` and applied as
  ``x @ w`` -- leading dims are the stacked-repeat axes;
* LoRA pairs keep the ``repro_torch.lora`` layout: A ``(..., r_max,
  fan_in)``, B ``(..., fan_out, r_max)``, scaled by ``alpha / max(rank, 1)``;
* activations and matmuls run in the config dtype (bf16), norms in fp32.

Initialisers draw from an explicit ``torch.Generator`` on the generator's
device.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.lora import DEFAULT_ALPHA

PyTree = Any


def dtype_of(cfg) -> torch.dtype:
    """The config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


# ----------------------------------------------------------------- dense ----
def dense_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype, *,
               bias: bool = False, scale: float | None = None) -> dict:
    s = (1.0 / fan_in) ** 0.5 if scale is None else scale
    p = {"w": torch.randn((fan_in, fan_out), generator=gen, dtype=dtype,
                          device=gen.device) * s}
    if bias:
        p["b"] = torch.zeros((fan_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Mapping, x: torch.Tensor, lora_pair: Mapping | None = None,
          alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    if lora_pair is not None:
        scale = alpha / lora_pair["rank"].float().clamp(min=1.0)
        ax = x @ lora_pair["A"].to(x.dtype).transpose(-1, -2)
        y = y + (ax @ lora_pair["B"].to(x.dtype).transpose(-1, -2)) \
            * scale.to(x.dtype)
    return y


# ----------------------------------------------------------------- norms ----
def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: Mapping, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def norm_init(cfg, dim: int | None = None, device=None) -> dict:
    dim = dim or cfg.d_model
    if cfg.mlp_act == "gelu_plain":      # whisper family uses LayerNorm
        return layernorm_init(dim, device=device)
    return rmsnorm_init(dim, device=device)


def norm(p: Mapping, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if "bias" in p:                      # LayerNorm
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
        return out.to(x.dtype)
    return rmsnorm(p, x, eps)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ------------------------------------------------------------------ rope ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               kind: str = "full") -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable (..., seq).

    The rotated part is split into two contiguous halves (not interleaved
    pairs); ``"half"`` rotates the first ``head_dim // 2`` and passes the
    rest through (chatglm3), ``"none"`` returns x.  Angles in fp32, the
    result in x's dtype."""
    if kind == "none":
        return x
    hd = x.shape[-1]
    rot = hd if kind == "full" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)                 # (rot/2,)
    ang = positions[..., None].float() * freqs               # (..., s, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if kind == "half" else out


# ------------------------------------------------------------- embedding ----
def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> dict:
    return {"table": torch.randn((vocab, dim), generator=gen, dtype=dtype,
                                 device=gen.device) * 0.02}


def embed(p: Mapping, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def unembed(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T
