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
from torch.distributed.tensor import DTensor

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
def _summed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums reduced (its shards kept) before a norm: a
    norm's backward through a partial sum leaves DTensor gradients it has
    no strategy for on a 3-D mesh.  Anything else as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: Mapping, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = _summed(x).float()
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
        xf = _summed(x).float()
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


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation (B, ...) in the layout every block starts from:
    the batch over the data axes where it divides them (the rules' batch
    layout), everything else whole -- a partial sum reduced, a sharded
    feature gathered.  Left to itself, DTensor's propagation picks layouts
    (a sequence sharded over "model", strided shards after a reshape) that
    later matmuls have no strategy for.  A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding import P, rules
    mesh = x.device_mesh
    want = rules.placements(P(rules.batch_axes(mesh, x.shape[0]),
                              *([None] * (x.ndim - 1))), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def embed(p: Mapping, ids: torch.Tensor) -> torch.Tensor:
    if isinstance(p["table"], DTensor):
        return _embed_on_mesh(p["table"], ids)
    return p["table"][ids]


def _embed_on_mesh(table, ids: torch.Tensor):
    """The rows of a DTensor ``table`` (V, d) at ``ids``, each rank looking
    up the ids its vocabulary shard holds and zeroing the rest: the
    result is a partial sum over the mesh dimensions that shard the
    vocabulary (the reference's sharded gather), its batch placed as the
    ids are.  A table sharded on d (``fsdp``) is gathered on d first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    by_vocab = [isinstance(pl, Shard) and pl.dim == 0
                for pl in table.placements]
    t_pl = tuple(Shard(0) if v else Replicate() for v in by_vocab)
    i_pl = (ids.placements if isinstance(ids, DTensor)
            else (Replicate(),) * mesh.ndim)
    i_pl = tuple(Replicate() if v else pl for v, pl in zip(by_vocab, i_pl))
    o_pl = tuple(Partial() if v else pl for v, pl in zip(by_vocab, i_pl))
    rows = table.shape[0]
    for dim, v in enumerate(by_vocab):
        if v:
            rows //= mesh.size(dim)
    # this rank's first row: its coordinate over the vocabulary's mesh
    # dimensions, in the mesh's order
    first = 0
    for dim, v in enumerate(by_vocab):
        if v:
            first = first * mesh.size(dim) + mesh.get_local_rank(dim)
    first *= rows

    def lookup(t, i):
        local = i - first
        inside = (local >= 0) & (local < rows)
        out = t[local.clamp(0, rows - 1)]
        return out * inside[..., None].to(out.dtype)
    return local_map(lookup, out_placements=list(o_pl),
                     in_placements=(t_pl, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def unembed(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T


class MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the meta device.

    Every initialiser draws on ``gen.device`` with ``generator=gen``; this
    one reports ``meta``, which accepts a CPU generator, so
    ``Model.init(MetaGenerator())`` and ``init_adapters`` build their trees'
    shapes and dtypes without memory: the port's counterpart of
    ``jax.eval_shape`` over them.  On the card and the CPU the draws are
    untouched."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")
