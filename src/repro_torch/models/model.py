"""Top-level Model: config -> params/adapters/caches + the train and serve
functions.

The port's counterpart of the JAX package's ``repro.models.model``, for
decoder-only stacks of the blocks the port has (``transformer``: GQA
attention with the dense MLP, and Mamba2).  Entry points (pure functions of
their arguments):

  forward(params, adapters, batch, mode, capacity)  -> (logits, caches|None)
  loss(params, adapters, batch)                     -> scalar CE
  prefill(params, adapters, batch, capacity)        -> (last_logits, caches)
  decode_step(params, adapters, caches, token, pos) -> (logits, caches)

Parameters live on the device of the generator given to :meth:`Model.init`;
``scan_backend`` picks the SSD scan of every mamba layer (``"auto"``: the
``ssd_scan`` kernel for CUDA tensors, its plain version on the CPU;
``"ref"``: the plain version everywhere).  Attention, RoPE and the MLP are
plain PyTorch, so ``loss`` is differentiable by autograd; the ``ssd_scan``
kernel has no backward, so a mamba model trains on the card with
``scan_backend="ref"``.  The encoder-decoder, vision front-end and
multi-token-prediction branches wait for ROADMAP item 19b.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import runtime
from repro_torch.tree import tree_map

from .common import (dense, dense_init, dtype_of, embed, embed_init, norm,
                     norm_init, softcap, unembed)
from .transformer import (block_init_cache, stage_forward, stage_init,
                          stage_lora_init)

PyTree = Any


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: it arrives with "
                               "ROADMAP item 19b")


@dataclass(frozen=True)
class Model:
    cfg: Any
    remat: Any = True            # accepted; autograd keeps what it needs
    alpha: float = 16.0
    scan_backend: str = "auto"   # auto | kernel | ref

    def __post_init__(self):
        cfg = self.cfg
        if cfg.is_encdec:
            raise _not_ported(f"{cfg.name}: the encoder-decoder branch")
        if cfg.frontend != "none":
            raise _not_ported(f"{cfg.name}: the {cfg.frontend} front-end")
        if cfg.mtp_depth:
            raise _not_ported(f"{cfg.name}: multi-token prediction")
        runtime.resolve_backend(self.scan_backend, "cpu")

    # ------------------------------------------------------------ params ----
    def init(self, gen: torch.Generator) -> PyTree:
        cfg = self.cfg
        dt = dtype_of(cfg)
        p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt)}
        p["stages"] = tuple(stage_init(gen, cfg, s) for s in cfg.stages)
        p["final_ln"] = norm_init(cfg, device=gen.device)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
        return p

    # ---------------------------------------------------------- adapters ----
    def init_adapters(self, gen: torch.Generator, r_max: int | None = None,
                      rank: int | None = None) -> PyTree:
        cfg = self.cfg
        r_max = r_max or cfg.lora_r_max
        rank = rank if rank is not None else r_max
        return {"stages": tuple(stage_lora_init(gen, cfg, s, r_max, rank)
                                for s in cfg.stages)}

    # ----------------------------------------------------------- forward ----
    def _trunk(self, params, adapters, x, mode, caches=None, pos=None,
               capacity=None):
        """The stages over embedded inputs x; returns (hidden, caches)."""
        positions = (torch.arange(x.shape[1], device=x.device)
                     if mode != "decode" else None)
        new_caches = []
        for i, stage in enumerate(self.cfg.stages):
            slora = adapters.get("stages")[i] if adapters else None
            x, c = stage_forward(
                params["stages"][i], slora, x, self.cfg, stage, mode=mode,
                positions=positions,
                caches=None if caches is None else caches[i], pos=pos,
                alpha=self.alpha, remat=self.remat,
                scan_backend=self.scan_backend, capacity=capacity)
            new_caches.append(c)
        return x, tuple(new_caches)

    def _head(self, params, x):
        cfg = self.cfg
        x = norm(params["final_ln"], x, cfg.norm_eps)
        logits = (unembed(params["embed"], x) if cfg.tie_embeddings
                  else dense(params["lm_head"], x))
        return softcap(logits, cfg.final_softcap)

    def forward(self, params, adapters, batch, mode: str = "full",
                capacity: int | None = None):
        """Full-sequence forward.  Returns (logits, caches or None)."""
        if mode not in ("full", "prefill"):
            raise ValueError(f"forward: mode {mode!r}; options: full | "
                             "prefill (decode_step decodes)")
        x = embed(params["embed"], batch["tokens"])
        x, caches = self._trunk(params, adapters, x, mode, capacity=capacity)
        return self._head(params, x), (caches if mode == "prefill" else None)

    def loss(self, params, adapters, batch) -> torch.Tensor:
        """Mean next-token cross-entropy: fp32 log-softmax of
        ``logits[:, :-1]`` against ``tokens[:, 1:]``."""
        logits, _ = self.forward(params, adapters, batch, mode="full")
        tok = batch["tokens"]
        lp = torch.log_softmax(logits[:, :-1].float(), -1)
        nll = -lp.gather(-1, tok[:, 1:, None].long())[..., 0]
        return nll.mean()

    def _mtp_loss(self, params, adapters, batch, logits):
        raise _not_ported("the multi-token-prediction loss")

    # ------------------------------------------------------------- serve ----
    def init_cache(self, batch_size: int, seq_len: int | None = None,
                   device="cuda") -> PyTree:
        """Zero decode state of every layer.  An attention layer's KV cache
        has ``seq_len`` slots (``min(window, seq_len)`` for an SWA layer)
        and raises ``ValueError`` without one; a mamba layer's state has no
        sequence axis and ignores it."""
        cfg = self.cfg
        dt = dtype_of(cfg)
        device = runtime.resolve_device(device)
        caches = []
        for stage in cfg.stages:
            unit = {}
            for i, spec in enumerate(stage.unit):
                c1 = block_init_cache(cfg, spec, batch_size, seq_len, dt,
                                      device)
                unit[f"b{i}"] = tree_map(
                    lambda t: t[None].expand((stage.repeat,) + t.shape)
                    .clone(), c1)
            caches.append(unit)
        return tuple(caches)

    def prefill(self, params, adapters, batch, capacity: int | None = None):
        """(last-position logits (B, V), caches).  Only the last position
        goes through the head: the logits of every other position would be
        dropped.  ``capacity``: the KV caches' length (at least the prompt's;
        default the prompt's), so that decode continues in them; a mamba
        layer ignores it."""
        x = embed(params["embed"], batch["tokens"])
        x, caches = self._trunk(params, adapters, x, "prefill",
                                capacity=capacity)
        return self._head(params, x[:, -1]), caches

    def decode_step(self, params, adapters, caches, token: torch.Tensor,
                    pos):
        """token: (B,) int; pos: the absolute position (an int or a 0-d
        tensor) of ``token``, where attention writes its KV cache."""
        x = embed(params["embed"], token[:, None])
        x, new_caches = self._trunk(params, adapters, x, "decode",
                                    caches=caches, pos=pos)
        return self._head(params, x)[:, 0], new_caches


def make_model(cfg, remat=True, scan_backend: str = "auto") -> Model:
    return Model(cfg=cfg, remat=remat, scan_backend=scan_backend)
