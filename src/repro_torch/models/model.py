"""Top-level Model: config -> params/adapters/caches + the serving functions.

The port's counterpart of the JAX package's ``repro.models.model``, for
decoder-only stacks of the blocks the port has (``transformer``: Mamba2).
Entry points (pure functions of their arguments):

  forward(params, adapters, batch, mode)           -> (logits, caches|None)
  prefill(params, adapters, batch)                 -> (last_logits, caches)
  decode_step(params, adapters, caches, token, pos)-> (logits, caches)

Parameters live on the device of the generator given to :meth:`Model.init`;
``scan_backend`` picks the SSD scan of every mamba layer (``"auto"``: the
``ssd_scan`` kernel for CUDA tensors, its plain version on the CPU;
``"ref"``: the plain version everywhere).  The encoder-decoder, vision
front-end and multi-token-prediction branches, and ``loss``, wait for
ROADMAP item 19b.
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
    remat: Any = True            # accepted; the port runs forward only
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
    def _trunk(self, params, adapters, x, mode, caches=None, pos=None):
        """The stages over embedded inputs x; returns (hidden, caches)."""
        new_caches = []
        for i, stage in enumerate(self.cfg.stages):
            slora = adapters.get("stages")[i] if adapters else None
            x, c = stage_forward(
                params["stages"][i], slora, x, self.cfg, stage, mode=mode,
                caches=None if caches is None else caches[i], pos=pos,
                alpha=self.alpha, remat=self.remat,
                scan_backend=self.scan_backend)
            new_caches.append(c)
        return x, tuple(new_caches)

    def _head(self, params, x):
        cfg = self.cfg
        x = norm(params["final_ln"], x, cfg.norm_eps)
        logits = (unembed(params["embed"], x) if cfg.tie_embeddings
                  else dense(params["lm_head"], x))
        return softcap(logits, cfg.final_softcap)

    def forward(self, params, adapters, batch, mode: str = "full"):
        """Full-sequence forward.  Returns (logits, caches or None)."""
        if mode not in ("full", "prefill"):
            raise ValueError(f"forward: mode {mode!r}; options: full | "
                             "prefill (decode_step decodes)")
        x = embed(params["embed"], batch["tokens"])
        x, caches = self._trunk(params, adapters, x, mode)
        return self._head(params, x), (caches if mode == "prefill" else None)

    def loss(self, params, adapters, batch):
        raise _not_ported("Model.loss (training)")

    def _mtp_loss(self, params, adapters, batch, logits):
        raise _not_ported("the multi-token-prediction loss")

    # ------------------------------------------------------------- serve ----
    def init_cache(self, batch_size: int, device="cuda") -> PyTree:
        """Zero decode state of every layer.  A mamba layer's state has no
        sequence axis, so the reference's ``seq_len`` (a KV cache's length)
        returns with attention (item 19b)."""
        cfg = self.cfg
        dt = dtype_of(cfg)
        device = runtime.resolve_device(device)
        caches = []
        for stage in cfg.stages:
            unit = {}
            for i, spec in enumerate(stage.unit):
                c1 = block_init_cache(cfg, spec, batch_size, dt, device)
                unit[f"b{i}"] = tree_map(
                    lambda t: t[None].expand((stage.repeat,) + t.shape)
                    .clone(), c1)
            caches.append(unit)
        return tuple(caches)

    def prefill(self, params, adapters, batch):
        """(last-position logits (B, V), caches).  Only the last position
        goes through the head: the logits of every other position would be
        dropped."""
        x = embed(params["embed"], batch["tokens"])
        x, caches = self._trunk(params, adapters, x, "prefill")
        return self._head(params, x[:, -1]), caches

    def decode_step(self, params, adapters, caches, token: torch.Tensor,
                    pos):
        """token: (B,) int; pos: the absolute position (unused by the
        mamba mixer, kept for the reference's signature)."""
        x = embed(params["embed"], token[:, None])
        x, new_caches = self._trunk(params, adapters, x, "decode",
                                    caches=caches, pos=pos)
        return self._head(params, x)[:, 0], new_caches


def make_model(cfg, remat=True, scan_backend: str = "auto") -> Model:
    return Model(cfg=cfg, remat=remat, scan_backend=scan_backend)
