"""Top-level Model: config -> params/adapters/caches + the train and serve
functions.

The port's counterpart of the JAX package's ``repro.models.model``: stacks
of the blocks in ``transformer`` (GQA or MLA attention with the dense MLP
or the MoE, and Mamba2), decoder-only or encoder-decoder, with the
reference's front-end stubs.  Entry points (pure functions of their
arguments):

  forward(params, adapters, batch, mode, capacity)  -> (logits, caches|None)
  loss(params, adapters, batch)                     -> scalar CE (+ MTP)
  prefill(params, adapters, batch, capacity)        -> (last_logits, caches)
  decode_step(params, adapters, caches, token, pos) -> (logits, caches)

Parameters live on the device of the generator given to :meth:`Model.init`;
``scan_backend`` picks the SSD scan of every mamba layer (``"auto"``: the
``ssd_scan`` kernel for CUDA tensors, its plain version on the CPU;
``"ref"``: the plain version everywhere).  Attention, RoPE and the MLP are
plain PyTorch, so ``loss`` is differentiable by autograd; the ``ssd_scan``
kernel has no backward, so a mamba model trains on the card with
``scan_backend="ref"``.  ``mla_absorbed`` picks MLA's absorbed decode.
With ``cfg.mtp_depth`` (deepseek-v3) ``init`` adds the ``mtp`` subtree
and ``loss`` adds ``0.3 *`` the multi-token-prediction term, as the
reference writes it (:meth:`Model._mtp_loss`).

Front-ends (the reference's stubs: precomputed embeddings come in, the
projector ``frontend.proj`` and its adapter are real).  An
encoder-decoder (``cfg.encoder_stages``, whisper) takes ``batch
["frames"]`` (B, T, frontend_dim): :meth:`_encode` projects them, adds the
learned positions ``enc.pos[:T]`` and runs the encoder stages in full
mode; every cross-attention block of the decoder reads that output, and
``prefill`` caches its keys and values so that ``decode_step`` needs no
encoder.  ``cfg.frontend == "vision_patches"`` (phi-3-vision) takes
``batch["patches"]`` (B, n_prefix, frontend_dim), projected and prepended
to the token embeddings (:meth:`_embed_inputs`); positions span the
prefix, ``forward`` drops the prefix's logits, and a decode position
counts the prefix (``prompt + n_prefix + i``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels import runtime
from repro_torch.lora import init_pair
from repro_torch.tree import tree_map

from .common import (dense, dense_init, dtype_of, embed, embed_init, norm,
                     norm_init, softcap, unembed)
from .transformer import (block_forward, block_init, block_init_cache,
                          stage_forward, stage_init, stage_lora_init)

PyTree = Any


@dataclass(frozen=True)
class Model:
    cfg: Any
    remat: Any = True            # accepted; autograd keeps what it needs
    alpha: float = 16.0
    scan_backend: str = "auto"   # auto | kernel | ref
    mla_absorbed: bool = False   # MLA's absorbed decode

    def __post_init__(self):
        runtime.resolve_backend(self.scan_backend, "cpu")

    @property
    def n_prefix(self) -> int:
        """The patch positions a VLM puts before every prompt (0 for the
        other archs): decode positions count them."""
        cfg = self.cfg
        return cfg.n_prefix_tokens if cfg.frontend == "vision_patches" else 0

    # ------------------------------------------------------------ params ----
    def init(self, gen: torch.Generator) -> PyTree:
        cfg = self.cfg
        dt = dtype_of(cfg)
        p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt)}
        p["stages"] = tuple(stage_init(gen, cfg, s) for s in cfg.stages)
        p["final_ln"] = norm_init(cfg, device=gen.device)
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
        if cfg.is_encdec:
            p["enc"] = {
                "stages": tuple(stage_init(gen, cfg, s)
                                for s in cfg.encoder_stages),
                "final_ln": norm_init(cfg, device=gen.device),
                "pos": torch.randn((cfg.encoder_seq, cfg.d_model),
                                   generator=gen, dtype=dt,
                                   device=gen.device) * 0.02,
            }
        if cfg.frontend != "none":
            p["frontend"] = {"proj": dense_init(gen, cfg.frontend_dim,
                                                cfg.d_model, dt)}
        if cfg.mtp_depth:
            p["mtp"] = {
                "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dt),
                "block": block_init(gen, cfg, cfg.stages[-1].unit[-1]),
                "ln": norm_init(cfg, device=gen.device),
            }
        return p

    # ---------------------------------------------------------- adapters ----
    def init_adapters(self, gen: torch.Generator, r_max: int | None = None,
                      rank: int | None = None) -> PyTree:
        cfg = self.cfg
        r_max = r_max or cfg.lora_r_max
        rank = rank if rank is not None else r_max
        ad: dict = {"stages": tuple(stage_lora_init(gen, cfg, s, r_max, rank)
                                    for s in cfg.stages)}
        if cfg.is_encdec:
            ad["enc"] = {"stages": tuple(
                stage_lora_init(gen, cfg, s, r_max, rank)
                for s in cfg.encoder_stages)}
        if cfg.frontend != "none":
            ad["frontend"] = {"proj": init_pair(
                gen, cfg.d_model, cfg.frontend_dim, r_max, rank)}
        return ad

    # ----------------------------------------------------------- encoder ----
    def _frontend(self, params, adapters, x):
        """``frontend.proj`` with its adapter over x cast to the config's
        dtype."""
        return dense(params["frontend"]["proj"], x.to(dtype_of(self.cfg)),
                     (adapters or {}).get("frontend", {}).get("proj"),
                     self.alpha)

    def _encode(self, params, adapters, frames):
        """The encoder over ``frames`` (B, T, frontend_dim): the projected
        frames plus ``enc.pos[:T]``, the encoder stages in full mode, then
        ``enc.final_ln``."""
        cfg = self.cfg
        enc = params["enc"]
        x = self._frontend(params, adapters, frames)
        s = x.shape[1]
        x = x + enc["pos"][:s][None]
        enc_lora = (adapters or {}).get("enc")
        positions = torch.arange(s, device=x.device)
        for i, stage in enumerate(cfg.encoder_stages):
            slora = enc_lora["stages"][i] if enc_lora else None
            x, _ = stage_forward(enc["stages"][i], slora, x, cfg, stage,
                                 mode="full", positions=positions,
                                 alpha=self.alpha, remat=self.remat,
                                 scan_backend=self.scan_backend)
        return norm(enc["final_ln"], x, cfg.norm_eps)

    def _embed_inputs(self, params, adapters, batch):
        """Token embeddings, after the projected patches of a VLM.
        Returns (x, n_prefix)."""
        x = embed(params["embed"], batch["tokens"])
        if self.cfg.frontend != "vision_patches":
            return x, 0
        proj = self._frontend(params, adapters, batch["patches"])
        return torch.cat([proj.to(x.dtype), x], 1), proj.shape[1]

    # ----------------------------------------------------------- forward ----
    def _trunk(self, params, adapters, x, mode, caches=None, pos=None,
               enc_out=None, capacity=None):
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
                enc_out=enc_out, alpha=self.alpha, remat=self.remat,
                scan_backend=self.scan_backend,
                mla_absorbed=self.mla_absorbed, capacity=capacity)
            new_caches.append(c)
        return x, tuple(new_caches)

    def _prompt(self, params, adapters, batch, mode, capacity=None):
        """The encoder (if any), the embedded inputs and the stages over a
        whole prompt; returns (hidden, caches, n_prefix)."""
        enc_out = (self._encode(params, adapters, batch["frames"])
                   if self.cfg.is_encdec else None)
        x, n_prefix = self._embed_inputs(params, adapters, batch)
        x, caches = self._trunk(params, adapters, x, mode, enc_out=enc_out,
                                capacity=capacity)
        return x, caches, n_prefix

    def _unembed(self, params, x):
        return (unembed(params["embed"], x) if self.cfg.tie_embeddings
                else dense(params["lm_head"], x))

    def _head(self, params, x):
        cfg = self.cfg
        x = norm(params["final_ln"], x, cfg.norm_eps)
        return softcap(self._unembed(params, x), cfg.final_softcap)

    def forward(self, params, adapters, batch, mode: str = "full",
                capacity: int | None = None):
        """Full-sequence forward.  Returns (logits, caches or None)."""
        if mode not in ("full", "prefill"):
            raise ValueError(f"forward: mode {mode!r}; options: full | "
                             "prefill (decode_step decodes)")
        x, caches, n_prefix = self._prompt(params, adapters, batch, mode,
                                           capacity)
        return (self._head(params, x[:, n_prefix:]),
                caches if mode == "prefill" else None)

    def loss(self, params, adapters, batch) -> torch.Tensor:
        """Mean next-token cross-entropy: fp32 log-softmax of
        ``logits[:, :-1]`` against ``tokens[:, 1:]``; with ``mtp_depth``,
        plus ``0.3 *`` :meth:`_mtp_loss`."""
        logits, _ = self.forward(params, adapters, batch, mode="full")
        main = _next_token_nll(logits[:, :-1], batch["tokens"][:, 1:])
        if self.cfg.mtp_depth:
            main = main + 0.3 * self._mtp_loss(params, adapters, batch,
                                               logits)
        return main

    def _mtp_loss(self, params, adapters, batch, logits):
        """DeepSeek-V3 multi-token prediction (depth 1), as the reference
        writes it: predict token t + 2 from the normed re-embedding of
        token t joined with the embedding of t + 1, through ``mtp/proj``
        and one block of the last stage's last kind, run without adapters,
        then the (unnormed, uncapped) output head."""
        del adapters, logits
        cfg = self.cfg
        tok = batch["tokens"]
        h = embed(params["embed"], tok)
        nxt = embed(params["embed"], tok[:, 1:])
        mtp = params["mtp"]
        cat = torch.cat([norm(mtp["ln"], h[:, :-1], cfg.norm_eps), nxt], -1)
        x = dense(mtp["proj"], cat)
        x, _ = block_forward(mtp["block"], None, x, cfg,
                             cfg.stages[-1].unit[-1], mode="full",
                             positions=torch.arange(x.shape[1],
                                                    device=x.device),
                             scan_backend=self.scan_backend)
        return _next_token_nll(self._unembed(params, x)[:, :-1], tok[:, 2:])

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
        dropped.  ``capacity``: the KV caches' length (at least the prompt's
        with a VLM's prefix; default that), so that decode continues in
        them; a mamba layer ignores it.  An encoder-decoder's caches hold
        each cross-attention layer's encoder keys and values."""
        x, caches, _ = self._prompt(params, adapters, batch, "prefill",
                                    capacity)
        return self._head(params, x[:, -1]), caches

    def decode_step(self, params, adapters, caches, token: torch.Tensor,
                    pos):
        """token: (B,) int; pos: the absolute position (an int or a 0-d
        tensor) of ``token``, where attention writes its KV cache (a VLM's
        counts its prefix).  Cross-attention reads the encoder's keys and
        values from the caches."""
        x = embed(params["embed"], token[:, None])
        x, new_caches = self._trunk(params, adapters, x, "decode",
                                    caches=caches, pos=pos)
        return self._head(params, x)[:, 0], new_caches


def _next_token_nll(logits: torch.Tensor, targets: torch.Tensor):
    """Mean of ``-log_softmax(logits)`` (fp32) at ``targets``."""
    lp = torch.log_softmax(logits.float(), -1)
    return -lp.gather(-1, targets[..., None].long())[..., 0].mean()


def make_model(cfg, remat=True, scan_backend: str = "auto",
               mla_absorbed: bool = False) -> Model:
    return Model(cfg=cfg, remat=remat, scan_backend=scan_backend,
                 mla_absorbed=mla_absorbed)
