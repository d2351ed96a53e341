"""Client-side local fine-tuning (paper Alg. 2).

Two modes:

* ``lora`` -- base dense kernels frozen; trainable = LoRA adapters + all
  non-LoRA'd base params (biases, convs, norms).  The paper's ZP/RBLA client.
* ``fft``  -- full fine-tune of every parameter (the FFT baseline).

``local_fit`` is a Python loop over steps with autograd; the adapters are
re-masked after every optimizer step, so padded rows stay exactly zero.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.data.pipeline import sample_batch_indices
from repro_torch.kernels.runtime import resolve_device
from repro_torch.lora import attach_ranks, mask_adapters, strip_ranks
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def split_base_params(params: dict, lora_specs) -> tuple[dict, dict]:
    """-> (frozen, trainable).  Freeze the 'w' of every LoRA'd dense."""
    frozen, trainable = {}, {}
    for k, v in params.items():
        if k in lora_specs:
            frozen[k] = {"w": v["w"]}
            rest = {kk: vv for kk, vv in v.items() if kk != "w"}
            if rest:
                trainable[k] = rest
        else:
            trainable[k] = v
    return frozen, trainable


def merge_base_params(frozen: dict, trainable: dict) -> dict:
    out = {}
    for k in list(frozen) + [k for k in trainable if k not in frozen]:
        out[k] = {**frozen.get(k, {}), **trainable.get(k, {})}
    return out


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


class LocalFitResult(NamedTuple):
    adapters: PyTree           # updated adapters (lora mode) or the input
    base_trainable: PyTree     # updated trainable base params
    loss: torch.Tensor         # mean loss over local steps


def make_local_fit(model, optimizer: Optimizer, batch_size: int,
                   n_steps: int, mode: str = "lora", alpha: float = 16.0,
                   device="cuda") -> Callable[..., LocalFitResult]:
    """Build the client update::

        local_fit(frozen_base, base_trainable, adapters, x, y, n_true,
                  gen=None, batch_idx=None)

    ``batch_idx``: optional precomputed (n_steps, batch) index tensor;
    otherwise the indices are drawn from the torch.Generator ``gen``
    (which also feeds dropout).  Inputs must lie on ``device``.
    """
    if mode not in ("lora", "fft"):
        raise ValueError(mode)
    device = resolve_device(device)
    del alpha                   # the model's dense layers carry the LoRA alpha

    def loss_fn(trainable, ranks, frozen_base, xb, yb, gen):
        base_tr, factors = trainable
        params = merge_base_params(frozen_base, base_tr)
        adapters = attach_ranks(factors, ranks) if mode == "lora" else None
        logits = model.apply(params, adapters, xb, train=True, rng=gen)
        return softmax_xent(logits, yb)

    def local_fit(frozen_base, base_trainable, adapters, x, y, n_true,
                  gen=None, batch_idx=None) -> LocalFitResult:
        if x.device.type != device.type:
            raise ValueError(f"local_fit runs on {device}; x is on {x.device}")
        if batch_idx is None:
            if gen is None:
                raise ValueError("local_fit needs a generator or batch_idx")
            batch_idx = sample_batch_indices(gen, n_true, batch_size, n_steps)
        batch_idx = torch.as_tensor(batch_idx, device=x.device).long()
        if tuple(batch_idx.shape) != (n_steps, batch_size):
            raise ValueError(f"batch_idx {tuple(batch_idx.shape)} != "
                             f"({n_steps}, {batch_size})")
        factors, ranks = (strip_ranks(adapters) if mode == "lora"
                          else (None, None))
        trainable = (base_trainable, factors)
        opt_state = optimizer.init(trainable)
        losses = []
        for ix in batch_idx:
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            trainable)
            loss = loss_fn(live, ranks, frozen_base, x[ix], y[ix], gen)
            grads_flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
            grads = tree_map(lambda _: next(grads_flat), live)
            with torch.no_grad():
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      trainable)
                trainable = apply_updates(trainable, updates)
                if mode == "lora":
                    base_tr, fac = trainable
                    fac, _ = strip_ranks(mask_adapters(
                        attach_ranks(fac, ranks)))
                    trainable = (base_tr, fac)
            losses.append(loss.detach())
        base_tr, fac = trainable
        ad = attach_ranks(fac, ranks) if mode == "lora" else adapters
        return LocalFitResult(ad, base_tr, torch.stack(losses).mean())

    return local_fit
