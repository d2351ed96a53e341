"""SGD and Adam/AdamW as pure functions over tensor trees.

The exact update formulas of the JAX package's ``repro.optim.optimizers``
(not ``torch.optim``, whose Nesterov and eps placement differ):

    init(params)                  -> state
    update(grads, state, params)  -> (updates, state)   # added to params

``lr`` is a float or a schedule (a callable of the step count).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _resolve_lr(lr, count: int):
    return lr(count) if callable(lr) else lr


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"count": 0, "mu": mu}

    def update(grads, state, params=None):
        del params
        count = state["count"] + 1
        step = _resolve_lr(lr, count)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            eff = (tree_map(lambda m, g: momentum * m + g, mu, grads)
                   if nesterov else mu)
        else:
            mu, eff = None, grads
        updates = tree_map(lambda g: -step * g, eff)
        return updates, {"count": count, "mu": mu}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled decay when ``weight_decay > 0``)."""
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        step = _resolve_lr(lr, count)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        c = torch.tensor(count, dtype=torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c

        def upd(m_, v_, p=None):
            u = -step * (m_ / c1) / ((v_ / c2).sqrt() + eps)
            if weight_decay and p is not None:
                u = u - step * weight_decay * p.float()
            return u
        updates = (tree_map(upd, m, v) if params is None
                   else tree_map(upd, m, v, params))
        return updates, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """``opt`` after scaling the gradients by ``min(1, max_norm / (norm +
    1e-12))``, ``norm`` the fp32 global L2 norm over every leaf."""
    def init(params):
        return opt.init(params)

    def update(grads, state, params=None):
        sq = sum(g.float().square().sum() for g in tree_leaves(grads))
        norm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(grads, state, params)

    return Optimizer(init, update)
