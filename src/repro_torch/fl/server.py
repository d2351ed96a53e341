"""Server-side aggregation over adapter trees (paper Alg. 1).

Deprecated veneer kept for the JAX package's keyword call sites; new code
calls the strategy directly::

    from repro_torch.core import get_strategy
    state = get_strategy("rbla").aggregate(state, client_updates)
"""
from __future__ import annotations

import warnings
from typing import Any, Sequence

import torch

from repro_torch.core.aggregation import fedavg_leaf
from repro_torch.core.strategy import get_strategy, stack_trees
from repro_torch.tree import tree_map

PyTree = Any

_DEPRECATION = ("repro_torch.fl.server.%s is deprecated; use repro_torch."
                "core.get_strategy(method).%s instead")


def aggregate_adapters(client_adapters: Sequence[PyTree], weights,
                       method: str = "rbla", r_max: int | None = None,
                       client_ranks=None, prev_global: PyTree | None = None,
                       backend: str = "auto") -> PyTree:
    """Aggregate per-client adapter trees into the global adapter with the
    registered strategy ``method``; the live rank is reset to r_max.
    ``backend`` is ``auto | ref | kernel | distributed``."""
    warnings.warn(_DEPRECATION % ("aggregate_adapters", "aggregate_adapters"),
                  DeprecationWarning, stacklevel=2)
    return get_strategy(method).aggregate_adapters(
        client_adapters, weights, r_max=r_max, client_ranks=client_ranks,
        prev_global=prev_global, backend=backend)


def aggregate_base(client_params: Sequence[PyTree], weights) -> PyTree:
    """Plain FedAvg for non-LoRA trainables."""
    warnings.warn(_DEPRECATION % ("aggregate_base", "aggregate"),
                  DeprecationWarning, stacklevel=2)
    w = torch.as_tensor(weights, dtype=torch.float32)
    return tree_map(lambda x: fedavg_leaf(x, w.to(x.device)),
                    stack_trees(client_params))
