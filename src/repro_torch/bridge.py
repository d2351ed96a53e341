"""Carry weights between the JAX package and the port as numpy arrays.

The bridge imports no JAX: callers hand it ``np.asarray`` of the JAX side's
leaves.  Parameter and adapter trees are nested dicts; both packages keep
the same layouts (dense (fan_out, fan_in), conv kernels HWIO, LoRA A
(r, fan_in) / B (fan_out, r)), so a leaf changes container, never layout.
bf16 travels as its uint16 bit pattern (numpy has no bf16 of its own).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.tree import tree_map

PyTree = Any


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree: PyTree, device="cuda") -> PyTree:
    """A JAX-package parameter or adapter tree (numpy leaves; adapters'
    rank leaves int32) as port tensors on ``device``: the card unless the
    caller asks for the CPU, as every entry point of the port; a CUDA
    device must exist."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, device), tree)


#: adapters carry no layout of their own to convert: same conversion
from_jax_adapters = from_jax_params


def to_numpy(tree: PyTree) -> PyTree:
    """A port tree as numpy arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    def one(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree_map(one, tree)
