"""Batch index sampling for the clients' local steps, and epochs.

Client datasets are padded to a common length (see ``partition``); each
step's batch is drawn as indices below the client's true sample count.
:func:`epoch_batches` is the reference's host-side shuffled epoch (the
same numpy permutation), :func:`device_batches` its iterator of tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


def sample_batch_indices(gen: torch.Generator, n_true: int, batch: int,
                         n_steps: int) -> torch.Tensor:
    """(n_steps, batch) int64 indices uniform in [0, n_true), on
    ``gen``'s device."""
    u = torch.rand((n_steps, batch), generator=gen, device=gen.device)
    return (u * float(max(int(n_true), 1))).to(torch.int64)


def epoch_batches(n: int, batch: int, seed: int) -> np.ndarray:
    """Host-side shuffled epoch index matrix (n_batches, batch)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_batches = n // batch
    return idx[: n_batches * batch].reshape(n_batches, batch)


def device_batches(x: np.ndarray, y: np.ndarray, batch: int, seed: int,
                   device="cuda"):
    """One epoch of ``(x, y)`` batches as tensors on ``device`` (a CUDA
    device must exist), in :func:`epoch_batches`' order."""
    device = resolve_device(device)
    for ix in epoch_batches(len(x), batch, seed):
        yield (torch.as_tensor(x[ix], device=device),
               torch.as_tensor(y[ix], device=device))
