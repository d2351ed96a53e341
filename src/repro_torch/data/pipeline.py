"""Batch index sampling for the clients' local steps.

Client datasets are padded to a common length (see ``partition``); each
step's batch is drawn as indices below the client's true sample count.
"""
from __future__ import annotations

import torch


def sample_batch_indices(gen: torch.Generator, n_true: int, batch: int,
                         n_steps: int) -> torch.Tensor:
    """(n_steps, batch) int64 indices uniform in [0, n_true), on
    ``gen``'s device."""
    u = torch.rand((n_steps, batch), generator=gen, device=gen.device)
    return (u * float(max(int(n_true), 1))).to(torch.int64)
