"""Staircase non-IID partitioner (paper Section 5.2).

Client 1 holds samples of label 0 only; client 2 holds labels {0,1}; ...
client N holds all labels -- a long-tail "stair" over label diversity.
Per-client sample counts also grow with the stair (specialized clinics are
small, general hospitals are big, in the paper's analogy).

The LoRA rank ratio assigned to each client scales with its label count:
``rank_i = max(1, round(r_max * ratio_step * n_labels_i))`` with
``ratio_step = 0.1`` per the paper.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .synthetic import Dataset


class ClientData(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    n: int                 # true sample count (arrays may be padded)
    labels: tuple[int, ...]
    rank: int


def staircase_partition(ds: Dataset, n_clients: int, r_max: int,
                        ratio_step: float = 0.1, seed: int = 42,
                        pad_to_max: bool = True) -> list[ClientData]:
    rng = np.random.default_rng(seed)
    n_classes = int(ds.y.max()) + 1
    by_label = {c: np.flatnonzero(ds.y == c) for c in range(n_classes)}
    for idx in by_label.values():
        rng.shuffle(idx)
    cursor = {c: 0 for c in range(n_classes)}

    # label c is held by clients c..n_clients-1  -> split its samples among
    # them with weights growing toward later clients (long tail).
    shares: dict[int, list[tuple[int, int]]] = {c: [] for c in range(n_classes)}
    for c in range(n_classes):
        holders = list(range(min(c, n_clients - 1), n_clients))
        base = len(by_label[c]) // len(holders)
        counts = [base] * len(holders)
        counts[-1] += len(by_label[c]) - base * len(holders)
        for h, k in zip(holders, counts):
            shares[c].append((h, max(int(k), 1)))

    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        for h, k in shares[c]:
            lo = cursor[c]
            client_idx[h].extend(by_label[c][lo:lo + k].tolist())
            cursor[c] += k

    clients = []
    max_n = max(len(ix) for ix in client_idx)
    for i, ix in enumerate(client_idx):
        ix = np.asarray(ix, np.int64)
        rng.shuffle(ix)
        x, y = ds.x[ix], ds.y[ix]
        n = len(ix)
        if pad_to_max and n < max_n:    # pad by resampling (uniform jit shapes)
            extra = rng.choice(ix, size=max_n - n, replace=True) if n else \
                np.zeros(max_n, np.int64)
            x = np.concatenate([x, ds.x[extra]])
            y = np.concatenate([y, ds.y[extra]])
        labels = tuple(sorted(set(int(v) for v in ds.y[ix]))) if n else ()
        n_labels = len(labels)
        rank = max(1, round(r_max * ratio_step * max(n_labels, 1)))
        clients.append(ClientData(x, y, n, labels, min(rank, r_max)))
    return clients
