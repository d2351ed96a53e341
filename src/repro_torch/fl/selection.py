"""Client participation and timing policies.

Sync rounds use :func:`select_clients` (paper: full, and random 20%).
The async/event-driven modes add :class:`ClientLatencyModel`: per-client
report latencies with a heavy straggler tail, the distribution that makes
synchronous cohorts slow and staleness weighting necessary.
"""
from __future__ import annotations

import numpy as np


def select_clients(n_clients: int, round_ix: int, fraction: float = 1.0,
                   seed: int = 42) -> list[int]:
    if fraction >= 1.0:
        return list(range(n_clients))
    rng = np.random.default_rng(np.random.SeedSequence([seed, round_ix]))
    k = max(1, int(round(fraction * n_clients)))
    return sorted(rng.choice(n_clients, size=k, replace=False).tolist())


class ClientLatencyModel:
    """Two-level log-normal report latencies.

    Device heterogeneity: client ``i`` gets a persistent median latency
    ``median_s * exp(straggler_sigma * z_i)`` (log-normal across clients
    -- a few devices are *much* slower than the rest).  Per-upload
    jitter: each report multiplies that median by ``exp(sigma * z)``.

    Each client draws from its own seeded substream, so a simulation's
    latency sequence is deterministic per (seed, client) regardless of
    how server-side events interleave.
    """

    def __init__(self, n_clients: int, median_s: float = 1.0,
                 sigma: float = 0.25, straggler_sigma: float = 1.0,
                 seed: int = 42):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        if median_s <= 0:
            raise ValueError(f"median_s must be > 0, got {median_s}")
        self.n_clients = int(n_clients)
        head = np.random.default_rng(np.random.SeedSequence([seed, 0]))
        self.client_median_s = median_s * np.exp(
            straggler_sigma * head.standard_normal(self.n_clients))
        self.sigma = float(sigma)
        self._rngs = [np.random.default_rng(
            np.random.SeedSequence([seed, 1 + i]))
            for i in range(self.n_clients)]

    def sample(self, client: int) -> float:
        """Next report latency (seconds) for ``client``."""
        rng = self._rngs[client]
        return float(self.client_median_s[client]
                     * np.exp(self.sigma * rng.standard_normal()))
