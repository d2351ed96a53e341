"""Client participation for synchronous rounds (paper: full, and random
20%).  ``ClientLatencyModel`` waits for the async slice."""
from __future__ import annotations

import numpy as np


def select_clients(n_clients: int, round_ix: int, fraction: float = 1.0,
                   seed: int = 42) -> list[int]:
    if fraction >= 1.0:
        return list(range(n_clients))
    rng = np.random.default_rng(np.random.SeedSequence([seed, round_ix]))
    k = max(1, int(round(fraction * n_clients)))
    return sorted(rng.choice(n_clients, size=k, replace=False).tolist())
