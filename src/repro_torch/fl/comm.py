"""Communication layer: per-round cost accounting and the async server's
upload buffer.

Cost accounting (paper motivation: LoRA cuts per-round bytes; RBLA keeps
that benefit while fixing aggregation) counts the bytes a client uploads
per round (and the server broadcast), per aggregation method:

* lora methods (rbla / zeropad / variants): the padded adapter tree --
  but a client of rank r only needs to ship its live rows, so the honest
  per-client cost is the rank-sliced adapter (+ the non-LoRA trainables);
  we report both padded and sliced numbers.
* fft: the full parameter tree.

:class:`UpdateBuffer` is the buffered semi-async server's intake queue:
uploads accumulate and flush as one mini-cohort on size K or deadline
(see ``repro_torch.fl.async_agg`` / ``docs/async.md``).  The buffer
itself stays metrics-free; its owning
:class:`~repro_torch.fl.AsyncAggregator` exports the live depth
(``fl_buffer_depth``), per-upload staleness (``fl_staleness``) and wire
bytes (``fl_wire_bytes_received_total``) through :mod:`repro_torch.obs`.
Byte counts are ``numel() * element_size()`` of each tensor leaf.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.lora import tree_map_pairs
from repro_torch.tree import tree_leaves

PyTree = Any


# ------------------------------------------------- idempotent ingestion --
class DedupWindow:
    """Sliding window of recently seen client ``update_id`` strings.

    At-least-once delivery (client retries, WAL replay after a crash)
    means the server can receive the same logical upload twice; folding
    it twice double-counts its mass.  The window remembers the last
    ``size`` *accepted* ids so a redelivery inside the window is
    recognized and folded exactly once.  A duplicate arriving after its
    id has been evicted is indistinguishable from a new upload -- size
    the window to cover the longest plausible retry horizon (ids are
    small strings; 10k ids is a few hundred KB).

    :meth:`state_dict` / :meth:`load_state_dict` carry the window in a
    service snapshot.
    """

    def __init__(self, size: int = 1024):
        if size < 1:
            raise ValueError(f"dedup window size must be >= 1, got {size}")
        self.size = int(size)
        self._seen: OrderedDict[str, None] = OrderedDict()

    def __len__(self) -> int:
        return len(self._seen)

    def __contains__(self, update_id: str) -> bool:
        return str(update_id) in self._seen

    def add(self, update_id: str) -> None:
        """Mark one id seen (moves it to most-recent on re-add)."""
        uid = str(update_id)
        self._seen.pop(uid, None)
        self._seen[uid] = None
        while len(self._seen) > self.size:
            self._seen.popitem(last=False)

    def state_dict(self) -> list:
        """Oldest-first id list for the durable snapshot."""
        return list(self._seen)

    def load_state_dict(self, ids: Iterable[str]) -> None:
        self._seen.clear()
        for uid in ids:
            self.add(uid)


class RetryPolicy:
    """Jittered exponential backoff for client re-uploads.

    ``delay(attempt)`` is the wait before retry ``attempt`` (0-based):
    ``base * factor**attempt``, capped at ``max_delay``, times a uniform
    jitter in ``[1 - jitter, 1 + jitter]`` -- the jitter decorrelates a
    thundering herd of clients retrying a flaky server in lockstep.
    Deterministic: the jitter stream is seeded, and ``attempt`` indexes
    it, so a simulator replays identical schedules.  ``give_up(attempt)``
    is True once ``max_retries`` is exhausted.
    """

    def __init__(self, base: float = 1.0, factor: float = 2.0,
                 max_delay: float = 60.0, max_retries: int = 5,
                 jitter: float = 0.1, seed: int = 0):
        if base <= 0 or factor < 1.0 or max_delay <= 0:
            raise ValueError(
                f"need base > 0, factor >= 1, max_delay > 0; got "
                f"base={base}, factor={factor}, max_delay={max_delay}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.base = float(base)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.max_retries = int(max_retries)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def give_up(self, attempt: int) -> bool:
        return attempt >= self.max_retries

    def delay(self, attempt: int, salt: int = 0) -> float:
        """Backoff before 0-based retry ``attempt`` (``salt`` decorrelates
        independent clients sharing one policy)."""
        d = min(self.base * self.factor ** max(attempt, 0), self.max_delay)
        if self.jitter:
            rng = np.random.default_rng(
                (self.seed, int(salt), int(attempt)))
            d *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return d


# ---------------------------------------------------- semi-async buffering --
@dataclasses.dataclass
class BufferedUpdate:
    """One upload waiting in the semi-async buffer."""
    update: Any                 # repro_torch.core.ClientUpdate
    weight: float               # effective mass (staleness already applied)
    staleness: float = 0.0      # server versions behind at arrival
    arrived: float = 0.0        # service clock at arrival
    wire_bytes: int = 0         # bytes as uploaded (post-codec, pre-decode)


class UpdateBuffer:
    """Flush-on-K-or-deadline intake queue for the async server.

    ``size=1`` means fully-async (every add is immediately due);
    ``deadline`` (same clock units the caller passes as ``now``) bounds
    how long the oldest buffered upload may wait before a flush is due
    even if the buffer is not full -- stragglers cannot stall the round,
    and quick clients cannot starve the stragglers out of it.
    """

    def __init__(self, size: int = 1, deadline: float | None = None):
        if size < 1:
            raise ValueError(f"buffer size must be >= 1, got {size}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        self.size = int(size)
        self.deadline = deadline
        self._items: list[BufferedUpdate] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, update, weight: float, staleness: float = 0.0,
            now: float = 0.0, wire_bytes: int = 0) -> None:
        self._items.append(BufferedUpdate(update=update,
                                          weight=float(weight),
                                          staleness=float(staleness),
                                          arrived=float(now),
                                          wire_bytes=int(wire_bytes)))

    def due(self, now: float = 0.0) -> bool:
        """Is a flush due -- K updates waiting, or the oldest past the
        deadline?"""
        if not self._items:
            return False
        if len(self._items) >= self.size:
            return True
        return (self.deadline is not None
                and now - self._items[0].arrived >= self.deadline)

    def next_deadline(self) -> float | None:
        """Clock time at which the oldest buffered update makes a flush
        due (None when empty or no deadline is configured) -- event loops
        schedule their deadline check here."""
        if self.deadline is None or not self._items:
            return None
        return self._items[0].arrived + self.deadline

    def total_weight(self) -> float:
        """Total effective mass currently buffered.  The flush path
        checks this before mixing: a zero-mass batch (every weight
        staleness-discounted to 0) has no convex combination and must be
        dropped, not aggregated into ``0 / 0``."""
        return float(sum(b.weight for b in self._items))

    def total_wire_bytes(self) -> int:
        """Bytes currently buffered as uploaded -- quantized payloads
        count at their wire dtype, which is the whole point of shipping
        them quantized."""
        return sum(b.wire_bytes for b in self._items)

    def pop(self) -> list[BufferedUpdate]:
        """Drain the buffer in arrival order."""
        items, self._items = self._items, []
        return items


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def tree_bytes(tree: PyTree) -> int:
    return sum(_leaf_bytes(x) for x in tree_leaves(tree))


def adapter_upload_bytes(adapters: PyTree, rank: int | None = None) -> int:
    """Bytes a client ships for its adapters.

    ``rank=None``: padded r_max layout (what zero-padding FLaaS ships).
    ``rank=r``: rank-sliced (what a rank-r client actually needs to send
    under RBLA -- the server re-pads; Alg. 2 slicing in reverse).
    """
    total = 0

    def per_pair(pair):
        nonlocal total
        a, b = pair["A"], pair["B"]
        r_max = a.shape[-2]
        r = r_max if rank is None else min(rank, r_max)
        frac = r / r_max
        total += int(_leaf_bytes(a) * frac) + int(_leaf_bytes(b) * frac)
        total += _leaf_bytes(pair["rank"])
        return pair

    tree_map_pairs(per_pair, adapters)
    return total


def round_cost_report(params: PyTree, adapters: PyTree,
                      base_trainable: PyTree,
                      client_ranks) -> dict:
    """Per-round communication summary across methods."""
    full = tree_bytes(params)
    base_tr = tree_bytes(base_trainable)
    padded = adapter_upload_bytes(adapters)
    sliced = [adapter_upload_bytes(adapters, int(r)) for r in client_ranks]
    return {
        "fft_upload_bytes_per_client": full,
        "lora_padded_upload_bytes": padded + base_tr,
        "lora_sliced_upload_bytes_mean": int(np.mean(sliced)) + base_tr,
        "lora_sliced_upload_bytes": [s + base_tr for s in sliced],
        "broadcast_bytes": padded + base_tr,
        "reduction_vs_fft": full / max(int(np.mean(sliced)) + base_tr, 1),
    }
