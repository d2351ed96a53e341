"""Paged multi-tenant adapter store (the FLaaS serving read path).

A FLaaS server coordinates many tenants whose LoRA adapters share a base
model but differ in **rank**.  Serving them with one kernel launch per
layer needs all tenants' (A, B) factors in a layout where "which adapter,
at which rank" is runtime data, never a shape.  The :class:`AdapterStore`
provides that layout:

* **Buckets.**  Pairs bucket by **(fan_out, fan_in, dtype)**, the pair
  geometry: row p of the A buffer and row p of the B buffer must stay one
  rank-one component, so both sides of a pair share one allocation.
  Every bucket owns two row-major device buffers, ``a_rows``
  ``(R, fan_in)`` and ``b_rows`` ``(R, fan_out)`` -- B transposed so the
  packed rank axis leads both (:func:`repro_torch.core.plan.pair_side_rows`).

* **Pages.**  Buffer rows are allocated in fixed pages of ``r_max`` rows
  from a free list; one (path, tenant) segment is one page, so segments
  are contiguous, allocation and free are O(1), and a tenant's offset
  never moves while it is registered.  A tenant of rank r < r_max uses the
  first r rows of its page (the rest stay zero).  Capacity doubles when
  the free list empties: the only event that changes a buffer's shape.

* **Runtime tables.**  Per path, three per-tenant-slot device tensors --
  ``off`` (row offset), ``rank`` (live segment length), ``scale``
  (alpha / rank) -- indexed by the adapter ids a request batch carries.
  Slot 0 is the **null adapter** (rank 0): requests carrying id 0 (or an
  evicted slot) get the pure base product.

* **Snapshots and hot swap.**  Readers never touch the store directly:
  :meth:`snapshot` hands out an immutable :class:`StoreSnapshot` (buffers,
  tables, version) and every write -- :meth:`register`, :meth:`put`,
  :meth:`publish`, :meth:`remove` -- installs a new snapshot under a
  bumped version.  Batches pinning an old snapshot finish on exactly the
  bytes they started with.  A write is one fused scatter per touched
  buffer side; it copies the buffer while a handed-out snapshot of it is
  alive and writes in place otherwise (the steady-state publish: no copy,
  no new allocation) -- the JAX package's donation.

**The stream rule.**  XLA orders a donated write after every queued read of
that buffer; PyTorch orders work only within one CUDA stream, and its
caching allocator hands a freed block to the next allocation on the
freeing stream at once.  So a batch may run on any stream, and three
hazards are ruled out by events, never by host synchronisation:

1. *Write after read.*  After each launch, :meth:`note_read` records a
   ``torch.cuda.Event`` on the reading stream against the tensors it read
   (:meth:`~repro_torch.serving.ServingEngine.apply` calls it).  Before
   an in-place write the writing stream waits on every pending event of
   that buffer, so the write cannot overtake a batch queued on another
   stream -- even one whose snapshot its caller dropped the moment
   ``apply`` returned.  Events that completed (``query()``) are pruned.
2. *Read after write.*  Every write records an event on the writing
   stream after its last operation; the snapshot of that version carries
   it as :attr:`StoreSnapshot.ready`, and a reader makes its stream wait
   on it (:meth:`StoreSnapshot.wait`) before launching.  Each write also
   waits on the previous version's event first, so writes issued from
   different streams stay in order.
3. *Free while read.*  A read record holds references to the tensors it
   read until its event completes.  A buffer the store replaces (the copy
   path under a pin, capacity growth in :meth:`_Bucket.alloc_page`) or a
   table of an older version therefore cannot return to the allocator
   while a kernel on another stream still reads it.

On one stream this costs one event record per launch and per write; on
the CPU there are no events and the rule is a no-op.  One host thread
drives a store.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.plan import pair_side_rows
from repro_torch.kernels.runtime import resolve_device
from repro_torch.lora import DEFAULT_ALPHA, is_pair
from repro_torch.obs import get_registry as _obs_registry

_STORE_VERSION = _obs_registry().gauge(
    "serving_store_version", "current adapter-store version")
_STORE_PAGES = _obs_registry().gauge(
    "serving_store_pages", "bucket page capacity", labelnames=("bucket",))
_STORE_PAGES_USED = _obs_registry().gauge(
    "serving_store_pages_used", "bucket pages allocated to tenants",
    labelnames=("bucket",))
_STORE_PINNED = _obs_registry().gauge(
    "serving_pinned_snapshots",
    "handed-out store snapshots still alive (pinning their buffers)")
_STORE_PUBLISHES = _obs_registry().counter(
    "serving_publishes_total", "global hot-swaps installed into the store")

PyTree = Any

#: destination-row sentinel values of the fused scatter (see
#: :func:`_scatter_rows`): >= 0 gathers that source row, KEEP leaves the
#: old value, ZERO clears the row (a segment shrinking under publish).
_KEEP = -1
_ZERO = -2


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device``, made without a host
    synchronisation: on the card it is staged in pinned memory and copied
    asynchronously on the current stream (the caching host allocator keeps
    the staging block until the copy ran)."""
    t = torch.from_numpy(np.array(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _scatter_rows(dst: torch.Tensor, src: torch.Tensor,
                  idx: np.ndarray) -> None:
    """One fused segment write into ``dst``: row d becomes ``src[idx[d]]``
    where ``idx[d] >= 0``, zero where ``idx[d] == _ZERO``, and keeps its
    value where ``idx[d] == _KEEP``."""
    rows = np.flatnonzero(idx != _KEEP)
    if rows.size == 0:
        return
    gather = idx[rows]
    gather = np.where(gather == _ZERO, src.shape[0], gather)
    src_ext = torch.cat([src, src.new_zeros((1, src.shape[1]))])
    vals = src_ext.index_select(0, _to_device(gather.astype(np.int64),
                                              dst.device))
    dst.index_copy_(0, _to_device(rows.astype(np.int64), dst.device), vals)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class SegTable:
    """Per-path tenant-slot tables (device tensors, indexed by adapter id)."""
    off: torch.Tensor          # (T_cap,) int32 row offset into the bucket
    rank: torch.Tensor         # (T_cap,) int32 live segment length
    scale: torch.Tensor        # (T_cap,) f32 LoRA scale (alpha / rank)


@dataclasses.dataclass(frozen=True, eq=False)
class StoreSnapshot:
    """Immutable view of the store at one version.

    Everything :func:`repro_torch.kernels.batched_lora_matmul` needs:
    per-bucket packed factor buffers and per-path segment tables.  Holding
    a snapshot guarantees its buffers are never written in place -- an
    in-flight batch sees exactly this version whatever is published
    meanwhile.  ``ready`` is the event recorded after the write that made
    this version (None on the CPU).
    """
    version: int
    buffers: Mapping[tuple, tuple]       # bucket key -> (a_rows, b_rows)
    tables: Mapping[str, SegTable]
    bucket_of: Mapping[str, tuple]       # path -> bucket key
    device: torch.device
    ready: "torch.cuda.Event | None" = None

    def pair_buffers(self, path: str):
        a_rows, b_rows = self.buffers[self.bucket_of[path]]
        return a_rows, b_rows

    def table(self, path: str) -> SegTable:
        return self.tables[path]

    def wait(self) -> None:
        """Make the current stream wait for the write that produced this
        version (stream rule 2); no host synchronisation."""
        if self.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self.ready)


@dataclasses.dataclass
class _Read:
    """One launch's reads: the event recorded after it on its stream and
    the tensors it read, held until the event completes."""
    event: "torch.cuda.Event"
    tensors: tuple


class _Bucket:
    """Host-side bookkeeping for one (fan_out, fan_in, dtype) bucket."""

    def __init__(self, key, page_rows: int, n_pages: int,
                 dtype: torch.dtype, device: torch.device):
        self.key = key
        self.page_rows = page_rows
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, -1, -1))
        fan_out, fan_in, _ = key
        self.a_rows = torch.zeros((n_pages * page_rows, fan_in), dtype=dtype,
                                  device=device)
        self.b_rows = torch.zeros((n_pages * page_rows, fan_out),
                                  dtype=dtype, device=device)

    def alloc_page(self) -> int:
        if not self.free:
            # capacity growth: new, larger buffers (the old ones stay with
            # the snapshots and read records that hold them)
            new_pages = self.n_pages * 2
            extra = (new_pages - self.n_pages) * self.page_rows
            self.a_rows = torch.cat(
                [self.a_rows, self.a_rows.new_zeros((extra,
                                                     self.a_rows.shape[1]))])
            self.b_rows = torch.cat(
                [self.b_rows, self.b_rows.new_zeros((extra,
                                                     self.b_rows.shape[1]))])
            self.free = list(range(new_pages - 1, self.n_pages - 1, -1))
            self.n_pages = new_pages
        return self.free.pop()

    def free_page(self, page: int) -> None:
        self.free.append(page)


class AdapterStore:
    """Paged per-tenant (A, B) store over (fan_out, fan_in, dtype) buckets.

    Parameters
    ----------
    specs
        ``{path: (fan_out, fan_in)}`` -- the LoRA-adapted layers served.
        Paths sharing a geometry share a bucket.
    r_max
        Page size in rank rows: the largest rank any tenant may register.
    dtype
        Factor buffer dtype (all buckets).
    alpha
        Default LoRA alpha; a tenant's serve scale is ``alpha / rank``
        unless overridden per :meth:`register` / :meth:`put`.
    init_pages, init_tenant_capacity
        Initial bucket pages per path geometry and tenant-slot table size;
        both grow by doubling.
    device
        Where buffers and tables live: the card unless the caller asks for
        ``"cpu"``.
    """

    def __init__(self, specs: Mapping[str, tuple], *, r_max: int,
                 dtype=torch.float32, alpha: float = DEFAULT_ALPHA,
                 init_pages: int = 8, init_tenant_capacity: int = 8,
                 device="cuda"):
        if r_max < 1:
            raise ValueError(f"r_max must be >= 1, got {r_max}")
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.specs = {p: (int(fo), int(fi))
                      for p, (fo, fi) in specs.items()}
        self.r_max = int(r_max)
        self.dtype = dtype
        self.alpha = float(alpha)
        self._buckets: dict[tuple, _Bucket] = {}
        self._bucket_of: dict[str, tuple] = {}
        for path, (fo, fi) in self.specs.items():
            key = (fo, fi, _dtype_name(dtype))
            self._bucket_of[path] = key
            if key not in self._buckets:
                self._buckets[key] = _Bucket(key, self.r_max,
                                             max(int(init_pages), 1), dtype,
                                             self.device)
        # tenant registry: slot 0 is the reserved null adapter (rank 0)
        self._t_cap = max(int(init_tenant_capacity), 2)
        self._slot_of: dict[Any, int] = {}
        self._free_slots = list(range(self._t_cap - 1, 0, -1))
        self._page_of: dict[tuple, int] = {}       # (path, slot) -> page
        self._off = {p: np.zeros(self._t_cap, np.int32) for p in specs}
        self._rank = {p: np.zeros(self._t_cap, np.int32) for p in specs}
        self._scale = {p: np.zeros(self._t_cap, np.float32)
                       for p in specs}
        self._version = 0
        self._snapshot: StoreSnapshot | None = None
        self._live: "weakref.WeakSet[StoreSnapshot]" = weakref.WeakSet()
        self._reads: list[_Read] = []
        self._rebuild_snapshot()

    # ----------------------------------------------------------- reading --
    @property
    def version(self) -> int:
        return self._version

    @property
    def n_tenants(self) -> int:
        return len(self._slot_of)

    @property
    def pinned_snapshots(self) -> int:
        """Handed-out :class:`StoreSnapshot` objects still alive.  While
        any exist, writes to their buffers copy instead of writing in
        place."""
        return len(self._live)

    def occupancy(self) -> dict:
        """Per-bucket page occupancy: ``{bucket label: {"pages",
        "pages_used", "page_rows"}}`` -- the point-in-time view
        :class:`~repro_torch.obs.ServiceHealth` reports (the same numbers
        feed the ``serving_store_pages*`` gauges on every version bump)."""
        out = {}
        for key, b in self._buckets.items():
            out[self._bucket_label(key)] = {
                "pages": b.n_pages,
                "pages_used": b.n_pages - len(b.free),
                "page_rows": b.page_rows,
            }
        return out

    @staticmethod
    def _bucket_label(key) -> str:
        fo, fi, dtype = key
        return f"{fo}x{fi}:{dtype}"

    def tenants(self):
        return list(self._slot_of)

    def slot(self, tenant) -> int:
        """The dense adapter id requests for ``tenant`` must carry."""
        return self._slot_of[tenant]

    def snapshot(self) -> StoreSnapshot:
        """The current immutable view; pin it for the life of a batch.

        Each call hands out a fresh (shallow) snapshot object sharing the
        version's buffers: its *lifetime* is what marks those buffers as
        pinned, so writes copy instead of writing in place while any
        handed-out snapshot of them is alive."""
        snap = dataclasses.replace(self._snapshot)
        self._live.add(snap)
        _STORE_PINNED.set(len(self._live))
        return snap

    def note_read(self, tensors) -> None:
        """Record that work just queued on the current stream reads
        ``tensors`` (stream rules 1 and 3): an event after it, and the
        tensors held until the event completes.  A no-op on the CPU."""
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._prune_reads()
        self._reads.append(_Read(event, tuple(tensors)))

    def _prune_reads(self) -> None:
        self._reads = [r for r in self._reads if not r.event.query()]

    def _await_reads(self, buf: torch.Tensor) -> None:
        """Make the current stream wait for every pending read of ``buf``
        (stream rule 1)."""
        for r in self._reads:
            if any(t is buf for t in r.tensors):
                torch.cuda.current_stream(self.device).wait_event(r.event)

    def _rebuild_snapshot(self) -> None:
        buffers = {k: (b.a_rows, b.b_rows)
                   for k, b in self._buckets.items()}
        tables = {p: SegTable(off=_to_device(self._off[p], self.device),
                              rank=_to_device(self._rank[p], self.device),
                              scale=_to_device(self._scale[p], self.device))
                  for p in self.specs}
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._snapshot = StoreSnapshot(
            version=self._version, buffers=buffers, tables=tables,
            bucket_of=dict(self._bucket_of), device=self.device, ready=ready)

    def _bump(self) -> None:
        self._version += 1
        self._rebuild_snapshot()
        _STORE_VERSION.set(self._version)
        _STORE_PINNED.set(len(self._live))
        for key, b in self._buckets.items():
            label = self._bucket_label(key)
            _STORE_PAGES.labels(bucket=label).set(b.n_pages)
            _STORE_PAGES_USED.labels(bucket=label).set(
                b.n_pages - len(b.free))

    def _pinned_ids(self) -> set:
        """Identities of every buffer some live handed-out snapshot still
        references.  Writing one of these in place would tear the snapshot
        out from under an in-flight batch; anything else may be updated in
        place.  (Table bumps share buffers across versions, so pinning is
        by buffer identity, not version.)"""
        return {id(arr) for s in self._live
                for pair in s.buffers.values() for arr in pair}

    # ------------------------------------------------------- registration --
    def register(self, tenant, *, rank: int,
                 scale: float | None = None) -> int:
        """Allocate ``tenant`` a slot and one zeroed page per path at
        ``rank``; returns the adapter id.  Rows fill on the next
        :meth:`put` / :meth:`publish`."""
        if not 0 < rank <= self.r_max:
            raise ValueError(
                f"tenant rank must be in [1, r_max={self.r_max}], "
                f"got {rank}")
        self._snapshot.wait()       # growth reads the last version's bytes
        if tenant in self._slot_of:
            slot = self._slot_of[tenant]
        else:
            slot = self._alloc_slot(tenant)
        for path in self.specs:
            key = (path, slot)
            bucket = self._buckets[self._bucket_of[path]]
            if key not in self._page_of:
                self._page_of[key] = bucket.alloc_page()
            self._off[path][slot] = self._page_of[key] * bucket.page_rows
            self._rank[path][slot] = rank
            self._scale[path][slot] = (self.alpha / max(rank, 1)
                                       if scale is None else scale)
        self._bump()
        return slot

    def _alloc_slot(self, tenant) -> int:
        if not self._free_slots:
            new_cap = self._t_cap * 2
            for p in self.specs:
                self._off[p] = np.pad(self._off[p],
                                      (0, new_cap - self._t_cap))
                self._rank[p] = np.pad(self._rank[p],
                                       (0, new_cap - self._t_cap))
                self._scale[p] = np.pad(self._scale[p],
                                        (0, new_cap - self._t_cap))
            self._free_slots = list(range(new_cap - 1,
                                          self._t_cap - 1, -1))
            self._t_cap = new_cap
        slot = self._free_slots.pop()
        self._slot_of[tenant] = slot
        return slot

    def remove(self, tenant) -> None:
        """Evict a tenant: free its pages and slot.  Requests still
        carrying the stale id serve the base model (rank 0)."""
        self._snapshot.wait()
        slot = self._slot_of.pop(tenant)
        for path in self.specs:
            page = self._page_of.pop((path, slot), None)
            if page is not None:
                self._buckets[self._bucket_of[path]].free_page(page)
            self._off[path][slot] = 0
            self._rank[path][slot] = 0
            self._scale[path][slot] = 0.0
        self._free_slots.append(slot)
        self._bump()

    # -------------------------------------------------------------- writes --
    def _write(self, writes: dict) -> None:
        """Apply ``{bucket key: {'a'|'b': (src_rows, idx)}}`` -- one fused
        scatter per touched buffer side: into a copy while a live snapshot
        pins the buffer, in place otherwise, after every pending read of
        it (stream rule 1)."""
        self._snapshot.wait()
        pinned = self._pinned_ids()
        self._prune_reads()
        for key, sides in writes.items():
            bucket = self._buckets[key]
            for side, (src, idx) in sides.items():
                old = bucket.a_rows if side == "a" else bucket.b_rows
                if id(old) in pinned:
                    new = old.clone()
                else:
                    self._await_reads(old)
                    new = old
                _scatter_rows(new, src, idx)
                if side == "a":
                    bucket.a_rows = new
                else:
                    bucket.b_rows = new
        self._bump()

    def _pair_rows(self, path: str, pair: Mapping):
        """A pair's rank-leading packed rows on the store's device, checked
        against the spec."""
        fo, fi = self.specs[path]
        A, B = pair["A"], pair["B"]
        if A.ndim != 2 or B.ndim != 2:
            raise ValueError(
                f"serving packs 2-D pairs; {path} has A{tuple(A.shape)} "
                f"B{tuple(B.shape)} (flatten layer-stacked pairs into one "
                "path per layer)")
        if A.shape[1] != fi or B.shape[0] != fo:
            raise ValueError(
                f"{path}: pair A{tuple(A.shape)}/B{tuple(B.shape)} does not "
                f"match spec (fan_out={fo}, fan_in={fi})")
        rank = int(pair["rank"])
        a_rows = pair_side_rows(A, "A").to(self.device, self.dtype)
        b_rows = pair_side_rows(B, "B").to(self.device, self.dtype)
        return a_rows, b_rows, rank

    def put(self, tenant, adapters: PyTree, *,
            scale: float | None = None) -> int:
        """Install (or replace) one tenant's personalized adapters.

        ``adapters``: ``{path: pair}`` covering every spec path.  The
        tenant's rank/scale tables follow the pairs' rank leaves; returns
        the adapter id.
        """
        pairs = {p: adapters[p] for p in self.specs}
        for p, pair in pairs.items():
            if not is_pair(pair):
                raise ValueError(f"{p}: not a LoRA pair")
        ranks = {p: int(pair["rank"]) for p, pair in pairs.items()}
        slot = self.register(tenant, rank=max(max(ranks.values()), 1),
                             scale=scale)
        writes: dict = {}
        for path, pair in pairs.items():
            a_rows, b_rows, rank = self._pair_rows(path, pair)
            self._rank[path][slot] = rank
            self._scale[path][slot] = (self.alpha / max(rank, 1)
                                       if scale is None else scale)
            bucket = self._buckets[self._bucket_of[path]]
            off = int(self._off[path][slot])
            sides = writes.setdefault(bucket.key,
                                      {"a": ([], []), "b": ([], [])})
            for side, rows in (("a", a_rows), ("b", b_rows)):
                sides[side][0].append(rows[:rank])
                sides[side][1].append((off, rank))
        self._write(self._assemble(writes))
        return slot

    def _assemble(self, writes: dict) -> dict:
        """Concatenate per-bucket source rows and build the full-buffer
        scatter index (host-side, O(bucket rows) int32)."""
        out: dict = {}
        for key, sides in writes.items():
            bucket = self._buckets[key]
            out[key] = {}
            for side, (srcs, segs) in sides.items():
                width = (bucket.a_rows if side == "a"
                         else bucket.b_rows).shape[1]
                idx = np.full(bucket.n_pages * bucket.page_rows, _KEEP,
                              np.int32)
                src_off = 0
                for rows, (off, cnt) in zip(srcs, segs):
                    idx[off:off + cnt] = np.arange(
                        src_off, src_off + cnt, dtype=np.int32)
                    # clear the rest of the page: stale rows from a
                    # higher-rank past must not survive the new segment
                    idx[off + cnt:off + bucket.page_rows] = _ZERO
                    src_off += cnt
                src = (torch.cat(srcs, dim=0) if srcs else
                       torch.zeros((0, width), dtype=self.dtype,
                                   device=self.device))
                out[key][side] = (src, idx)
        return out

    def publish(self, tree: PyTree) -> int:
        """Hot-swap a freshly aggregated global into every tenant segment.

        ``tree``: ``{path: pair}`` -- the server's global adapter tree
        (e.g. ``ServerState.adapters``).  Every registered tenant's
        segment for each path is rewritten with the global's first
        ``min(tenant_rank, global_rank)`` rank rows (the paper's Alg. 2
        re-slice, materialized server-side); rows past the global rank
        are zeroed.  One fused scatter per bucket side, in place when no
        in-flight snapshot pins the buffer; returns the new version.
        Reads each pair's rank on the host (a device rank leaf costs one
        synchronisation; a CPU one none).
        """
        writes: dict = {}
        for path in self.specs:
            pair = tree[path]
            a_rows, b_rows, g_rank = self._pair_rows(path, pair)
            bucket = self._buckets[self._bucket_of[path]]
            sides = writes.setdefault(bucket.key,
                                      {"a": ([], []), "b": ([], [])})
            for slot in self._slot_of.values():
                t_rank = int(self._rank[path][slot])
                cnt = min(t_rank, g_rank)
                off = int(self._off[path][slot])
                for side, rows in (("a", a_rows), ("b", b_rows)):
                    sides[side][0].append(rows[:cnt])
                    sides[side][1].append((off, cnt))
        self._write(self._assemble(writes))
        _STORE_PUBLISHES.inc()
        return self._version

    # ------------------------------------------------------------ readback --
    def get(self, tenant) -> PyTree:
        """Read a tenant's pairs back out (tests / debugging; copies)."""
        slot = self._slot_of[tenant]
        snap = self.snapshot()
        snap.wait()
        out = {}
        for path, (fo, fi) in self.specs.items():
            a_rows, b_rows = snap.pair_buffers(path)
            off = int(self._off[path][slot])
            r = int(self._rank[path][slot])
            page = torch.zeros((self.r_max, fi), dtype=self.dtype,
                               device=self.device)
            page_b = torch.zeros((self.r_max, fo), dtype=self.dtype,
                                 device=self.device)
            page[:r] = a_rows[off:off + r]
            page_b[:r] = b_rows[off:off + r]
            self.note_read((a_rows, b_rows))
            out[path] = {"A": page,
                         "B": pair_side_rows(page_b, "B").contiguous(),
                         "rank": torch.tensor(r, dtype=torch.int32,
                                              device=self.device)}
        return out


__all__ = ["AdapterStore", "StoreSnapshot", "SegTable"]
