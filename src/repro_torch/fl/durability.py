"""Crash-recoverable FLaaS service: write-ahead log + checkpoint/restore
(the port's copy of ``repro.fl.durability``).

The :class:`~repro_torch.fl.AsyncAggregator` holds every byte of
accumulated aggregation state -- the live
:class:`~repro_torch.core.strategy.ServerState`, the fold masses and
momentum, bf16 accumulators, the stochastic-rounding generator, the
semi-async buffer -- in process and card memory.  One server crash would
lose all of it.  :class:`DurableAggregator` makes the service
crash-tolerant:

* **Write-ahead log** (:class:`WriteAheadLog`): every *accepted* upload is
  journaled -- still codec-encoded, int8/bf16 wire payloads go to disk as
  they arrived -- before it is buffered or folded, as a crc-framed record
  in an append-only segment file.  Externally driven ``flush`` /
  ``maybe_flush`` calls are journaled too, so replay reproduces the same
  fold grouping.
* **Periodic checkpoints**: every ``checkpoint_every`` accepted uploads
  the full service snapshot (:meth:`AsyncAggregator.state_dict`) is
  written through :func:`repro_torch.checkpoint.save_blob` (atomic
  rename-commit, checksummed); the WAL rotates, and segments that the
  oldest retained checkpoint covers are pruned.
* **Recovery**: construction over a non-empty directory restores the
  newest *valid* checkpoint (torn or corrupt ones are skipped) and replays
  the WAL tail through the normal ingestion path, on the service's device:
  on the card the replay folds with the same kernels as the first run.
  Because the fold path is deterministic under a fixed seed, the
  recovered state is **bit-identical** to the uninterrupted run; the
  :class:`~repro_torch.fl.comm.DedupWindow` rides in the snapshot, so a
  replay overlapping a checkpoint (or a client retry racing a crash) can
  never double-fold.

Card tensors reach the disk by the stream rule
(:func:`repro_torch.checkpoint.host_copy`): a journaled upload is read on
the stream the submit runs on, a snapshot on the stream the service last
ran on.  Fault injection lives in :mod:`repro_torch.fl.chaos`.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Any

import torch

from repro_torch.checkpoint import (CheckpointError, load_blob, pack_obj,
                                    save_blob, unpack_obj)
from repro_torch.core.strategy import ClientUpdate, ServerState
from repro_torch.fl.async_agg import AsyncAggregator, to_device
from repro_torch.obs import LATENCY_BUCKETS

_WAL_PREFIX = "wal-"
_CKPT_PREFIX = "ckpt-"
_FRAME_HEAD = struct.Struct("<II")     # payload length, crc32(payload)


def _update_to_obj(u: ClientUpdate) -> dict:
    return {"adapters": u.adapters, "base_trainable": u.base_trainable,
            "n_examples": float(u.n_examples), "rank": u.rank}


def _obj_to_update(d: dict, device: torch.device) -> ClientUpdate:
    return ClientUpdate(adapters=to_device(d["adapters"], device),
                        base_trainable=to_device(d["base_trainable"], device),
                        n_examples=d["n_examples"], rank=d["rank"])


class WriteAheadLog:
    """Append-only, crc-framed, segment-rotated journal.

    Record frame: 8-byte header (payload length, crc32) + payload
    (:func:`repro_torch.checkpoint.pack_obj` of ``[seq, kind, body]``).  A
    crash mid-append leaves a torn tail; :meth:`records` stops at the first
    frame of the final segment that fails its length or checksum --
    everything before it is trusted, everything after is discarded (an
    upload is acknowledged only after its frame is written and flushed).
    A bad frame in any earlier segment is not a torn tail, and raises.

    Segments are ``wal-<start_seq>.log``; :meth:`rotate` starts a fresh
    segment after a checkpoint and prunes segments whose every record the
    checkpoint already covers.
    """

    def __init__(self, dirname: str, fsync: bool = True):
        self.dir = dirname
        self.fsync = bool(fsync)
        os.makedirs(dirname, exist_ok=True)
        self._fh = None
        self._segment = None
        self.n_torn = 0                  # frames discarded as torn tails
        self.bytes_written = 0
        self.n_records = 0               # appended by THIS process
        self.last_seq = 0                # highest seq on disk (incl. prior
        for seq, _, _ in self.records():  # incarnations)
            self.last_seq = max(self.last_seq, seq)

    # ----------------------------------------------------------- segments --
    def _segments(self) -> list[str]:
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith(_WAL_PREFIX) and n.endswith(".log"))
        return [os.path.join(self.dir, n) for n in names]

    @staticmethod
    def _seg_start(path: str) -> int:
        base = os.path.basename(path)
        try:
            return int(base[len(_WAL_PREFIX):-len(".log")])
        except ValueError:
            return 0

    def _open_segment(self, start_seq: int) -> None:
        self.close()
        self._segment = os.path.join(
            self.dir, f"{_WAL_PREFIX}{start_seq:012d}.log")
        self._fh = open(self._segment, "ab")

    # ------------------------------------------------------------- append --
    def append(self, kind: str, body: Any) -> int:
        """Journal one record; returns its sequence number.  Card tensors
        in ``body`` are read on the current stream.  The record is flushed
        (and fsynced when configured) before this returns -- an
        acknowledged append survives a process crash."""
        if self._fh is None:
            self._open_segment(self.last_seq + 1)
        seq = self.last_seq + 1
        payload = pack_obj([seq, kind, body])
        frame = _FRAME_HEAD.pack(len(payload),
                                 zlib.crc32(payload)) + payload
        self._fh.write(frame)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self.last_seq = seq
        self.n_records += 1
        self.bytes_written += len(frame)
        return seq

    # --------------------------------------------------------------- read --
    def _read_segment(self, path: str, last: bool):
        with open(path, "rb") as f:
            while True:
                head = f.read(_FRAME_HEAD.size)
                if not head:
                    return
                if len(head) < _FRAME_HEAD.size:
                    self.n_torn += 1
                    if not last:
                        raise CheckpointError(
                            f"corrupt WAL frame mid-stream in {path} (a "
                            "short header before the final segment)")
                    return                      # torn header at the tail
                size, crc = _FRAME_HEAD.unpack(head)
                payload = f.read(size)
                if len(payload) < size or zlib.crc32(payload) != crc:
                    self.n_torn += 1
                    if not last:
                        raise CheckpointError(
                            f"corrupt WAL frame mid-stream in {path} "
                            "(not a torn tail -- refusing to skip "
                            "journaled records)")
                    return                      # torn tail: discard rest
                seq, kind, body = unpack_obj(payload)
                yield seq, kind, body

    def records(self, min_seq: int = 0):
        """Yield ``(seq, kind, body)`` in order across all segments,
        starting at ``min_seq``; tolerates a torn tail on the final
        segment (a crash mid-append).  Tensors come back on the host."""
        segs = self._segments()
        for i, path in enumerate(segs):
            for seq, kind, body in self._read_segment(
                    path, last=(i == len(segs) - 1)):
                if seq >= min_seq:
                    yield seq, kind, body

    # ------------------------------------------------------------- rotate --
    def rotate(self, covered_seq: int) -> None:
        """Start a fresh segment and prune segments every one of whose
        records is ``<= covered_seq`` (already inside a durable
        checkpoint)."""
        self._open_segment(self.last_seq + 1)
        segs = self._segments()
        for i, path in enumerate(segs):
            if path == self._segment:
                continue
            nxt = (self._seg_start(segs[i + 1]) if i + 1 < len(segs)
                   else None)
            # this segment's records span [start, next_start - 1]
            if nxt is not None and nxt - 1 <= covered_seq:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class DurableAggregator(AsyncAggregator):
    """An :class:`~repro_torch.fl.AsyncAggregator` whose state survives
    crashes: WAL journal before fold, periodic atomic checkpoints,
    automatic restore-last-checkpoint + WAL-replay recovery.

    Parameters (on top of :class:`AsyncAggregator`'s)
    -------------------------------------------------
    dir
        Durability directory: WAL segments (``wal-*.log``) and checkpoints
        (``ckpt-*.bin``) live here.  Construction over a non-empty
        directory **recovers**: newest valid checkpoint + replay of the
        WAL tail, bit-identical to the uninterrupted run
        (``recover=False`` skips, for tests that stage state by hand).
    checkpoint_every
        Snapshot the full service every this many accepted uploads (0
        disables periodic snapshots; :meth:`checkpoint` is always
        available).  The WAL rotates on every checkpoint and covered
        segments are pruned, so disk stays bounded at about one interval
        of uploads plus ``keep_checkpoints`` snapshots.
    keep_checkpoints
        How many of the newest checkpoint files to keep.  More than one
        means a checkpoint torn by a crash during its write or by bit rot
        falls back to an older snapshot plus a longer WAL replay.
    wal_fsync
        fsync every WAL append (at-least-once against *machine* crashes).
        ``False`` keeps an OS-level flush, which survives process crashes:
        the fault model of the in-process chaos harness.

    The recovery counters (``n_recoveries``, ``n_replayed``,
    ``n_checkpoints``) and the WAL/checkpoint metrics
    (``fl_wal_records_total``, ``fl_wal_bytes_total``,
    ``fl_checkpoints_total``, ``fl_recoveries_total``,
    ``fl_replayed_updates_total``, ``fl_checkpoint_seconds``,
    ``fl_restore_seconds``) feed the durability section of
    :class:`~repro_torch.obs.ServiceHealth`.
    """

    def __init__(self, strategy, state: ServerState, *, dir: str,
                 checkpoint_every: int = 64, keep_checkpoints: int = 2,
                 wal_fsync: bool = True, recover: bool = True, **kw):
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if keep_checkpoints < 1:
            raise ValueError(
                f"keep_checkpoints must be >= 1, got {keep_checkpoints}")
        super().__init__(strategy, state, **kw)
        self.dir = dir
        self.checkpoint_every = int(checkpoint_every)
        self.keep_checkpoints = int(keep_checkpoints)
        self.wal = WriteAheadLog(dir, fsync=wal_fsync)
        self._inner = 0                 # >0: inside a journaled operation
        self._replaying = False
        self._ckpt_seq = 0              # wal seq covered by newest ckpt
        self._accepts_since_ckpt = 0
        self.n_recoveries = 0
        self.n_replayed = 0
        self.n_checkpoints = 0
        reg = self.obs_registry
        self._m_wal_records = reg.counter(
            "fl_wal_records_total", "records journaled to the WAL")
        self._m_wal_bytes = reg.counter(
            "fl_wal_bytes_total", "bytes appended to the WAL")
        self._m_checkpoints = reg.counter(
            "fl_checkpoints_total", "service snapshots committed")
        self._m_recoveries = reg.counter(
            "fl_recoveries_total",
            "crash recoveries (checkpoint restore and/or WAL replay)")
        self._m_replayed = reg.counter(
            "fl_replayed_updates_total",
            "WAL records re-driven through ingestion during recovery")
        self._m_ckpt_s = reg.histogram(
            "fl_checkpoint_seconds", "checkpoint write latency",
            buckets=LATENCY_BUCKETS)
        self._m_restore_s = reg.histogram(
            "fl_restore_seconds",
            "recovery latency (restore + WAL replay)",
            buckets=LATENCY_BUCKETS)
        if recover:
            self.recover()

    # ------------------------------------------------------------ journal --
    def _journal(self, kind: str, body: Any) -> int:
        before = self.wal.bytes_written
        seq = self.wal.append(kind, body)
        self._m_wal_records.inc()
        self._m_wal_bytes.inc(self.wal.bytes_written - before)
        return seq

    def submit(self, update: ClientUpdate, model_version: int | None = None,
               now: float = 0.0, pulled_at: float | None = None,
               update_id: str | None = None) -> bool:
        """Journal-then-fold ingestion: the upload is validated (garbage
        never reaches the log), deduplicated, journaled -- codec-encoded
        payload as-is -- and only then folded or buffered.  A crash
        between journal and fold is repaired by replay; a crash before the
        journal returns no acknowledgement, so the client retries and the
        dedup window keeps the retry exactly-once."""
        if self._replaying:
            return super().submit(update, model_version=model_version,
                                  now=now, pulled_at=pulled_at,
                                  update_id=update_id)
        if update_id is not None and update_id in self.dedup:
            self._reject("duplicate")
            return False
        self._validate_update(update)
        self._journal("submit", {
            "update": _update_to_obj(update), "update_id": update_id,
            "model_version": model_version, "now": now,
            "pulled_at": pulled_at})
        self._inner += 1
        try:
            advanced = super().submit(update, model_version=model_version,
                                      now=now, pulled_at=pulled_at,
                                      update_id=update_id)
        finally:
            self._inner -= 1
        self._accepts_since_ckpt += 1
        if (self.checkpoint_every
                and self._accepts_since_ckpt >= self.checkpoint_every):
            self.checkpoint()
        return advanced

    def flush(self, now: float = 0.0) -> ServerState:
        # only *externally driven* flushes are journaled -- a flush the
        # base class triggers inside a journaled submit/maybe_flush is a
        # deterministic consequence of that record and replays for free
        if not self._replaying and self._inner == 0:
            self._journal("flush", {"now": now})
        self._inner += 1
        try:
            return super().flush(now=now)
        finally:
            self._inner -= 1

    def maybe_flush(self, now: float) -> bool:
        if not self._replaying and self._inner == 0:
            self._journal("maybe_flush", {"now": now})
        self._inner += 1
        try:
            return super().maybe_flush(now=now)
        finally:
            self._inner -= 1

    # --------------------------------------------------------- checkpoint --
    def _ckpt_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{_CKPT_PREFIX}{seq:012d}.bin")

    def _checkpoints(self) -> list[str]:
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith(_CKPT_PREFIX) and n.endswith(".bin"))
        return [os.path.join(self.dir, n) for n in names]

    def checkpoint(self) -> str:
        """Commit one atomic full-service snapshot; rotate + prune the WAL;
        prune old checkpoints.  Returns the checkpoint path."""
        t0 = time.perf_counter()
        sd = self.state_dict()
        sd["wal_seq"] = self.wal.last_seq
        sd["durable"] = {"n_recoveries": self.n_recoveries,
                         "n_replayed": self.n_replayed}
        path = self._ckpt_path(self.wal.last_seq)
        save_blob(path, sd, fsync=self.wal.fsync)
        self._ckpt_seq = self.wal.last_seq
        self._accepts_since_ckpt = 0
        self.n_checkpoints += 1
        self._m_checkpoints.inc()
        for old in self._checkpoints()[:-self.keep_checkpoints]:
            try:
                os.remove(old)
            except OSError:
                pass
        # prune WAL segments covered by the OLDEST retained checkpoint, not
        # the newest: if the newest snapshot turns out torn or corrupt,
        # recovery falls back an epoch and must still find the records
        # between the two snapshots on disk
        retained = self._checkpoints()
        oldest = os.path.basename(retained[0])[len(_CKPT_PREFIX):-len(".bin")]
        self.wal.rotate(int(oldest))
        self._m_ckpt_s.observe(time.perf_counter() - t0)
        return path

    # ------------------------------------------------------------ recover --
    def recover(self) -> int:
        """Restore the newest valid checkpoint (skipping torn or corrupt
        ones) and replay the WAL tail through normal ingestion on the
        service's device.  Returns the number of replayed records; 0 on a
        fresh directory.  The recovered service is bit-identical to one
        that never crashed: the snapshot carries the generator's state,
        masses, momentum, buffer and dedup window, and the replay re-drives
        the exact submission sequence (records at or before the snapshot's
        ``wal_seq`` are skipped by sequence number, client retries by the
        restored dedup window)."""
        t0 = time.perf_counter()
        restored = False
        start_seq = 0
        for path in reversed(self._checkpoints()):
            try:
                sd = load_blob(path)
            except (CheckpointError, OSError):
                continue                 # torn/corrupt: fall back older
            self.load_state_dict(sd)
            dur = sd.get("durable", {})
            self.n_recoveries = dur.get("n_recoveries", 0)
            self.n_replayed = dur.get("n_replayed", 0)
            start_seq = sd.get("wal_seq", 0)
            self._ckpt_seq = start_seq
            restored = True
            break
        n = 0
        self._replaying = True
        try:
            for seq, kind, body in self.wal.records(min_seq=start_seq + 1):
                if kind == "submit":
                    try:
                        self.submit(_obj_to_update(body["update"],
                                                   self.device),
                                    model_version=body["model_version"],
                                    now=body["now"],
                                    pulled_at=body["pulled_at"],
                                    update_id=body["update_id"])
                    except ValueError:
                        # journaled records were validated before the
                        # append; a raise here means the negotiation
                        # config changed between incarnations -- skip,
                        # the rejection counters already recorded it
                        pass
                elif kind == "flush":
                    self.flush(now=body["now"])
                elif kind == "maybe_flush":
                    self.maybe_flush(now=body["now"])
                n += 1
        finally:
            self._replaying = False
        self._accepts_since_ckpt = 0
        if restored or n:
            self.n_recoveries += 1
            self.n_replayed += n
            self._m_recoveries.inc()
            self._m_replayed.inc(n)
            self._m_restore_s.observe(time.perf_counter() - t0)
        return n

    def close(self) -> None:
        """Release the WAL file handle (the log itself stays)."""
        self.wal.close()


__all__ = ["DurableAggregator", "WriteAheadLog"]
