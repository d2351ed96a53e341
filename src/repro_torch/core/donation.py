"""Donated server state and the stream rule.

A round called with ``donate=True`` (``AggregationStrategy
.aggregate_adapters``, ``.aggregate``, ``CompiledRound.__call__``) writes
its output into the previous global's A/B storage instead of a fresh
allocation -- the JAX package's buffer donation, under the same condition
(a strategy that retains prev, a round that has one; see
``repro_torch.core.plan``).  The caller must not read the old global
afterwards: its tensors now hold the new one.

XLA orders a donated write after every queued read of that buffer.
PyTorch orders work only within one CUDA stream, and its caching allocator
hands a freed block to the next allocation on the freeing stream at once.
So a donated write rules out three hazards with events, never with a host
synchronisation (the rule ``repro_torch.serving.store`` keeps):

1. *Write after read.*  A reader of the global on another stream calls
   :func:`note_read` after its launches: an event on its stream, held
   against the tensors it read.  Before a donated write, the writing stream
   waits on every pending event of that storage (:func:`begin_write`), so
   the write cannot overtake a read queued elsewhere.
2. *Read after write.*  A donated write records an event on the writing
   stream after its launch (:func:`end_write`); a reader on another stream
   calls :func:`wait_written` on the new global before it launches.
3. *Free while read.*  Each record holds references to the tensors it
   covers until its event completes: a read record the tensors read, a
   write record every tensor the round read (the cohort's leaves, read in
   place by the kernel, and prev).  None of them returns to the allocator
   while a kernel on another stream may still read it.

Completed events (``query()``) are pruned at every call.  On the CPU there
are no events and every function is a no-op.  One host thread drives it.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves

#: pending reads: (event, storage keys, the tensors read)
_READS: list = []
#: the last write of each storage: key -> its event
_WRITES: dict = {}
#: write records' held tensors: (event, tensors)
_HELD: list = []


def _cuda(tree) -> list:
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda]


def _key(t: torch.Tensor) -> tuple:
    return (t.get_device(), t.untyped_storage().data_ptr())


def _prune() -> None:
    _READS[:] = [r for r in _READS if not r[0].query()]
    _HELD[:] = [h for h in _HELD if not h[0].query()]
    for k in [k for k, ev in _WRITES.items() if ev.query()]:
        del _WRITES[k]


def _stream(ts, stream):
    return stream if stream is not None else torch.cuda.current_stream(
        ts[0].device)


def note_read(tree, stream=None) -> None:
    """Record that ``stream`` (default: the current one) has queued reads
    of the CUDA tensors in ``tree``: a later donated write of their storage
    waits for them, and they stay allocated until the reads are done."""
    ts = _cuda(tree)
    if not ts:
        return
    ev = torch.cuda.Event()
    ev.record(_stream(ts, stream))
    _READS.append((ev, {_key(t) for t in ts}, ts))


def wait_written(tree, stream=None) -> None:
    """Make ``stream`` (default: the current one) wait for the donated
    writes that produced the CUDA tensors in ``tree``."""
    ts = _cuda(tree)
    if not ts:
        return
    _prune()
    s = _stream(ts, stream)
    for ev in {id(e): e for e in (_WRITES.get(_key(t)) for t in ts)
               if e is not None}.values():
        s.wait_event(ev)


def begin_write(targets) -> None:
    """Before a donated write of ``targets`` on the current stream: wait on
    every pending read of their storage, and on an earlier write of it
    issued from another stream."""
    ts = _cuda(targets)
    if not ts:
        return
    _prune()
    s = torch.cuda.current_stream(ts[0].device)
    keys = {_key(t) for t in ts}
    for ev, got, _ in _READS:
        if got & keys:
            s.wait_event(ev)
    for k in keys:
        if k in _WRITES:
            s.wait_event(_WRITES[k])


def end_write(targets, inputs) -> None:
    """After a donated write of ``targets`` on the current stream: its
    event for :func:`wait_written`, and ``inputs`` (every tensor the round
    read) held until it completes."""
    ts = _cuda(targets)
    if not ts:
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(ts[0].device))
    for t in ts:
        _WRITES[_key(t)] = ev
    _HELD.append((ev, _cuda(inputs) + ts))


__all__ = ["note_read", "wait_written", "begin_write", "end_write"]
