"""The plain PyTorch version of the SSD scan kernel: the port's chunked
implementation ``repro_torch.models.mamba.ssd_chunked`` (held against the
JAX package's and against the sequential recurrence in
``tests/test_torch_ssd_scan.py``).  The CPU path of the wrapper runs it;
on the card it is the oracle the kernel in ``csrc/ssd_scan.cu`` is held
against."""
from __future__ import annotations

from .. import runtime


def chunk_len(l: int, chunk: int) -> int:
    """The chunk length Q of a length-``l`` sequence: ``min(chunk, l)``,
    lowered until it divides ``l`` (1 for a prime ``l`` above ``chunk``)."""
    q = min(chunk, l)
    while l % q:
        q -= 1
    return q


def ssd_scan_ref(xdt, dta, bm, cm, chunk: int):
    """Returns (y (B,L,H,P), h_final (B,H,P,N))."""
    # imported here: models.mamba imports this package at its top
    from repro_torch.models.mamba import ssd_chunked
    runtime.PLAIN_CALLS["ssd_scan"] += 1
    return ssd_chunked(xdt, dta, bm, cm, chunk)
