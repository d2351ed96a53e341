"""The plain PyTorch version of the SSD scan kernel: the port's chunked
implementation ``repro_torch.models.mamba.ssd_chunked`` (held against the
JAX package's and against the sequential recurrence in
``tests/test_torch_ssd_scan.py``).  The CPU path of the wrapper runs it;
on the card it is the oracle the kernel in ``csrc/ssd_scan.cu`` is held
against.  :func:`ssd_scan_phases` writes out the kernel's own four-phase
decomposition in plain PyTorch, for the tests."""
from __future__ import annotations

import torch

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


def ssd_scan_phases(xdt, dta, bm, cm, chunk: int):
    """The scan as ``csrc/ssd_scan.cu`` splits it, in fp32 PyTorch: (1)
    ``a_cs`` per head and C B^T once per (batch, chunk); (2) each chunk's
    own state ``xdt^T (B * exp(a_tot - a_cs))``; (3) the sequential carry
    ``h_c = h_{c-1} exp(a_tot_c) + s_c``; (4) ``((C B^T) o Lmask) @ xdt +
    (C h_prev^T) * exp(a_cs)``, the mask a select before the exponential.
    Returns (y, h_final) in xdt's dtype.  Not the wrapper's plain version
    (that is :func:`ssd_scan_ref`) and not counted as one."""
    b, l, h, p = xdt.shape
    n = bm.shape[-1]
    q = chunk_len(l, chunk)
    nc = l // q
    x = xdt.float().reshape(b, nc, q, h, p)
    bmat = bm.float().reshape(b, nc, q, n)
    cmat = cm.float().reshape(b, nc, q, n)
    # 1. a_cs (b, nc, q, h) and C B^T (b, nc, q, q), shared by every head
    acs = dta.float().reshape(b, nc, q, h).cumsum(2)
    cb = cmat @ bmat.transpose(-1, -2)
    # 2. the chunks' own states (b, nc, h, p, n), in parallel over chunks
    a_tot = acs[:, :, -1]                                   # (b, nc, h)
    decay = torch.exp(a_tot[:, :, None, :] - acs)           # (b, nc, q, h)
    states = torch.einsum("bcjhp,bcjn,bcjh->bchpn", x, bmat, decay)
    # 3. the carry: the state entering each chunk, then h_final
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=xdt.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(hcur)
        hcur = hcur * torch.exp(a_tot[:, c])[..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)                         # (b, nc, h, p, n)
    # 4. outputs: masked, decayed scores on the causal triangle
    idx = torch.arange(q, device=xdt.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]     # (b, nc, i, j, h)
    lmask = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, lmask, x)
    y_off = torch.einsum("bcin,bchpn->bcihp", cmat, h_prev) \
        * torch.exp(acs)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(xdt.dtype), hcur.to(xdt.dtype)
