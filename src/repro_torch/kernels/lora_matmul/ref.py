"""Plain PyTorch versions of the fused LoRA matmul kernels.

All three accumulate in fp32 and cast to ``x.dtype``.  The CPU path of the
wrappers runs :func:`lora_matmul_ref` and
:func:`batched_lora_matmul_segments` (the port's CPU serving path); on the
card they are the oracles the kernels in ``csrc/lora_matmul.cu`` are held
against, and :func:`batched_lora_matmul_ref` is the per-request loop the
tests hold both against.
"""
from __future__ import annotations

import torch

from .. import runtime


def lora_matmul_ref(x, w, a, b, scale):
    """y = x @ w + scale * (x @ a^T) @ b^T, f32 accumulation."""
    runtime.PLAIN_CALLS["lora_matmul"] += 1
    xf = x.float()
    base = xf @ w.float()
    lora = (xf @ a.float().T) @ b.float().T
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return (base + s.reshape(()) * lora).to(x.dtype)


def batched_lora_matmul_ref(x, w, a_rows, b_rows, off, cnt, scale):
    """Per-request loop oracle for the multi-adapter kernel.

    Each request i slices its own (A, B) segment out of the packed row
    buffers -- ``a_rows[off_i : off_i + cnt_i]`` and the same rows of
    ``b_rows`` -- and runs the single-adapter product on it, so rows
    outside every segment are never read.  Reads the per-request metadata
    on the host (a test oracle, not a serving path)."""
    runtime.PLAIN_CALLS["batched_lora_matmul"] += 1
    xf = x.float()
    wf, af, bf = w.float(), a_rows.float(), b_rows.float()
    offs = torch.as_tensor(off).reshape(-1).tolist()
    cnts = torch.as_tensor(cnt).reshape(-1).tolist()
    scales = torch.as_tensor(scale, dtype=torch.float32).reshape(-1).tolist()
    out = torch.empty((x.shape[0], wf.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(x.shape[0]):
        lo = max(offs[i], 0)
        hi = max(offs[i] + cnts[i], lo)
        xi = xf[i:i + 1]
        lora = (xi @ af[lo:hi].T) @ bf[lo:hi]
        out[i] = (xi @ wf + scales[i] * lora)[0]
    return out.to(x.dtype)


def batched_lora_matmul_segments(x, w, a_rows, b_rows, off, cnt, scale):
    """The two-matmul lowering of the multi-adapter matmul with a
    per-request segment mask in between::

        xa   = x @ a_rows^T                       (M, R)
        mask = off_i <= p < off_i + cnt_i         (M, R)
        y    = x @ w + scale_i * (mask * xa) @ b_rows

    Offsets, counts and scales are tensors on x's device.  Rows of
    ``b_rows`` that no request's segment covers are zeroed before the
    second product, so garbage there (NaN, Inf) cannot leak through a zero
    mask weight; garbage in ``a_rows`` outside a segment is dropped by the
    mask.  This is the port's CPU serving path."""
    runtime.PLAIN_CALLS["batched_lora_matmul"] += 1
    xf = x.float()
    base = xf @ w.float()
    xa = xf @ a_rows.float().T
    p = torch.arange(a_rows.shape[0], device=x.device)[None, :]
    off = torch.as_tensor(off, device=x.device).reshape(-1, 1).long()
    cnt = torch.as_tensor(cnt, device=x.device).reshape(-1, 1).long()
    seg = (p >= off) & (p < off + cnt)
    live = seg.any(dim=0)[:, None]
    lora = torch.where(seg, xa, 0.0) @ torch.where(live, b_rows.float(), 0.0)
    sc = torch.as_tensor(scale, dtype=torch.float32,
                         device=x.device).reshape(-1, 1)
    return (base + sc * lora).to(x.dtype)
