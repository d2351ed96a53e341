"""Plain PyTorch versions of the fused LoRA matmul kernels.

All three accumulate in fp32 and cast to ``x.dtype``.  The CPU path of the
wrappers runs :func:`lora_matmul_ref` and
:func:`batched_lora_matmul_segments` (the port's CPU serving path) on the
segments :func:`resolve_segments` gathers; on the card they are the oracles
the kernels in ``csrc/lora_matmul.cu`` are held against, and
:func:`batched_lora_matmul_ref` is the per-request loop the tests hold both
against.  :func:`matmul_3xtf32` writes out the fp32 arithmetic of the
kernels' tensor-core body.
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


def resolve_segments(ids, seg_off, seg_rank, seg_scale):
    """Each request row's segment from its tenant id: ``(off, cnt, scale)``
    as int32, int32 and fp32 tensors of ``ids``' length, gathered from the
    tenant tables on their device.  A negative id counts from the end of
    the tables, as JAX's gather indexes, and an id still outside them
    clamps to the nearer end.  The kernel resolves ids by the same rule in
    each block."""
    t = seg_off.shape[0]
    if t < 1:
        raise ValueError("batched_lora_matmul: the tenant tables are empty")
    ids = torch.as_tensor(ids).reshape(-1).long()
    ids = torch.where(ids < 0, ids + t, ids).clamp(0, t - 1)
    return (seg_off.index_select(0, ids).to(torch.int32),
            seg_rank.index_select(0, ids).to(torch.int32),
            seg_scale.index_select(0, ids).to(torch.float32))


def tf32_round(x):
    """fp32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: half a TF32 ulp added to the bits, the low 13 cleared, as
    the kernels' ``split`` does (and ``cvt.rna.tf32.f32`` would); the
    result stays fp32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x):
    """fp32 values as a tensor core reads them as TF32: the low 13 bits
    dropped (round toward zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def tf32_split(x):
    """``x ~ hi + lo`` as the tensor cores see it (``split`` in
    ``csrc/common.cuh``): ``hi`` is x rounded to TF32, ties away from
    zero; ``lo = x - hi`` is exact in fp32 and read as TF32 by truncation,
    so the bits it drops are about 2^-21 of x."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def matmul_3xtf32(x, w):
    """``x @ w`` in fp32 as the kernels' tensor-core body computes it:
    both operands split by :func:`tf32_split`, the three products ``lo hi
    + hi lo + hi hi`` (each exact in fp32) summed in fp32; the ``lo lo``
    term, about 2^-20 of a product, is dropped."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    return xl @ wh + xh @ wl + xh @ wh
