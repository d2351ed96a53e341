"""Plain PyTorch versions of the aggregation kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes
(no epsilon where a denominator is known to be positive, ``num / wtot``
for ``norm_by="weight"``), in fp32.  The CPU path of the wrappers and the
strategies' ``ref`` backend run these; on the card they are the oracle the
kernels are held against.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import runtime


def _finish(num, den, wtot, norm_by: str, prev):
    if norm_by == "weight":
        return num / wtot
    if norm_by != "mask":
        raise ValueError(f"unknown norm_by {norm_by!r}; options: "
                         "['mask', 'weight']")
    fb = (prev.float() if prev is not None else torch.zeros_like(num))
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), fb)


def _packed_agg_math(xf, m, w, prev, norm_by: str, norm_restore: bool):
    """:func:`packed_agg_ref`'s arithmetic on dequantised fp32 rows."""
    wm = w[:, None] * m                                    # (N, R)
    num = (wm[:, :, None] * xf).sum(0)
    out = _finish(num, wm.sum(0)[:, None], w.sum(), norm_by, prev)
    if norm_restore:
        xm = m[:, :, None] * xf
        row_norms = xm.square().sum(-1).sqrt()             # (N, R)
        own = (m > 0).float() * w[:, None]
        target = (own * row_norms).sum(0) / (own.sum(0) + 1e-12)
        agg = out.square().sum(1).sqrt()
        out = out * torch.where(agg > 1e-12, target / (agg + 1e-12),
                                1.0)[:, None]
    return out


def packed_agg_ref(x, masks, weights, prev=None, *, norm_by: str = "mask",
                   norm_restore: bool = False, scales=None, out_dtype=None):
    """x (N, R, D); masks (N, R); weights (N,); prev (R, D) or None;
    scales (N, R) or None -> (R, D) in ``out_dtype`` (default x's).

    Per row r: ``sum_n w_n m_nr s_nr x_nr / sum_n w_n m_nr`` where that
    owner mass is positive, else ``prev`` (or 0); ``norm_by="weight"``
    divides by ``sum_n w_n`` instead.  ``norm_restore`` rescales each
    output row to the owners' weighted mean row norm."""
    runtime.PLAIN_CALLS["packed_agg"] += 1
    xf = x.float()
    if scales is not None:
        xf = scales.float()[:, :, None] * xf
    out = _packed_agg_math(xf, masks.float(), weights.float(), prev, norm_by,
                           norm_restore)
    return out.to(out_dtype or x.dtype)


def rbla_agg_ref(x, ranks, weights, *, norm_by: str = "mask"):
    """x (N, R, D); ranks (N,) int; weights (N,) -> (R, D) in x's dtype.

    Paper Eq. 7 with the owner mask ``[r < ranks[n]]``; rows no client
    owns are 0; ``norm_by="weight"`` divides by the total mass."""
    runtime.PLAIN_CALLS["rbla_agg"] += 1
    r = x.shape[1]
    m = (torch.arange(r, device=x.device)[None, :]
         < ranks.to(x.device)[:, None]).float()
    w = weights.float()
    wm = w[:, None] * m
    num = (wm[:, :, None] * x.float()).sum(0)
    return _finish(num, wm.sum(0)[:, None], w.sum(), norm_by,
                   None).to(x.dtype)


def rbla_agg_group_ref(xs, ranks, weights, prevs, *, cols, rank_cols,
                       norm_by: str = "mask"):
    """The per-pair round's plain version: :func:`rbla_agg_ref`'s Eq. 7 on
    every segment.  ``xs[i]`` one pair side stacked over the n clients,
    ``(n, r, fan_in)`` or (``cols[i]``) ``(n, fan_out, r)``; client c owns
    rank row j iff ``j < ranks[c, rank_cols[i]]``; a rank row some client
    owns at weight 0 alone is 0, and one no client owns keeps ``prevs[i]``
    (0 without); ``norm_by="weight"`` divides by the total mass.  Each
    result in the leaf's shape and dtype.  Counts one plain call per launch
    the kernel would make (:func:`group_launches`)."""
    runtime.PLAIN_CALLS["rbla_agg"] += group_launches(xs)
    w = weights.float()
    outs = []
    for x, prev, col, c in zip(xs, prevs, cols, rank_cols):
        xf = leaf_rank_rows(x.float(), col)                  # (n, R, E)
        rows = torch.arange(xf.shape[1], device=xf.device)
        m = (rows[None, :] < ranks[:, c].to(xf.device)[:, None]).float()
        wm = w[:, None] * m
        num = (wm[:, :, None] * xf).sum(0)
        if norm_by == "weight":
            out = num / w.sum()
        else:
            den = wm.sum(0)[:, None]
            unowned = (m.sum(0) == 0)[:, None]
            fb = (leaf_rank_rows(prev[None], col)[0].float()
                  if prev is not None else torch.zeros_like(num))
            out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                              torch.where(unowned, fb, 0.0))
        outs.append(leaf_from_rank_rows(out, tuple(x.shape[1:]), col)
                    .to(x.dtype).contiguous())
    return outs


def flora_mass_scales(weights, contribs, prev_weight: float, eps: float):
    """flora's B-column scales of one segment, as ``flora_stack_group``'s
    kernel computes them: each contributor's mass (a client's weight, the
    previous global's ``prev_weight`` times the mean weight), ``m_k / (sum m
    + eps) * total / rows_k``, in fp32 with every sum taken in order.
    -> a host list of fp32 scalars."""
    w = [np.float32(v) for v in weights.detach().float().cpu().tolist()]
    f32 = np.float32
    mean = f32(0.0)
    if any(src < 0 for src, _ in contribs):
        total = f32(0.0)
        for v in w:
            total = f32(total + v)
        mean = f32(total / f32(len(w)))
    masses = [f32(f32(prev_weight) * mean) if src < 0 else w[src]
              for src, _ in contribs]
    msum = f32(0.0)
    for m in masses:
        msum = f32(msum + m)
    den = f32(msum + f32(eps))
    r_total = f32(sum(rows for _, rows in contribs))
    return [f32(f32(m / den) * f32(r_total / f32(rows)))
            for m, (_, rows) in zip(masses, contribs)]


def flora_stack_group_ref(xs, contribs, prevs, *, cols, caps, scales,
                          weights=None, prev_weight: float = 1.0,
                          eps: float = 1e-12, out_dtypes):
    """The plain version of ``flora_stack_group``: per segment, contributor
    k's leading ``rows`` rank rows (of client ``src``'s leaf, or of prev for
    -1), scaled in fp32 and rounded once to the output dtype, at the
    running offset of a zero leaf of storage rank ``caps[i]`` (rank rows by
    row, or by column where ``cols[i]``).  ``scales[i]``: None (1), a
    tensor (one a contributor) or "mass" (:func:`flora_mass_scales`)."""
    runtime.PLAIN_CALLS["flora_stack"] += 1
    return _stack_group(xs, contribs, prevs, cols, caps, scales, weights,
                        prev_weight, eps, out_dtypes)


def packed_stack_group_ref(plan, xs, prevs=None, weights=None):
    """The plain twin of ``packed_stack_group``: the segments of ``plan``
    (a ``StackPlan``) through :func:`flora_stack_group_ref`'s arithmetic,
    the outputs in the leaves' dtypes; one plain ``packed_stack`` call."""
    runtime.PLAIN_CALLS["packed_stack"] += 1
    prevs = (None,) * len(xs) if prevs is None else prevs
    return _stack_group(xs, plan.contribs, prevs, plan.cols, plan.caps,
                        plan.scales, weights, plan.prev_weight, plan.eps,
                        plan.dtypes)


def _stack_group(xs, contribs, prevs, cols, caps, scales, weights,
                 prev_weight, eps, out_dtypes) -> list:
    outs = []
    for x, con, prev, col, cap, sc, odt in zip(xs, contribs, prevs, cols,
                                               caps, scales, out_dtypes):
        lead = tuple(x.shape[1:-2])
        width = x.shape[-2] if col else x.shape[-1]
        out = torch.zeros(lead + (cap, width), dtype=odt, device=x.device)
        if isinstance(sc, str):
            sc = flora_mass_scales(weights, con, prev_weight, eps)
        elif sc is not None:
            sc = [np.float32(v) for v in sc.detach().float().cpu().tolist()]
        off = 0
        for k, (src, rows) in enumerate(con):
            part = prev if src < 0 else x[src]
            part = part.transpose(-1, -2) if col else part
            v = part[..., :rows, :].float()
            if sc is not None:
                v = v * float(sc[k])
            out[..., off:off + rows, :] = v.to(odt)
            off += rows
        outs.append(out.transpose(-1, -2).contiguous() if col else out)
    return outs


def _fold(y, x, a, out_dtype=None):
    """``y + a * (x - y)`` as three separately rounded fp32 operations, in
    ``out_dtype`` (default y's); ``a`` broadcasts against y."""
    yf = y.float()
    return (yf + a * (x.float() - yf)).to(out_dtype or y.dtype)


def axpy_fold_ref(y, x, alpha, *, out_dtype=None):
    """y, x (R, *dims); alpha a scalar or (R,) -> ``y + alpha * (x - y)``
    in fp32 with alpha broadcast over the trailing dims, in ``out_dtype``
    (default y's).  Three separately rounded fp32 operations: a row with
    alpha 0 returns y, and a NaN in x reaches the output."""
    runtime.PLAIN_CALLS["axpy_fold"] += 1
    a = torch.as_tensor(alpha, dtype=torch.float32, device=y.device)
    if a.ndim == 1:
        a = a.reshape((y.shape[0],) + (1,) * (y.ndim - 1))
    return _fold(y, x, a, out_dtype)


def _fold_rate(alpha, y, col: bool = False):
    """A segment's rate shaped to broadcast against ``y``: a number, a
    tensor over y's leading dims (one rate per rank row), or with ``col``
    the same rates over y's leading dims and its LAST axis (a LoRA B leaf
    ``(..., fan_out, r)``)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=y.device)
    if col:
        return a.reshape(tuple(a.shape[:-1]) + (1,) + tuple(a.shape[-1:]))
    return a.reshape(tuple(a.shape) + (1,) * (y.ndim - a.ndim))


def axpy_fold_group_ref(ys, xs, alphas, *, cols=None):
    """The grouped fold: :func:`axpy_fold_ref`'s arithmetic on every
    segment ``(ys[i], xs[i], alphas[i])`` (rates as :func:`_fold_rate`
    reads them, ``cols[i]`` for column mode), each result in y's dtype.
    Counts one plain call per (y, x) dtype pair among the non-empty
    segments: one per launch the kernel would make."""
    cols = (False,) * len(ys) if cols is None else tuple(cols)
    runtime.PLAIN_CALLS["axpy_fold"] += len(
        {(y.dtype, x.dtype) for y, x in zip(ys, xs) if y.numel()})
    return [_fold(y, x, _fold_rate(a, y, c))
            for y, x, a, c in zip(ys, xs, alphas, cols)]


def flora_stack_ref(x, scales, segs, out_rows: int):
    """x (N, R, D); scales (N,); segs (N,) host ints -> (out_rows, D) in
    x's dtype: contributor i's first ``segs[i]`` rows, scaled, at the
    running offset ``sum(segs[:i])``; the rows beyond ``sum(segs)`` are
    zero."""
    runtime.PLAIN_CALLS["flora_stack"] += 1
    sc = torch.as_tensor(scales, dtype=torch.float32, device=x.device)
    out = torch.zeros((out_rows,) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    off = 0
    for i, s in enumerate(int(v) for v in segs):
        out[off:off + s] = (sc[i] * x[i, :s].float()).to(x.dtype)
        off += s
    return out


def packed_stack_ref(x, scales, prev=None, *, copies_x=(), copies_prev=(),
                     out_rows: int):
    """x (N, R_in, D); scales (S,); prev (R_prev, D) or None -> (out_rows,
    D) in x's dtype.  ``copies_x`` entries ``(client, src_row, dst_row,
    rows, scale_idx)`` and then ``copies_prev`` entries ``(src_row,
    dst_row, rows, scale_idx)`` write ``scales[scale_idx] * rows`` at
    ``dst_row``, in that order (a later copy wins an overlap); rows no copy
    touches are zero."""
    runtime.PLAIN_CALLS["packed_stack"] += 1
    sc = torch.as_tensor(scales, dtype=torch.float32, device=x.device)
    out = torch.zeros((out_rows, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for (src, s0, d0, nr, si) in copies_x:
        out[d0:d0 + nr] = (sc[si] * x[src, s0:s0 + nr].float()).to(x.dtype)
    for (s0, d0, nr, si) in copies_prev:
        out[d0:d0 + nr] = (sc[si] * prev[s0:s0 + nr].float()).to(x.dtype)
    return out


#: sentinel pushed into unowned slots before the per-coordinate sort:
#: above any sane upload, and two of them still average to a finite fp32
_SENTINEL = 1e30
ROBUST_MODES = ("clipped", "median", "trimmed")


def _check_mode(mode: str) -> None:
    if mode not in ROBUST_MODES:
        raise ValueError(f"unknown robust mode {mode!r}; options: "
                         f"{list(ROBUST_MODES)}")


def packed_robust_ref(x, masks, weights, prev=None, *, mode: str,
                      clip_norm: float = 0.0, trim_frac: float = 0.0,
                      scales=None, out_dtype=None):
    """x (N, R, D); masks (N, R); weights (N,); prev (R, D) or None;
    scales (N, R) or None -> (R, D) in ``out_dtype`` (default x's).

    ``"clipped"``: each client row, dequantised, is scaled by ``min(1,
    clip_norm / max(||row||, 1e-12))`` and then enters the masked weighted
    mean of :func:`packed_agg_ref`; a client adds nothing to a row whose
    weight times mask is 0, whatever its values.  ``"trimmed"`` / ``"median"``:
    unweighted order statistics over the c owners of each row (mask > 0).
    Unowned slots hold :data:`_SENTINEL`, ``torch.sort`` orders the client
    axis (NaN sorts last), and positions ``[k, c - k)`` are averaged with
    ``k = min(floor(trim_frac * c), (c - 1) // 2)`` in fp32; the median
    averages positions ``(c - 1) // 2`` and ``c // 2``; a NaN among a
    row's owned values makes that output NaN.  Rows no client owns keep
    ``prev`` (or 0)."""
    _check_mode(mode)
    runtime.PLAIN_CALLS["packed_robust"] += 1
    xf = x.float()
    if scales is not None:
        xf = scales.float()[:, :, None] * xf
    out = _packed_robust_math(xf, masks.float(), weights.float(), prev,
                              mode, clip_norm, trim_frac)
    return out.to(out_dtype or x.dtype)


def _packed_robust_math(xf, m, w, prev, mode, clip_norm, trim_frac):
    """:func:`packed_robust_ref`'s arithmetic on dequantised fp32 rows."""
    fb = (prev.float() if prev is not None
          else torch.zeros(xf.shape[1:], device=xf.device))
    if mode == "clipped":
        norms = xf.square().sum(-1).sqrt()                    # (N, R)
        clip = torch.clamp(torch.tensor(clip_norm, dtype=torch.float32)
                           / norms.clamp(min=1e-12), max=1.0)
        wm = w[:, None] * m
        part = wm[:, :, None] * (clip[:, :, None] * xf)
        num = torch.where(wm[:, :, None] != 0, part, 0.0).sum(0)
        den = wm.sum(0)[:, None]
        return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), fb)
    n = xf.shape[0]
    owned = m > 0
    s = torch.sort(torch.where(owned[:, :, None], xf, _SENTINEL),
                   dim=0).values
    c = owned.sum(0).to(torch.int32)                          # (R,)
    idx = torch.arange(n, dtype=torch.int32, device=xf.device)[:, None]
    if mode == "median":
        lo = ((c - 1).div(2, rounding_mode="floor")).clamp(min=0)[None, :]
        hi = c.div(2, rounding_mode="floor")[None, :]
        sel = 0.5 * ((idx == lo).float() + (idx == hi).float())
        out = (sel[:, :, None] * s).sum(0)
    else:
        tf = torch.tensor(trim_frac, dtype=torch.float32)
        k = torch.minimum(torch.floor(tf * c.float()).to(torch.int32),
                          (c - 1).div(2, rounding_mode="floor").clamp(min=0))
        inc = ((idx >= k[None, :]) & (idx < (c - k)[None, :])).float()
        cnt = (c - 2 * k).float().clamp(min=1.0)[:, None]
        out = (inc[:, :, None] * s).sum(0) / cnt
    return torch.where((c > 0)[:, None], out, fb)


# ------------------------------------------------------------ grouped twins --
def leaf_rank_rows(x, col: bool):
    """A leaf stacked over clients ``(n, *lead, a, b)`` as rank rows ``(n,
    lead * rank, elems)``: an A leaf (row mode) by its rows, a B leaf
    ``(..., fan_out, r)`` (column mode) by its columns."""
    if col:
        x = x.transpose(-1, -2)
    return x.reshape(x.shape[0], -1, x.shape[-1])


def leaf_from_rank_rows(rows, shape, col: bool):
    """The inverse of :func:`leaf_rank_rows` for one leaf of ``shape``."""
    if col:
        return rows.reshape(tuple(shape[:-2]) + (shape[-1], shape[-2])
                            ).transpose(-1, -2)
    return rows.reshape(shape)


def leaf_shape(x) -> tuple:
    """The leaf shape of a segment: a stacked tensor's after the client
    axis, or the shape of each per-client tensor."""
    return tuple(x.shape[1:] if isinstance(x, torch.Tensor) else x[0].shape)


def group_key(x) -> tuple:
    """The client dtypes of one segment: one dtype where every client has
    it (a stacked tensor, or per-client tensors of one dtype), else each
    client's.  The kernels make one launch per distinct key among a call's
    non-empty segments."""
    if isinstance(x, torch.Tensor):
        return (x.dtype,)
    key = tuple(t.dtype for t in x)
    return key[:1] if len(set(key)) == 1 else key


def group_launches(xs) -> int:
    """The launches a grouped call makes (see :func:`group_key`)."""
    return len({group_key(x) for x in xs if math.prod(leaf_shape(x))})


def _segment_rows(x, scales, col: bool):
    """One segment's clients as dequantised fp32 rank rows ``(n, R, E)``."""
    if isinstance(x, torch.Tensor):
        xf = leaf_rank_rows(x.float(), col)
        sc = None if scales is None else scales.float().reshape(
            xf.shape[0], -1)
    else:
        xf = leaf_rank_rows(torch.stack([t.float() for t in x]), col)
        sc = None
        if scales is not None and any(s is not None for s in scales):
            sc = torch.stack([
                torch.ones(xf.shape[1], device=xf.device) if s is None
                else s.float().reshape(-1) for s in scales])
    if sc is not None:
        xf = sc[:, :, None] * xf
    return xf


def _group_ref(arith, name, xs, masks, weights, prevs, cols, scales,
               mask_offs, out_dtypes):
    runtime.PLAIN_CALLS[name] += group_launches(xs)
    m_all, w = masks.float(), weights.float()
    outs = []
    for x, prev, col, sc, off, odt in zip(xs, prevs, cols, scales,
                                          mask_offs, out_dtypes):
        shape = leaf_shape(x)
        if not math.prod(shape):
            outs.append(torch.empty(shape, dtype=odt, device=w.device))
            continue
        xf = _segment_rows(x, sc, col)
        m = m_all[:, off:off + xf.shape[1]]
        pv = None if prev is None else leaf_rank_rows(prev[None], col)[0]
        out = arith(xf, m, w, pv)
        outs.append(leaf_from_rank_rows(out, shape, col).to(odt)
                    .contiguous())
    return outs


def packed_agg_group_ref(xs, masks, weights, prevs, *, cols, scales,
                         mask_offs, out_dtypes, norm_by: str = "mask",
                         norm_restore: bool = False):
    """The grouped mean: :func:`packed_agg_ref`'s arithmetic on every
    segment.  ``xs[i]`` is a leaf stacked over the clients ``(n, *shape)``
    or a sequence of n per-client leaves of ``shape``; ``cols[i]`` reads
    its rank rows along the last axis (a B leaf); ``scales[i]`` the
    per-client dequantisation scales of its rank rows (stacked, or one per
    client, None for a client without); ``mask_offs[i]`` its first column
    of ``masks`` (n, mask_cols); each result in the leaf's shape and
    ``out_dtypes[i]``.  Counts one plain call per launch the kernel would
    make (:func:`group_launches`)."""
    return _group_ref(
        lambda xf, m, w, pv: _packed_agg_math(xf, m, w, pv, norm_by,
                                              norm_restore),
        "packed_agg", xs, masks, weights, prevs, cols, scales, mask_offs,
        out_dtypes)


def packed_robust_group_ref(xs, masks, weights, prevs, *, mode: str, cols,
                            scales, mask_offs, out_dtypes,
                            clip_norm: float = 0.0, trim_frac: float = 0.0):
    """The grouped robust aggregation: :func:`packed_robust_ref`'s
    arithmetic on every segment, laid out as in
    :func:`packed_agg_group_ref`."""
    _check_mode(mode)
    return _group_ref(
        lambda xf, m, w, pv: _packed_robust_math(xf, m, w, pv, mode,
                                                 clip_norm, trim_frac),
        "packed_robust", xs, masks, weights, prevs, cols, scales, mask_offs,
        out_dtypes)
