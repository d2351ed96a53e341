"""Wrappers of the aggregation kernels in ``csrc/rbla_agg.cu``.

Same arguments as the JAX package's ``repro.kernels.rbla_agg.ops``
(``backend`` takes the place of ``interpret``).  Trailing dims flatten into
the row width D and are restored on the way out; there is no tile padding:
the kernels bound their own column loops.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor runs the plain version in
``ref.py``.  PyTorch runs eagerly, so ``packed_agg_inline`` -- the form the
JAX plans call inside a traced round -- is the same function.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import build, runtime
from .ref import packed_agg_ref, rbla_agg_ref

#: legacy method names -> the kernels' two normalisation modes
_NORM_BY = {"rbla": "mask", "zeropad": "weight"}
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rbla_agg")
    lib.rbla_packed_agg.argtypes = [_P, _I, _P, _P, _P, _P, _P, _I, _P,
                                    _L, _L, _L, _I, _I, _P]
    lib.rbla_packed_agg.restype = _I
    lib.rbla_rank_agg.argtypes = [_P, _I, _P, _P, _P, _L, _L, _L, _I, _P]
    lib.rbla_rank_agg.restype = _I
    lib.rbla_error_string.argtypes = [_I]
    lib.rbla_error_string.restype = ctypes.c_char_p
    return lib


def _flat(x, name: str):
    if x.ndim < 2:
        raise ValueError(f"{name}: x must be (N, R, *dims), got {tuple(x.shape)}")
    n, r = x.shape[:2]
    lead = tuple(x.shape[2:])
    return x.reshape(n, r, math.prod(lead)), lead


def _on(t, device, dtype, name: str):
    """``t`` as a contiguous ``dtype`` tensor on ``device``; a tensor that
    lies on another device is refused (no hidden transfer)."""
    if not isinstance(t, torch.Tensor):
        return torch.as_tensor(t, dtype=dtype, device=device).contiguous()
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    return t.to(dtype).contiguous()


def _norm_code(norm_by: str) -> int:
    if norm_by not in ("mask", "weight"):
        raise ValueError(f"unknown norm_by {norm_by!r}; options: "
                         "['mask', 'weight']")
    return int(norm_by == "weight")


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().rbla_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error "
                           f"{err})")


def _packed_agg_cuda(x, masks, weights, prev, scales, out_dtype, norm_by,
                     norm_restore):
    n, r, d = x.shape
    dev = x.device
    if x.dtype not in _IN_CODES:
        raise TypeError(f"packed_agg: x dtype {x.dtype} not in "
                        f"{list(_IN_CODES)}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"packed_agg: out_dtype {out_dtype} not in "
                        f"{list(_OUT_CODES)}")
    if not x.is_contiguous():
        raise ValueError("packed_agg: x must be contiguous")
    by_weight = _norm_code(norm_by)
    masks = _on(masks, dev, torch.float32, "masks")
    weights = _on(weights, dev, torch.float32, "weights")
    if weights.shape != (n,):
        raise ValueError(f"packed_agg: weights {tuple(weights.shape)} != ({n},)")
    if scales is not None:
        scales = _on(scales, dev, torch.float32, "scales")
    if prev is not None:
        prev = _on(prev, dev, out_dtype, "prev")
    out = torch.empty((r, d), dtype=out_dtype, device=dev)
    if r * d == 0:
        return out
    scratch = None
    if norm_restore:
        scratch = (out if out_dtype == torch.float32
                   else torch.empty((r, d), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        err = _lib().rbla_packed_agg(
            x.data_ptr(), _IN_CODES[x.dtype], masks.data_ptr(),
            weights.data_ptr(), None if prev is None else prev.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            _OUT_CODES[out_dtype],
            None if scratch is None else scratch.data_ptr(), n, r, d,
            by_weight, int(norm_restore),
            torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(err, "packed_agg")
    runtime.LAUNCHES["packed_agg"] += 1
    return out


def packed_agg(x, masks, weights, prev=None, *, norm_by: str = "mask",
               norm_restore: bool = False, scales=None, out_dtype=None,
               backend: str = "auto"):
    """Fused-bucket aggregation (the compiled plan's hot op).

    ``x``: (N, R, *dims) packed rows spanning many pairs; ``masks``:
    (N, R) per-row owner indicators; ``weights``: (N,); ``prev``:
    (R, *dims) previous global, kept where no participant owns a row
    (``norm_by="mask"`` only); ``scales``: optional (N, R) per-row
    dequantisation scales applied on the load; ``out_dtype`` sets the
    output dtype (required when ``x`` is int8; ``prev`` is staged in it).
    ``norm_restore`` adds rbla_norm's per-row norm restoration.
    """
    x2, lead = _flat(x, "packed_agg")
    n, r, d = x2.shape
    if tuple(masks.shape) != (n, r):
        raise ValueError(f"packed_agg: masks {tuple(masks.shape)} != ({n}, {r})")
    if scales is not None and tuple(scales.shape) != (n, r):
        raise ValueError(f"packed_agg: scales {tuple(scales.shape)} != "
                         f"({n}, {r})")
    out_dtype = out_dtype or x.dtype
    pv = None
    if prev is not None:
        if tuple(prev.shape) != (r,) + lead:
            raise ValueError(f"packed_agg: prev {tuple(prev.shape)} != "
                             f"{(r,) + lead}")
        pv = prev.reshape(r, d)
    if runtime.use_kernel(backend, x, "packed_agg"):
        out = _packed_agg_cuda(x2, masks, weights, pv, scales, out_dtype,
                               norm_by, norm_restore)
    else:
        out = packed_agg_ref(x2, masks, torch.as_tensor(weights), pv,
                             norm_by=norm_by, norm_restore=norm_restore,
                             scales=scales, out_dtype=out_dtype)
    return out.reshape((r,) + lead)


packed_agg_inline = packed_agg


def _rbla_agg_cuda(x, ranks, weights, norm_by):
    n, r, d = x.shape
    dev = x.device
    if x.dtype not in _OUT_CODES:
        raise TypeError(f"rbla_agg: x dtype {x.dtype} not in "
                        f"{list(_OUT_CODES)}")
    if not x.is_contiguous():
        raise ValueError("rbla_agg: x must be contiguous (pass B's "
                         "rank-leading view as a contiguous copy)")
    by_weight = _norm_code(norm_by)
    ranks = _on(ranks, dev, torch.int32, "ranks")
    weights = _on(weights, dev, torch.float32, "weights")
    if ranks.shape != (n,) or weights.shape != (n,):
        raise ValueError(f"rbla_agg: ranks {tuple(ranks.shape)} / weights "
                         f"{tuple(weights.shape)} != ({n},)")
    out = torch.empty((r, d), dtype=x.dtype, device=dev)
    if r * d == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().rbla_rank_agg(
            x.data_ptr(), _OUT_CODES[x.dtype], ranks.data_ptr(),
            weights.data_ptr(), out.data_ptr(), n, r, d, by_weight,
            torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(err, "rbla_agg")
    runtime.LAUNCHES["rbla_agg"] += 1
    return out


def rbla_agg(x, ranks, weights, *, method: str = "rbla",
             backend: str = "auto"):
    """Aggregate stacked client tensors (N, R, *dims) with rank-row masks
    ``[r < ranks[n]]`` (paper Eq. 7).  ``method="rbla"`` divides by the
    owners' weight mass, ``"zeropad"`` by the total mass."""
    try:
        norm_by = _NORM_BY[method]
    except KeyError:
        raise ValueError(f"unknown kernel method {method!r}; options: "
                         f"{sorted(_NORM_BY)}") from None
    x2, lead = _flat(x, "rbla_agg")
    r = x2.shape[1]
    if runtime.use_kernel(backend, x, "rbla_agg"):
        out = _rbla_agg_cuda(x2, ranks, weights, norm_by)
    else:
        out = rbla_agg_ref(x2, torch.as_tensor(ranks),
                           torch.as_tensor(weights), norm_by=norm_by)
    return out.reshape((r,) + lead)


__all__ = ["packed_agg", "packed_agg_inline", "rbla_agg", "packed_agg_ref",
           "rbla_agg_ref"]
