"""Wrappers of the aggregation kernels in ``csrc/rbla_agg.cu``,
``csrc/packed_robust.cu``, ``csrc/flora_stack.cu`` and ``csrc/axpy_fold.cu``.

Same arguments as the JAX package's ``repro.kernels.rbla_agg.ops``
(``backend`` takes the place of ``interpret``).  Trailing dims flatten into
the row width D and are restored on the way out; there is no tile padding:
the kernels bound their own column loops.  A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor runs the plain version in
``ref.py``.  PyTorch runs eagerly, so ``packed_agg_inline`` -- the form the
JAX plans call inside a traced round -- is the same function.
"""
from __future__ import annotations

import array
import contextlib
import ctypes
import dataclasses
import functools
import math
import struct

import numpy as np
import torch

from .. import build, runtime
from ..runtime import check_launch as _check_launch
from ..runtime import stream_handle as _stream
from .ref import (ROBUST_MODES, axpy_fold_group_ref, axpy_fold_ref,
                  flora_stack_group_ref, flora_stack_ref, group_key,
                  leaf_shape,
                  packed_agg_group_ref, packed_agg_ref,
                  packed_robust_group_ref, packed_robust_ref,
                  packed_stack_group_ref, packed_stack_ref,
                  rbla_agg_group_ref, rbla_agg_ref)

#: legacy method names -> the kernels' two normalisation modes
_NORM_BY = {"rbla": "mask", "zeropad": "weight"}
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rbla_agg")
    _bind_group(lib, "packed_agg", [])
    _bind_group(lib, "rbla_agg", [])
    return lib


@functools.cache
def _robust_lib() -> ctypes.CDLL:
    lib = build.load("packed_robust")
    _bind_group(lib, "packed_robust", [_F, _F])
    return lib


def _bind_group(lib, name: str, knobs: list) -> None:
    """ctypes signatures of a grouped kernel's three C entry points and the
    table queries every grouped library carries (csrc/agg_group.cuh)."""
    head = [_P, _L, _P, _I, _I, _I]     # masks (or ranks), mask_cols, weights,
    #                                     n, dtype, mode
    getattr(lib, f"{name}_group").argtypes = [_P, _I, _P, _I, _P] + head \
        + knobs + [_P]
    getattr(lib, f"{name}_layout").argtypes = [_P, _I, _P, _I, _P, _I, _I,
                                               _I, _P, _P]
    getattr(lib, f"{name}_group_table").argtypes = [_P, _I, _I, _L] + head \
        + knobs + [_P]
    lib.agg_group_fits_inline.argtypes = [_I, _I, _I, _I]
    lib.agg_group_table_bytes.argtypes = [_I, _I, _I]
    lib.agg_group_table_bytes.restype = _L
    for fn in ("group", "layout", "group_table"):
        getattr(lib, f"{name}_{fn}").restype = _I
    lib.agg_group_fits_inline.restype = _I


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


# ---------------------------------------------- grouped packed_agg / robust --
#: the kernels' dtype code of a launch whose clients differ (agg_group.cuh)
_MIXED = 3
_NORM_RESTORE = 2             # packed_agg's mode bit (bit 0: norm_by "weight")


@functools.lru_cache(maxsize=4096)
def _seg_geometry(shape: tuple, col: bool) -> tuple:
    """``(rows, width, col_group, rank_rows, numel)`` of a leaf of ``shape``:
    memory rows of ``width`` contiguous elements; in column mode (a B leaf
    ``(*lead, fan_out, r)``) ``col_group`` is fan_out and the rank rows run
    along the last axis."""
    if len(shape) < 2:
        raise ValueError(f"a segment is a leaf of at least 2 dims, got "
                         f"{shape}")
    numel = math.prod(shape)
    width = shape[-1]
    rows = numel // width if width else math.prod(shape[:-1])
    if col:
        return rows, width, shape[-2], math.prod(shape[:-2]) * width, numel
    return rows, width, 0, rows, numel


def _group_args(name, xs, masks, weights, prevs, cols, scales, mask_offs,
                out_dtypes):
    """Check a grouped call and fill in its defaults: per segment its prev,
    column flag, scales, mask offset (default: the segments' rank rows one
    after another) and output dtype (default the leaf's, fp32 for
    per-client leaves of differing dtypes)."""
    k = len(xs)
    if not k:
        raise ValueError(f"{name}_group: no segments")
    lists = dict(prevs=prevs, cols=cols, scales=scales, mask_offs=mask_offs,
                 out_dtypes=out_dtypes)
    for key, v in lists.items():
        if v is not None and len(v) != k:
            raise ValueError(f"{name}_group: {k} segments, {len(v)} {key}")
    n = int(masks.shape[0]) if masks.ndim == 2 else -1
    if masks.ndim != 2 or tuple(weights.shape) != (n,):
        raise ValueError(f"{name}_group: masks {tuple(masks.shape)} and "
                         f"weights {tuple(weights.shape)} must be (n, "
                         "mask_cols) and (n,)")
    cols = (False,) * k if cols is None else tuple(bool(c) for c in cols)
    prevs = (None,) * k if prevs is None else tuple(prevs)
    scales = (None,) * k if scales is None else tuple(scales)
    offs, dts, off = [], [], 0
    for i, x in enumerate(xs):
        if isinstance(x, torch.Tensor):
            if x.shape[0] != n:
                raise ValueError(f"{name}_group: segment {i} stacks "
                                 f"{x.shape[0]} clients, masks {n}")
        elif len(x) != n or any(t.shape != x[0].shape for t in x):
            raise ValueError(f"{name}_group: segment {i} needs {n} "
                             "per-client leaves of one shape")
        shape = leaf_shape(x)
        geo = _seg_geometry(shape, cols[i])
        o = off if mask_offs is None else int(mask_offs[i])
        if o < 0 or o + geo[3] > masks.shape[1]:
            raise ValueError(f"{name}_group: segment {i}'s rank rows "
                             f"[{o}, {o + geo[3]}) exceed the masks' "
                             f"{masks.shape[1]} columns")
        offs.append(o)
        off = o + geo[3]
        if prevs[i] is not None and tuple(prevs[i].shape) != shape:
            raise ValueError(f"{name}_group: prev {tuple(prevs[i].shape)} "
                             f"!= the leaf's {shape}")
        sc = scales[i]
        if sc is not None and not (
                sc.numel() == n * geo[3] if isinstance(sc, torch.Tensor)
                else len(sc) == n and all(t is None or t.numel() == geo[3]
                                          for t in sc)):
            raise ValueError(f"{name}_group: segment {i}'s scales do "
                                 f"not hold one per (client, rank row): "
                                 f"{geo[3]} rank rows")
        if out_dtypes is not None and out_dtypes[i] is not None:
            dts.append(out_dtypes[i])
        else:
            key = group_key(x)
            dts.append(key[0] if len(key) == 1 else torch.float32)
    return prevs, cols, scales, tuple(offs), tuple(dts)


def _f32(t, index: int, name: str, dtype=torch.float32):
    """``t`` as a contiguous ``dtype`` (default fp32) tensor on CUDA device
    ``index`` (copied only where it is not one); a tensor elsewhere is
    refused."""
    if not isinstance(t, torch.Tensor):
        return torch.as_tensor(t, dtype=dtype,
                               device=f"cuda:{index}").contiguous()
    if t.get_device() != index:
        raise ValueError(f"{name} is on {t.device}, x on cuda:{index}")
    if t.dtype != dtype or not t.is_contiguous():
        t = t.to(dtype).contiguous()
    return t


def grouped_launch(name: str, xs, masks, weights, prevs, *, cols, scales,
                   mask_offs, out_dtypes, outs=None, **kw) -> list:
    """The card path of :func:`packed_agg_group` (``name`` "packed_agg",
    ``kw`` its ``norm_by`` and ``norm_restore``) or
    :func:`packed_robust_group` ("packed_robust", ``kw`` its ``mode``,
    ``clip_norm`` and ``trim_frac``) without their argument checks: for a
    caller whose segments come from a checked geometry (the compiled
    plans), every list given in full (``outs`` as in
    :func:`packed_agg_group`).  CPU tensors are refused, as the kernel
    backend refuses them everywhere."""
    runtime.use_kernel("kernel", xs[0] if isinstance(xs[0], torch.Tensor)
                       else xs[0][0], name)
    if name == "packed_agg":
        mode = _norm_code(kw.get("norm_by", "mask")) \
            | _NORM_RESTORE * bool(kw.get("norm_restore", False))
        return _group_cuda(name, _lib(), xs, masks, weights, prevs, cols,
                           scales, mask_offs, out_dtypes, mode, outs=outs)
    return _group_cuda(name, _robust_lib(), xs, masks, weights, prevs, cols,
                       scales, mask_offs, out_dtypes, _MODE_CODES[kw["mode"]],
                       (float(kw.get("clip_norm", 0.0)),
                        float(kw.get("trim_frac", 0.0))), outs=outs)


def _check_outs(name: str, outs, shapes, dtypes) -> tuple:
    """``outs`` (None, or per segment None or the tensor to write) checked
    against each output's shape and dtype: a given output is written in
    place, so it must be contiguous and exactly the output's."""
    if outs is None:
        return (None,) * len(shapes)
    outs = tuple(outs)
    if len(outs) != len(shapes):
        raise ValueError(f"{name}: {len(shapes)} segments, {len(outs)} outs")
    for i, (o, shape, dt) in enumerate(zip(outs, shapes, dtypes)):
        if o is not None and (tuple(o.shape) != tuple(shape)
                              or o.dtype != dt or not o.is_contiguous()):
            raise ValueError(
                f"{name}: out {i} is {tuple(o.shape)} {o.dtype}"
                f"{'' if o.is_contiguous() else ' (not contiguous)'}; "
                f"the output is {tuple(shape)} {dt}, contiguous")
    return outs


def write_into(outs, results) -> list:
    """The plain path's ``outs``: each result copied into its given output
    (donated storage), the result itself where none is given."""
    if outs is None:
        return list(results)
    return [r if o is None else o.copy_(r) for o, r in zip(outs, results)]


@dataclasses.dataclass(eq=False)
class _Layout:
    """The static part of one launch's segment table: each segment's words
    with its pointers left 0, and where its output lies in one allocation
    per output dtype.  Built once per geometry; a call fills the pointers."""
    words: array.array          # twelve words a segment (SegIn)
    n_ents: int                 # per-client entries (Entry, two words)
    shapes: tuple
    strides: tuple
    numels: tuple
    out_dtypes: tuple
    offsets: tuple              # each output's first element in its buffer
    sizes: dict                 # elements of each output dtype's buffer
    esize: int                  # a stacked client element's bytes, or 0


@functools.lru_cache(maxsize=512)
def _layout(geo: tuple, esize: int) -> _Layout:
    """``geo``: per segment ``(shape, col, mask_off, out_dtype,
    per_client)``; ``esize``: the clients' element bytes (stacked
    segments step by it)."""
    words, sizes, offsets, strides, numels = array.array("q"), {}, [], [], []
    n_ents = 0
    for shape, col, off, odt, per_client in geo:
        rows, width, col_group, rr, numel = _seg_geometry(shape, col)
        at = sizes.get(odt, 0)
        offsets.append(at)
        sizes[odt] = at + -(-numel // 16) * 16      # 64-byte aligned outputs
        strides.append(tuple(math.prod(shape[i + 1:])
                             for i in range(len(shape))))
        numels.append(numel)
        n_ents += per_client
        words.extend((0, numel, 0, rr, 0, 0, rows, width, col_group, off,
                      0 if per_client else -1, _OUT_CODES[odt]))
    return _Layout(words, n_ents, tuple(g[0] for g in geo), tuple(strides),
                   tuple(numels), tuple(g[3] for g in geo), tuple(offsets),
                   sizes, esize)


def _group_cuda(name, lib, xs, masks, weights, prevs, cols, scales,
                mask_offs, out_dtypes, mode, knobs=(), outs=None):
    """Run a checked grouped call on the card: one launch per client-dtype
    key (:func:`group_key`).  Returns the outputs in order: ``outs[i]``
    where it is given (checked by :func:`_check_outs`; written in place),
    else a view of one allocation per output dtype.  ``masks`` are the
    owner masks, or for ``name`` "rbla_agg" the rank matrix (a segment's
    mask offset is then its rank column)."""
    x0 = xs[0] if isinstance(xs[0], torch.Tensor) else xs[0][0]
    dev, index = x0.device, x0.get_device()
    # rbla_agg's owner masks are an int32 rank matrix (agg_group.cuh)
    masks = _f32(masks, index, "masks",
                 torch.int32 if name == "rbla_agg" else torch.float32)
    weights = _f32(weights, index, "weights")
    n = int(weights.shape[0])
    by_key: dict = {}
    for i, x in enumerate(xs):
        by_key.setdefault(group_key(x), []).append(i)
    given = _check_outs(name, outs, [leaf_shape(x) for x in xs],
                        out_dtypes)
    outs = [None] * len(xs)
    keep = []
    with (torch.cuda.device(dev) if torch.cuda.current_device() != index
          else contextlib.nullcontext()):
        stream = _stream(dev)
        for key, idx in by_key.items():
            for t in key:
                if t not in _IN_CODES:
                    raise TypeError(f"{name}: x dtype {t} not in "
                                    f"{list(_IN_CODES)}")
            lay = _layout(tuple(
                (leaf_shape(xs[i]), cols[i], mask_offs[i], out_dtypes[i],
                 not isinstance(xs[i], torch.Tensor)) for i in idx),
                key[0].itemsize)
            for odt in lay.out_dtypes:
                if odt not in _OUT_CODES:
                    raise TypeError(f"{name}: out_dtype {odt} not in "
                                    f"{list(_OUT_CODES)}")
            bufs = ({dt: torch.empty(max(sz, 1), dtype=dt, device=dev)
                     for dt, sz in lay.sizes.items()}
                    if any(given[i] is None for i in idx) else {})
            words = array.array("q", lay.words)
            ents = array.array("q", bytes(16 * n * lay.n_ents))
            ent = 0
            for j, i in enumerate(idx):
                odt = lay.out_dtypes[j]
                out = given[i]
                if out is None:
                    out = bufs[odt].as_strided(lay.shapes[j], lay.strides[j],
                                               lay.offsets[j])
                elif out.get_device() != index:
                    raise ValueError(f"{name}: out {i} is on {out.device}, "
                                     f"the call on {dev}")
                outs[i] = out
                if not lay.numels[j]:
                    continue
                w = 12 * j
                words[w + 5] = out.data_ptr()
                x, prev, sc = xs[i], prevs[i], scales[i]
                clients = (x,) if isinstance(x, torch.Tensor) else x
                for t in clients:
                    if t.get_device() != index:
                        raise ValueError(f"{name}: a client leaf is on "
                                         f"{t.device}, the call on {dev}")
                if not all(t.is_contiguous() for t in clients):
                    clients = [t.contiguous() for t in clients]
                    keep.append(clients)
                ptrs = [t.data_ptr() for t in clients]
                vec = words[w + 5] % 16 == 0 and all(p % 16 == 0
                                                     for p in ptrs)
                if prev is not None:
                    if prev.get_device() != index:
                        raise ValueError(f"{name}: prev is on {prev.device}, "
                                         f"the call on {dev}")
                    if prev.dtype != odt or not prev.is_contiguous():
                        prev = prev.to(odt).contiguous()
                        keep.append(prev)
                    words[w + 4] = prev.data_ptr()
                    vec = vec and words[w + 4] % 16 == 0
                if isinstance(x, torch.Tensor):
                    words[w] = ptrs[0]
                    vec = vec and (lay.numels[j] * lay.esize) % 16 == 0
                    if sc is not None:
                        sc = _f32(sc, index, "scales")
                        keep.append(sc)
                        words[w + 2] = sc.data_ptr()
                else:
                    scs = (None,) * n if sc is None else sc
                    for c, (p, s) in enumerate(zip(ptrs, scs)):
                        ents[2 * (ent * n + c)] = p
                        if s is not None:
                            s = _f32(s, index, "scales")
                            keep.append(s)
                            ents[2 * (ent * n + c) + 1] = s.data_ptr()
                    words[w + 10] = ent * n
                    ent += 1
                words[w + 11] |= int(vec) << 8
            codes = None
            if len(key) == 1:
                dtype = _IN_CODES[key[0]]
            else:
                dtype = _MIXED
                codes = bytes(_IN_CODES[t] for t in key)
            n_segs, n_ents = len(idx), n * lay.n_ents
            seg_addr, ent_addr = words.buffer_info()[0], ents.buffer_info()[0]
            head = (masks.data_ptr(), int(masks.shape[1]), weights.data_ptr(),
                    n, dtype, mode, *knobs)
            if lib.agg_group_fits_inline(n_segs, n_ents, n, dtype):
                err = getattr(lib, f"{name}_group")(
                    seg_addr, n_segs, ent_addr, n_ents, codes, *head, stream)
            else:       # the table goes to the card by one async copy
                host = torch.empty(lib.agg_group_table_bytes(
                    n_segs, n_ents, n if codes else 0), dtype=torch.uint8,
                    pin_memory=True)
                tiles = ctypes.c_int64()
                err = getattr(lib, f"{name}_layout")(
                    seg_addr, n_segs, ent_addr, n_ents, codes, n, dtype, mode,
                    host.data_ptr(), ctypes.byref(tiles))
                _check_launch(err, name, lib)
                table = host.to(dev, non_blocking=True)
                err = getattr(lib, f"{name}_group_table")(
                    table.data_ptr(), n_segs, n_ents, tiles.value, *head,
                    stream)
            _check_launch(err, name, lib)
            runtime.LAUNCHES[name] += 1
    return outs


def packed_agg_group(xs, masks, weights, prevs=None, *, cols=None,
                     scales=None, mask_offs=None, out_dtypes=None,
                     norm_by: str = "mask", norm_restore: bool = False,
                     outs=None, backend: str = "auto"):
    """Aggregate every leaf of a round in one call (the compiled plan's op):
    for each segment i the masked weighted mean of :func:`packed_agg` over
    the rank rows of leaf ``xs[i]``, in the leaf's own layout.

    ``xs[i]``: the leaf stacked over the n clients, ``(n, *shape)``, or a
    sequence of n per-client leaves of ``shape`` (an encoded cohort: each
    in its wire dtype, fp32, bf16 or int8).  ``cols[i]`` true: a B leaf
    ``(*lead, fan_out, r)`` whose rank rows are its columns; otherwise its
    rank rows are its rows (an A leaf ``(*lead, r, fan_in)``).  Rank row j
    of segment i takes column ``mask_offs[i] + j`` of the owner masks
    ``masks`` (n, mask_cols) (default: the segments' rank rows one after
    another) and row j of ``scales[i]`` (per (client, rank row):
    ``(n, rank_rows)``, or per client a tensor or None).  ``prevs[i]``
    (the leaf's shape) is kept where no client owns a rank row.  Returns
    one tensor per segment in the leaf's shape and ``out_dtypes[i]``
    (default the leaf's dtype).  ``outs[i]``, where given, is written in
    place and returned: a contiguous tensor of the output's shape and
    dtype, which may be ``prevs[i]`` itself (a donated previous global:
    the kernels read prev and write the output at the same element, in the
    same thread).  On the card every segment whose clients share their
    dtypes runs in ONE launch (``runtime.LAUNCHES["packed_agg"]`` counts
    each); on the CPU the plain version :func:`packed_agg_group_ref`
    runs."""
    prevs, cols, scales, offs, dts = _group_args(
        "packed_agg", xs, masks, weights, prevs, cols, scales, mask_offs,
        out_dtypes)
    mode = _norm_code(norm_by) | _NORM_RESTORE * bool(norm_restore)
    x0 = xs[0] if isinstance(xs[0], torch.Tensor) else xs[0][0]
    if runtime.use_kernel(backend, x0, "packed_agg"):
        return _group_cuda("packed_agg", _lib(), xs, masks, weights, prevs,
                           cols, scales, offs, dts, mode, outs=outs)
    outs = _check_outs("packed_agg", outs, [leaf_shape(x) for x in xs], dts)
    return write_into(outs, packed_agg_group_ref(
        xs, masks, torch.as_tensor(weights), prevs, cols=cols,
        scales=scales, mask_offs=offs, out_dtypes=dts, norm_by=norm_by,
        norm_restore=norm_restore))


def packed_agg(x, masks, weights, prev=None, *, norm_by: str = "mask",
               norm_restore: bool = False, scales=None, out_dtype=None,
               backend: str = "auto"):
    """Fused-bucket aggregation: the one-segment form of
    :func:`packed_agg_group`.

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
        out = _group_cuda(
            "packed_agg", _lib(), [x2], masks, weights, [pv], [False],
            [scales], [0], [out_dtype],
            _norm_code(norm_by) | _NORM_RESTORE * bool(norm_restore))[0]
    else:
        out = packed_agg_ref(x2, masks, torch.as_tensor(weights), pv,
                             norm_by=norm_by, norm_restore=norm_restore,
                             scales=scales, out_dtype=out_dtype)
    return out.reshape((r,) + lead)


packed_agg_inline = packed_agg


def _rbla_args(xs, ranks, weights, prevs, cols, rank_cols, method):
    """Check a :func:`rbla_agg_group` call; returns ``(prevs, cols,
    rank_cols, out dtypes, norm_by)``."""
    try:
        norm_by = _NORM_BY[method]
    except KeyError:
        raise ValueError(f"unknown kernel method {method!r}; options: "
                         f"{sorted(_NORM_BY)}") from None
    k = len(xs)
    if not k:
        raise ValueError("rbla_agg_group: no segments")
    cols = (False,) * k if cols is None else tuple(bool(c) for c in cols)
    rank_cols = (0,) * k if rank_cols is None else tuple(int(c)
                                                         for c in rank_cols)
    prevs = (None,) * k if prevs is None else tuple(prevs)
    for key, v in (("cols", cols), ("rank_cols", rank_cols),
                   ("prevs", prevs)):
        if len(v) != k:
            raise ValueError(f"rbla_agg_group: {k} segments, {len(v)} {key}")
    if ranks.ndim != 2 or tuple(weights.shape) != (ranks.shape[0],):
        raise ValueError(f"rbla_agg_group: ranks {tuple(ranks.shape)} and "
                         f"weights {tuple(weights.shape)} must be (n, "
                         "rank_cols) and (n,)")
    if ranks.is_floating_point() or ranks.is_complex():
        raise TypeError(f"rbla_agg_group: ranks must be integers, got "
                        f"{ranks.dtype}")
    n, dts = int(ranks.shape[0]), []
    for i, (x, prev, c) in enumerate(zip(xs, prevs, rank_cols)):
        if not isinstance(x, torch.Tensor) or x.ndim != 3 \
                or x.shape[0] != n:
            raise ValueError(f"rbla_agg_group: segment {i} must be one pair "
                             f"side stacked over the {n} clients, (n, r, "
                             f"fan_in) or (n, fan_out, r)")
        if x.dtype not in _OUT_CODES:
            raise TypeError(f"rbla_agg: x dtype {x.dtype} not in "
                            f"{list(_OUT_CODES)}")
        if not 0 <= c < ranks.shape[1]:
            raise ValueError(f"rbla_agg_group: segment {i}'s rank column "
                             f"{c} is outside the ranks' {ranks.shape[1]}")
        if prev is not None and prev.shape != x.shape[1:]:
            raise ValueError(f"rbla_agg_group: prev {tuple(prev.shape)} != "
                             f"the leaf's {tuple(x.shape[1:])}")
        dts.append(x.dtype)
    return prevs, cols, rank_cols, tuple(dts), norm_by


def rbla_agg_group(xs, ranks, weights, prevs=None, *, cols=None,
                   rank_cols=None, method: str = "rbla",
                   backend: str = "auto"):
    """Paper Eq. 7 on every pair side of a per-pair round in one call.

    ``xs[i]``: one pair side stacked over the n clients, an A ``(n, r,
    fan_in)`` whose rank rows are its rows or (``cols[i]`` true) a B ``(n,
    fan_out, r)`` whose rank rows are its columns, each read in its own
    layout.  Client c owns rank row j of segment i iff ``j < ranks[c,
    rank_cols[i]]`` (``ranks`` (n, rank_cols) integers: one column a pair,
    or one for all); ``weights`` (n,).  ``method="rbla"`` divides by the
    owners' weight mass, a rank row some client owns at weight 0 alone is
    0, and rank rows no client owns keep ``prevs[i]`` (0 without);
    ``"zeropad"`` divides by the total mass and keeps no prev.  Returns one
    tensor per segment in the leaf's shape and dtype.  On the card every
    segment of one client dtype runs in ONE launch
    (``runtime.LAUNCHES["rbla_agg"]``); on the CPU the plain version
    :func:`rbla_agg_group_ref` runs."""
    prevs, cols, rank_cols, dts, norm_by = _rbla_args(
        xs, ranks, weights, prevs, cols, rank_cols, method)
    if runtime.use_kernel(backend, xs[0], "rbla_agg"):
        return _group_cuda("rbla_agg", _lib(), xs, ranks, weights, prevs,
                           cols, (None,) * len(xs), rank_cols, dts,
                           _norm_code(norm_by))
    return rbla_agg_group_ref(xs, ranks, torch.as_tensor(weights), prevs,
                              cols=cols, rank_cols=rank_cols, norm_by=norm_by)


def rbla_agg(x, ranks, weights, *, method: str = "rbla",
             backend: str = "auto"):
    """Aggregate stacked client tensors (N, R, *dims) with rank-row masks
    ``[r < ranks[n]]`` (paper Eq. 7): the one-segment form of
    :func:`rbla_agg_group`.  ``method="rbla"`` divides by the owners'
    weight mass (rows no client owns are 0), ``"zeropad"`` by the total
    mass."""
    if method not in _NORM_BY:
        raise ValueError(f"unknown kernel method {method!r}; options: "
                         f"{sorted(_NORM_BY)}")
    x2, lead = _flat(x, "rbla_agg")
    r = x2.shape[1]
    if runtime.use_kernel(backend, x, "rbla_agg"):
        ranks = _on(ranks, x.device, torch.int32, "ranks")
        weights = _on(weights, x.device, torch.float32, "weights")
        if ranks.shape != (x2.shape[0],):
            raise ValueError(f"rbla_agg: ranks {tuple(ranks.shape)} != "
                             f"({x2.shape[0]},)")
        out = rbla_agg_group([x2], ranks[:, None], weights, method=method,
                             backend=backend)[0]
    else:
        out = rbla_agg_ref(x2, torch.as_tensor(ranks),
                           torch.as_tensor(weights),
                           norm_by=_NORM_BY[method])
    return out.reshape((r,) + lead)


# ------------------------------------------------------------ packed_robust --
_MODE_CODES = {"clipped": 0, "trimmed": 1, "median": 2}
#: the largest cohort the packed_robust kernel takes (its per-row shared
#: memory holds a few floats per client); larger cohorts raise
MAX_ROBUST_CLIENTS = 2048


def _check_robust(mode: str, n: int, on_card: bool) -> None:
    if mode not in ROBUST_MODES:
        raise ValueError(f"unknown robust mode {mode!r}; options: "
                         f"{list(ROBUST_MODES)}")
    if on_card and not 1 <= n <= MAX_ROBUST_CLIENTS:
        raise ValueError(f"packed_robust: the kernel takes 1 to "
                         f"{MAX_ROBUST_CLIENTS} clients, got {n}")


def packed_robust_group(xs, masks, weights, prevs=None, *, mode: str,
                        clip_norm: float = 0.0, trim_frac: float = 0.0,
                        cols=None, scales=None, mask_offs=None,
                        out_dtypes=None, outs=None, backend: str = "auto"):
    """The robust aggregation of every leaf of a round in one call:
    :func:`packed_robust`'s ``mode`` over the segments of
    :func:`packed_agg_group` (same layout, masks, scales, prev rule,
    outputs and ``outs``).  On the card one launch per client-dtype key
    (``runtime.LAUNCHES["packed_robust"]``); on the CPU the plain version
    :func:`packed_robust_group_ref`."""
    prevs, cols, scales, offs, dts = _group_args(
        "packed_robust", xs, masks, weights, prevs, cols, scales, mask_offs,
        out_dtypes)
    x0 = xs[0] if isinstance(xs[0], torch.Tensor) else xs[0][0]
    on_card = runtime.use_kernel(backend, x0, "packed_robust")
    _check_robust(mode, int(masks.shape[0]), on_card)
    if on_card:
        return _group_cuda("packed_robust", _robust_lib(), xs, masks,
                           weights, prevs, cols, scales, offs, dts,
                           _MODE_CODES[mode],
                           (float(clip_norm), float(trim_frac)), outs=outs)
    outs = _check_outs("packed_robust", outs, [leaf_shape(x) for x in xs],
                       dts)
    return write_into(outs, packed_robust_group_ref(
        xs, masks, torch.as_tensor(weights), prevs, mode=mode, cols=cols,
        scales=scales, mask_offs=offs, out_dtypes=dts, clip_norm=clip_norm,
        trim_frac=trim_frac))


def packed_robust(x, masks, weights, prev=None, *, mode: str,
                  clip_norm: float = 0.0, trim_frac: float = 0.0,
                  scales=None, out_dtype=None, backend: str = "auto"):
    """Byzantine-robust bucket aggregation, the one-segment form of
    :func:`packed_robust_group`: ``mode`` "clipped" (per-row L2 clip, then
    the masked weighted mean), "trimmed" (per-coordinate trimmed mean over
    a row's owners) or "median" (coordinate-wise median over them); rows no
    client owns keep ``prev``.  Layout, ``scales`` and ``out_dtype`` as in
    :func:`packed_agg` (dequantisation comes before the clip or the sort);
    see ``packed_robust_ref`` for the exact contract."""
    x2, lead = _flat(x, "packed_robust")
    n, r, d = x2.shape
    if tuple(masks.shape) != (n, r):
        raise ValueError(f"packed_robust: masks {tuple(masks.shape)} != "
                         f"({n}, {r})")
    if scales is not None and tuple(scales.shape) != (n, r):
        raise ValueError(f"packed_robust: scales {tuple(scales.shape)} != "
                         f"({n}, {r})")
    on_card = runtime.use_kernel(backend, x, "packed_robust")
    _check_robust(mode, n, on_card)
    out_dtype = out_dtype or x.dtype
    pv = None
    if prev is not None:
        if tuple(prev.shape) != (r,) + lead:
            raise ValueError(f"packed_robust: prev {tuple(prev.shape)} != "
                             f"{(r,) + lead}")
        pv = prev.reshape(r, d)
    kw = dict(mode=mode, clip_norm=clip_norm, trim_frac=trim_frac)
    if on_card:
        out = _group_cuda("packed_robust", _robust_lib(), [x2], masks,
                          weights, [pv], [False], [scales], [0], [out_dtype],
                          _MODE_CODES[mode],
                          (float(clip_norm), float(trim_frac)))[0]
    else:
        out = packed_robust_ref(x2, masks, torch.as_tensor(weights), pv,
                                scales=scales, out_dtype=out_dtype, **kw)
    return out.reshape((r,) + lead)


# ---------------------------------------------------- packed_stack / flora --
_STACK_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FROM_PREV, _ZERO_ROW = -1, -2


@functools.cache
def _stack_lib() -> ctypes.CDLL:
    lib = build.load("flora_stack")
    lib.flora_stack_rows.argtypes = [_P, _I, _P, _P, _P, _P, _L, _L, _L, _P]
    lib.flora_stack_group.argtypes = [_P, _I, _P, _I, _P, _I, _F, _F, _P]
    lib.flora_stack_layout.argtypes = [_P, _I, _P, _I, _P, _P]
    lib.flora_stack_group_table.argtypes = [_P, _I, _I, _I, _L, _P, _I, _F,
                                            _F, _P]
    lib.flora_stack_fits_inline.argtypes = [_I, _I]
    lib.flora_stack_table_bytes.argtypes = [_I, _I]
    lib.flora_stack_table_bytes.restype = _L
    for fn in ("rows", "group", "layout", "group_table", "fits_inline"):
        getattr(lib, f"flora_stack_{fn}").restype = _I
    return lib


@dataclasses.dataclass(eq=False)
class StackTable:
    """A stacking layout as runtime data for the stack kernel: one
    ``(source, source row, scale index)`` int32 triple per output row,
    where the source is a client index, -1 (the previous global) or -2 (a
    zero row), plus the geometry it was checked against.  Build it with
    :func:`stack_table`; the device copy is made once per device."""
    rows: np.ndarray                   # (out_rows, 3) int32
    n: int
    r_in: int
    r_prev: int
    n_scales: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def out_rows(self) -> int:
        return int(self.rows.shape[0])

    def on(self, device) -> torch.Tensor:
        key = str(device)
        got = self._on_device.get(key)
        if got is None:
            got = self._on_device[key] = torch.as_tensor(
                self.rows, device=device)
        return got


def stack_table(copies_x=(), copies_prev=(), *, out_rows: int, n: int,
                r_in: int, r_prev: int = 0, n_scales: int) -> StackTable:
    """The per-row table of a ``packed_stack`` copy list, validated as the
    TPU kernel validates it (a copy out of range raises ``ValueError``).
    Copies are laid down in order, x copies before prev copies, so a later
    copy wins where two overlap."""
    rows = np.empty((out_rows, 3), np.int32)
    rows[:] = (_ZERO_ROW, 0, 0)
    for (src, s0, d0, nr, si) in copies_x:
        if not (0 <= src < n and 0 <= s0 and 0 <= nr and s0 + nr <= r_in
                and 0 <= d0 and d0 + nr <= out_rows
                and 0 <= si < n_scales):
            raise ValueError(f"packed_stack: bad copy {(src, s0, d0, nr, si)}")
        rows[d0:d0 + nr, 0] = src
        rows[d0:d0 + nr, 1] = np.arange(s0, s0 + nr)
        rows[d0:d0 + nr, 2] = si
    for (s0, d0, nr, si) in copies_prev:
        if not (0 <= s0 and 0 <= nr and s0 + nr <= r_prev
                and 0 <= d0 and d0 + nr <= out_rows
                and 0 <= si < n_scales):
            raise ValueError(f"packed_stack: bad prev copy {(s0, d0, nr, si)}")
        rows[d0:d0 + nr, 0] = _FROM_PREV
        rows[d0:d0 + nr, 1] = np.arange(s0, s0 + nr)
        rows[d0:d0 + nr, 2] = si
    return StackTable(rows=rows, n=n, r_in=r_in, r_prev=r_prev,
                      n_scales=n_scales)


def _check_segs(segs, n: int, r: int, out_rows: int) -> tuple:
    segs = tuple(int(s) for s in segs)
    if len(segs) != n:
        raise ValueError(f"{len(segs)} segments for {n} contributors")
    if any(s < 0 or s > r for s in segs):
        raise ValueError(f"segment sizes {segs} outside [0, {r}]")
    if sum(segs) > out_rows:
        raise ValueError(f"stacked rows {sum(segs)} exceed out_rows="
                         f"{out_rows}")
    return segs


def _stack_cuda(x, scales, prev, table: StackTable, name: str):
    n, r_in, d = x.shape
    dev = x.device
    if x.dtype not in _STACK_CODES:
        raise TypeError(f"{name}: x dtype {x.dtype} not in "
                        f"{list(_STACK_CODES)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    scales = _on(scales, dev, torch.float32, "scales")
    if prev is not None:
        if prev.device != dev or prev.dtype != x.dtype:
            raise ValueError(f"{name}: prev must be a {x.dtype} tensor on "
                             f"{dev}, got {prev.dtype} on {prev.device}")
        prev = prev.contiguous()
    out = torch.empty((table.out_rows, d), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _stack_lib().flora_stack_rows(
            x.data_ptr(), _STACK_CODES[x.dtype],
            None if prev is None else prev.data_ptr(), scales.data_ptr(),
            table.on(dev).data_ptr(), out.data_ptr(), r_in, table.out_rows,
            d, _stream(dev))
    _check_launch(err, name, _stack_lib())
    runtime.LAUNCHES[name] += 1
    return out


def packed_stack(x, scales, prev=None, *, copies_x=(), copies_prev=(),
                 out_rows: int, table: StackTable | None = None,
                 backend: str = "auto"):
    """Fused FLoRA stacking over a packed bucket: the TPU kernel's own
    copy-list interface (``packed_stack_pallas``), on the per-row table
    kernel ``flora_stack_rows``.  The flora plan no longer calls it: its
    round is one :func:`packed_stack_group` call on the leaves where they
    lie.

    ``x``: (N, R_in, D); ``scales``: (S,); ``prev``: (R_prev, D) or None;
    ``copies_x`` entries ``(client, src_row, dst_row, rows, scale_idx)``
    and ``copies_prev`` entries ``(src_row, dst_row, rows, scale_idx)``
    place scaled rows; rows no copy touches are zero.  ``table``: the
    layout already built by :func:`stack_table` (a plan caches it); when
    given, the copies are not read again.  -> (out_rows, D) in x's dtype.
    """
    n, r_in, d = x.shape
    r_prev = 0 if prev is None else int(prev.shape[0])
    if copies_prev and prev is None:
        raise ValueError("packed_stack: prev copies but no prev buffer")
    if prev is not None and prev.shape[-1] != d:
        raise ValueError(f"packed_stack: prev width {prev.shape[-1]} != {d}")
    n_scales = int(torch.as_tensor(scales).shape[0])
    if table is None:
        table = stack_table(copies_x, copies_prev, out_rows=out_rows, n=n,
                            r_in=r_in, r_prev=r_prev, n_scales=n_scales)
    elif (table.out_rows, table.n, table.r_in, table.n_scales) != (
            out_rows, n, r_in, n_scales) or table.r_prev > r_prev:
        raise ValueError("packed_stack: the table was built for another "
                         "geometry")
    if runtime.use_kernel(backend, x, "packed_stack"):
        return _stack_cuda(x, scales, prev, table, "packed_stack")
    return packed_stack_ref(x, scales, prev, copies_x=copies_x,
                            copies_prev=copies_prev, out_rows=out_rows)


#: a grouped stack segment's scale mode (``ScaleMode`` in csrc/flora_stack.cu)
_UNIT, _GIVEN, _MASS = 0, 1, 2


def _stack_args(name, shapes, contribs, prev_shapes, cols, cap, scales):
    """Check a grouped stack from the shapes of its cohort leaves ``(n,
    *lead, a, b)`` and of its prevs (None where a segment has none);
    returns the client count and per segment its prev shape, column flag,
    cap and scale (None, a tensor or "mass")."""
    k = len(shapes)
    if not k:
        raise ValueError(f"{name}: no segments")
    caps = (cap,) * k if isinstance(cap, int) else tuple(cap)
    per = dict(contribs=contribs, prevs=prev_shapes, cols=cols,
               scales=scales, caps=caps)
    for key, v in per.items():
        if v is not None and len(v) != k:
            raise ValueError(f"{name}: {k} segments, {len(v)} {key}")
    prev_shapes = (None,) * k if prev_shapes is None else tuple(prev_shapes)
    cols = (False,) * k if cols is None else tuple(bool(c) for c in cols)
    scales = (None,) * k if scales is None else tuple(scales)
    n = int(shapes[0][0]) if len(shapes[0]) else 0
    for i, (shape, con, pshape, col, c, sc) in enumerate(zip(
            shapes, contribs, prev_shapes, cols, caps, scales)):
        if len(shape) < 3 or shape[0] != n:
            raise ValueError(f"{name}: segment {i} must be a leaf (*lead, "
                             f"a, b) stacked over the {n} clients, got "
                             f"{tuple(shape)}")
        r_in = shape[-1] if col else shape[-2]
        r_prev = 0
        if pshape is not None:
            want = tuple(shape[1:-2]) + ((shape[-2],) if col
                                         else (shape[-1],))
            got = tuple(pshape[:-2]) + ((pshape[-2],) if col
                                        else (pshape[-1],))
            if len(pshape) != len(shape) - 1 or got != want:
                raise ValueError(f"{name}: prev {tuple(pshape)} does not "
                                 f"match the leaf {tuple(shape[1:])} but in "
                                 "its rank")
            r_prev = pshape[-1] if col else pshape[-2]
        for src, rows in con:
            top = r_prev if src == -1 else r_in
            if not (-1 <= src < n and (src != -1 or pshape is not None)
                    and 0 <= rows <= top):
                raise ValueError(f"{name}: segment {i}: contributor "
                                 f"{(src, rows)} outside the {n} clients' "
                                 f"{r_in} and prev's {r_prev} rank rows")
        if sum(rows for _, rows in con) > c:
            raise ValueError(f"{name}: segment {i} stacks "
                             f"{sum(rows for _, rows in con)} rank rows, "
                             f"its cap is {c}")
        if isinstance(sc, str):
            if sc != "mass":
                raise ValueError(f"{name}: a scale is None, a tensor or "
                                 "'mass' (with weights)")
        elif sc is not None and tuple(sc.shape) != (len(con),):
            raise ValueError(f"{name}: segment {i}'s scales "
                             f"{tuple(sc.shape)} != ({len(con)},)")
    return n, prev_shapes, cols, caps, scales


def _stack_weights(name, weights, n: int, scales) -> None:
    if weights is None and any(isinstance(sc, str) for sc in scales):
        raise ValueError(f"{name}: a scale is None, a tensor or 'mass' "
                         "(with weights)")
    if weights is not None and tuple(weights.shape) != (n,):
        raise ValueError(f"{name}: weights {tuple(weights.shape)} != "
                         f"({n},)")


def _contribs(contribs) -> tuple:
    return tuple(tuple((int(s), int(r)) for s, r in con) for con in contribs)


@dataclasses.dataclass(eq=False)
class _StackLayout:
    """The static part of a grouped stack launch: each segment's twelve
    words with the pointers left 0 (``StackSegIn``), the contributor table
    (one int32 pair each; segments with the same contributors share
    theirs), and each output's shape and place in one allocation per
    output dtype."""
    words: array.array
    pairs: array.array
    n_contrib: int
    max_contrib: int
    shapes: tuple
    strides: tuple
    offsets: tuple
    sizes: dict
    out_dtypes: tuple
    modes: tuple


@functools.lru_cache(maxsize=512)
def _stack_layout(geo: tuple) -> _StackLayout:
    """``geo``: per segment ``(leaf shape without the client axis, col,
    cap, contributors, prev shape, x dtype, prev dtype, out dtype, scale
    mode)``."""
    words, table, firsts, sizes = array.array("q"), [], {}, {}
    offsets, shapes, strides = [], [], []
    for shape, col, cap, con, pshape, xdt, pdt, odt, mode in geo:
        for dt in (xdt, pdt, odt):
            if dt is not None and dt not in _OUT_CODES:
                raise TypeError(f"flora_stack: dtype {dt} not in "
                                f"{list(_OUT_CODES)}")
        lead = shape[:-2]
        width, r_in = (shape[-2], shape[-1]) if col else (shape[-1],
                                                          shape[-2])
        r_prev = 0 if pshape is None else (pshape[-1] if col else pshape[-2])
        if con not in firsts:
            firsts[con] = len(table)
            table.extend(con)
        out = tuple(lead) + ((shape[-2], cap) if col else (cap, shape[-1]))
        shapes.append(out)
        strides.append(tuple(math.prod(out[j + 1:]) for j in range(len(out))))
        numel = math.prod(out)
        at = sizes.get(odt, 0)
        offsets.append(at)
        sizes[odt] = at + -(-numel // 16) * 16      # 64-byte aligned outputs
        flags = int(col) | _OUT_CODES[xdt] << 8 \
            | (_OUT_CODES[pdt] if pdt is not None else 0) << 12 \
            | _OUT_CODES[odt] << 16 | mode << 20
        words.extend((0, math.prod(shape), 0, 0, 0, math.prod(lead), width,
                      r_in, r_prev, cap, firsts[con] | len(con) << 32,
                      flags))
    pairs = array.array("i", [v for src_rows in table for v in src_rows])
    return _StackLayout(words, pairs, len(table),
                        max(len(g[3]) for g in geo), tuple(shapes),
                        tuple(strides), tuple(offsets), sizes,
                        tuple(g[7] for g in geo), tuple(g[8] for g in geo))


def _stack_group_cuda(lay: _StackLayout, xs, prevs, scales, weights,
                      prev_weight, eps, name: str, outs=None) -> list:
    """Run a checked grouped stack on the card in one launch: its static
    layout ``lay`` is built, a call fills in the pointers and the vector
    flags.  ``outs[i]``, where given (checked by :func:`_check_outs`), is
    written in place.  Counts the launch as ``runtime.LAUNCHES[name]``."""
    x0 = xs[0]
    dev, index = x0.device, x0.get_device()
    words = array.array("q", lay.words)
    given = _check_outs(name, outs, lay.shapes, lay.out_dtypes)
    bufs = ({dt: torch.empty(max(sz, 1), dtype=dt, device=dev)
             for dt, sz in lay.sizes.items()}
            if any(o is None for o in given) else {})
    outs, keep = [], []
    w = None
    if _MASS in lay.modes:
        w = _f32(weights, index, "weights")
    for i, (x, prev) in enumerate(zip(xs, prevs)):
        for t in (x, prev):
            if t is not None and t.get_device() != index:
                raise ValueError(f"{name}: a leaf is on {t.device}, the "
                                 f"call on {dev}")
        out = given[i]
        if out is None:
            out = bufs[lay.out_dtypes[i]].as_strided(
                lay.shapes[i], lay.strides[i], lay.offsets[i])
        elif out.get_device() != index:
            raise ValueError(f"{name}: out {i} is on {out.device}, the "
                             f"call on {dev}")
        outs.append(out)
        if not x.is_contiguous():
            x = x.contiguous()
            keep.append(x)
        if prev is not None and not prev.is_contiguous():
            prev = prev.contiguous()
            keep.append(prev)
        at = 12 * i
        words[at] = x.data_ptr()
        words[at + 3] = out.data_ptr()
        xvec = x.data_ptr() % 16 == 0 and words[at + 1] % 4 == 0
        pvec = prev is None or prev.data_ptr() % 16 == 0
        if prev is not None:
            words[at + 2] = prev.data_ptr()
        if lay.modes[i] == _GIVEN:
            sc = _f32(scales[i], index, "scales")
            keep.append(sc)
            words[at + 4] = sc.data_ptr()
        width, cap = words[at + 6], words[at + 9]
        ovec = out.data_ptr() % 16 == 0
        vec = ovec and (cap % 4 == 0 if words[at + 11] & 1
                        else width % 4 == 0 and xvec and pvec)
        words[at + 11] |= int(vec) << 1 | int(xvec) << 2 | int(
            prev is not None and pvec) << 3
    lib = _stack_lib()
    addr, pair_addr = words.buffer_info()[0], lay.pairs.buffer_info()[0]
    knobs = (None if w is None else w.data_ptr(),
             int(x0.shape[0]) if w is None else int(w.shape[0]),
             float(prev_weight), float(eps))
    with (torch.cuda.device(dev) if torch.cuda.current_device() != index
          else contextlib.nullcontext()):
        stream = _stream(dev)
        n_segs, n_contrib = len(xs), lay.n_contrib
        if lib.flora_stack_fits_inline(n_segs, n_contrib):
            err = lib.flora_stack_group(addr, n_segs, pair_addr, n_contrib,
                                        *knobs, stream)
        else:           # the table goes to the card by one async copy
            host = torch.empty(lib.flora_stack_table_bytes(n_segs,
                                                           n_contrib),
                               dtype=torch.uint8, pin_memory=True)
            tiles = ctypes.c_int64()
            err = lib.flora_stack_layout(addr, n_segs, pair_addr, n_contrib,
                                         host.data_ptr(), ctypes.byref(tiles))
            _check_launch(err, name, lib)
            table = host.to(dev, non_blocking=True)
            err = lib.flora_stack_group_table(
                table.data_ptr(), n_segs, n_contrib, lay.max_contrib,
                tiles.value, *knobs, stream)
    _check_launch(err, name, lib)
    runtime.LAUNCHES[name] += 1
    return outs


def flora_stack_group(xs, contribs, prevs=None, *, cap, cols=None,
                      scales=None, weights=None, prev_weight: float = 1.0,
                      eps: float = 1e-12, backend: str = "auto"):
    """FLoRA stacking of every pair side of a per-pair round in one call.

    Segment i is one output pair side at storage rank ``cap`` (an int, or
    one per segment): an A ``(*lead, cap, fan_in)`` by rank row or
    (``cols[i]`` true) a B ``(*lead, fan_out, cap)`` by rank column.  Its
    sources are ``xs[i]``, the pair side stacked over the n clients (``(n,
    *lead, r, fan_in)`` or ``(n, *lead, fan_out, r)``, read where it lies)
    and ``prevs[i]``, the previous global's side at its own storage rank.
    ``contribs[i]`` lists ``(source, rows)``: a client index, or -1 for
    prev, and how many of its leading rank rows it stacks; contributor k
    lands at the running offset, every layer of ``lead`` stacked on its
    own, and the rank rows beyond the total are zero.  ``scales[i]``: None
    (the rows pass unscaled), a tensor of one fp32 scale per contributor,
    or "mass": flora's B-column scales ``m_k / (sum m + eps) * total /
    rows_k``, with a client's mass its weight in ``weights`` (n,) and
    prev's ``prev_weight`` times their mean, summed in order.  Values are
    multiplied in fp32 and rounded once to the leaf's dtype.  On the card
    ONE launch (``runtime.LAUNCHES
    ["flora_stack"]``); on the CPU the plain version
    :func:`flora_stack_group_ref`.  :func:`packed_stack_group` runs the
    same kernel on segments fixed once (the flora plan's round)."""
    name = "flora_stack_group"
    contribs = _contribs(contribs)
    shapes = tuple(tuple(x.shape) for x in xs)
    pshapes = None if prevs is None else tuple(
        None if p is None else tuple(p.shape) for p in prevs)
    n, _, cols, caps, scales = _stack_args(name, shapes, contribs, pshapes,
                                           cols, cap, scales)
    _stack_weights(name, weights, n, scales)
    prevs = (None,) * len(xs) if prevs is None else tuple(prevs)
    dts = tuple(x.dtype for x in xs)
    if runtime.use_kernel(backend, xs[0], "flora_stack"):
        modes = tuple(_UNIT if sc is None else _MASS if isinstance(sc, str)
                      else _GIVEN for sc in scales)
        lay = _stack_layout(tuple(
            (shape[1:], col, c, con, None if p is None else tuple(p.shape),
             x.dtype, None if p is None else p.dtype, x.dtype, mode)
            for shape, col, c, con, p, x, mode in zip(
                shapes, cols, caps, contribs, prevs, xs, modes)))
        return _stack_group_cuda(lay, xs, prevs, scales, weights,
                                 prev_weight, eps, "flora_stack")
    return flora_stack_group_ref(xs, contribs, prevs, cols=cols, caps=caps,
                                 scales=scales, weights=weights,
                                 prev_weight=prev_weight, eps=eps,
                                 out_dtypes=dts)


@dataclasses.dataclass(frozen=True, eq=False)
class StackPlan:
    """A grouped stack whose segments are fixed: the flora plan's stacking
    round, built once by :func:`stack_plan` and run by
    :func:`packed_stack_group`, which fills in only the data pointers and
    the weights.  One entry a segment, as :func:`flora_stack_group` takes
    them: ``shapes`` the cohort leaves' (client axis first),
    ``prev_shapes`` prev's (None: no prev), ``cols``, ``caps``,
    ``contribs``, ``scales`` (None or "mass"), the leaves' ``dtypes`` (the
    outputs' too) and ``prev_dtypes``."""
    shapes: tuple
    contribs: tuple
    prev_shapes: tuple
    cols: tuple
    caps: tuple
    scales: tuple
    dtypes: tuple
    prev_dtypes: tuple
    prev_weight: float
    eps: float
    layout: _StackLayout

    @property
    def n(self) -> int:
        """The clients each cohort leaf stacks."""
        return int(self.shapes[0][0])


def stack_plan(shapes, contribs, *, cap, dtypes, cols=None,
               prev_shapes=None, prev_dtypes=None, scales=None,
               prev_weight: float = 1.0, eps: float = 1e-12) -> StackPlan:
    """Check a grouped stack's segments once and build its launch layout
    (arguments as :func:`flora_stack_group`'s, with shapes and dtypes in
    the place of the tensors; a scale is None or "mass").  Raises
    ``ValueError``/``TypeError`` on segments the kernel does not take."""
    name = "packed_stack_group"
    contribs = _contribs(contribs)
    shapes = tuple(tuple(int(v) for v in s) for s in shapes)
    k = len(shapes)
    if prev_shapes is not None:
        prev_shapes = tuple(None if p is None else tuple(int(v) for v in p)
                            for p in prev_shapes)
    n, prev_shapes, cols, caps, scales = _stack_args(
        name, shapes, contribs, prev_shapes, cols, cap, scales)
    if any(sc is not None and not isinstance(sc, str) for sc in scales):
        raise ValueError(f"{name}: a planned scale is None or 'mass'")
    dtypes = tuple(dtypes)
    prev_dtypes = (None,) * k if prev_dtypes is None else tuple(prev_dtypes)
    if len(dtypes) != k or len(prev_dtypes) != k or any(
            (p is None) != (d is None)
            for p, d in zip(prev_shapes, prev_dtypes)):
        raise ValueError(f"{name}: one dtype a segment, and one prev dtype "
                         "for each prev")
    modes = tuple(_UNIT if sc is None else _MASS for sc in scales)
    lay = _stack_layout(tuple(
        (shape[1:], col, c, con, p, dt, pdt, dt, mode)
        for shape, col, c, con, p, dt, pdt, mode in zip(
            shapes, cols, caps, contribs, prev_shapes, dtypes, prev_dtypes,
            modes)))
    return StackPlan(shapes, contribs, prev_shapes, cols, caps, scales,
                     dtypes, prev_dtypes, float(prev_weight), float(eps),
                     lay)


def packed_stack_group(plan: StackPlan, xs, prevs=None, weights=None, *,
                       outs=None, backend: str = "auto"):
    """The flora plan's stacking round in one call: segment i of ``plan``
    (:func:`stack_plan`) from the cohort leaf ``xs[i]`` and prev
    ``prevs[i]``, each read where it lies, into a new leaf at its cap in
    its own layout and dtype, as :func:`flora_stack_group` computes it
    (``weights`` (n,) feed the "mass" scales).  ``outs[i]``, where given,
    is written in place and returned: a contiguous tensor of the output's
    shape and dtype, which may be ``prevs[i]`` when prev is stored at the
    cap (a donated previous global: prev's rank row j lands on output row
    j, read and written by one thread).  On the card ONE launch of the
    grouped stack kernel, counted as ``runtime.LAUNCHES
    ["packed_stack"]``; on the CPU the plain twin
    :func:`packed_stack_group_ref`."""
    name = "packed_stack_group"
    k = len(plan.shapes)
    prevs = (None,) * k if prevs is None else tuple(prevs)
    if len(xs) != k or len(prevs) != k:
        raise ValueError(f"{name}: the plan has {k} segments, got "
                         f"{len(xs)} leaves and {len(prevs)} prevs")
    for i, (x, p) in enumerate(zip(xs, prevs)):
        if tuple(x.shape) != plan.shapes[i] or x.dtype != plan.dtypes[i]:
            raise ValueError(f"{name}: segment {i} is {tuple(x.shape)} "
                             f"{x.dtype}, the plan's {plan.shapes[i]} "
                             f"{plan.dtypes[i]}")
        if (p is None) != (plan.prev_shapes[i] is None) or p is not None and (
                tuple(p.shape) != plan.prev_shapes[i]
                or p.dtype != plan.prev_dtypes[i]):
            raise ValueError(f"{name}: segment {i}'s prev is "
                             f"{None if p is None else tuple(p.shape)}, the "
                             f"plan's {plan.prev_shapes[i]}")
    _stack_weights(name, weights, plan.n, plan.scales)
    if runtime.use_kernel(backend, xs[0], "packed_stack"):
        return _stack_group_cuda(plan.layout, xs, prevs, plan.scales,
                                 weights, plan.prev_weight, plan.eps,
                                 "packed_stack", outs=outs)
    outs = _check_outs(name, outs, plan.layout.shapes,
                       plan.layout.out_dtypes)
    return write_into(outs, packed_stack_group_ref(plan, xs, prevs, weights))


def flora_stack(x, scales, *, segs, out_rows: int, layers: int = 1,
                backend: str = "auto"):
    """Stack contributors' leading rank rows (FLoRA aggregation):
    ``out[off_i : off_i + segs[i]] = scales[i] * x[i, :segs[i]]`` with
    ``off_i`` the running sum of ``segs``; the rows beyond are zero.
    x: (N, R, *dims); trailing dims flatten into D and are restored.  The
    one-segment row-mode form of :func:`flora_stack_group`.

    ``layers`` > 1 stacks a layer-stacked pair in the same launch: x is
    (N, layers * R, *dims), each contributor's layers one after another,
    every layer is stacked on its own with the same ``segs`` and
    ``scales``, and the result is (layers * out_rows, *dims)."""
    x2, lead = _flat(x, "flora_stack")
    n, rows, d = x2.shape
    if layers < 1 or rows % layers:
        raise ValueError(f"flora_stack: {rows} rows do not split into "
                         f"{layers} layers")
    r = rows // layers
    segs = _check_segs(segs, n, r, out_rows)
    if runtime.use_kernel(backend, x, "flora_stack"):
        sc = _on(scales, x.device, torch.float32, "scales")
        out = flora_stack_group(
            [x2.reshape(n, layers, r, d)], [tuple(enumerate(segs))],
            cap=out_rows, scales=[sc], backend=backend)[0]
    else:       # the layer axis rides as a trailing dim of the plain version
        xl = x2.reshape(n, layers, r, d).transpose(1, 2)
        out = flora_stack_ref(xl, scales, segs, out_rows).transpose(0, 1)
    return out.reshape((layers * out_rows,) + lead)


# ---------------------------------------------------------------- axpy_fold --
#: rate modes of a fold segment (``Mode`` in csrc/axpy_fold.cu)
_VALUE, _FIRST, _ROW, _COL = 0, 1, 2, 3
_F32 = struct.Struct("<f")      # a scalar rate's fp32 bits, as torch rounds


@functools.cache
def _axpy_lib() -> ctypes.CDLL:
    lib = build.load("axpy_fold")
    lib.axpy_fold_group.argtypes = [_P, _I, _I, _I, _I, _P]
    lib.axpy_fold_layout.argtypes = [_P, _I, _I, _I, _I, _P, _P]
    lib.axpy_fold_group_table.argtypes = [_P, _I, _L, _I, _I, _I, _P]
    for fn in (lib.axpy_fold_group, lib.axpy_fold_layout,
               lib.axpy_fold_group_table, lib.axpy_fold_inline_segs,
               lib.axpy_fold_table_bytes):
        fn.restype = _I
    return lib


def _fold_segment(y, x, alpha, col: bool) -> tuple[int, int, int, int]:
    """Check one segment of a grouped fold; returns its kernel geometry
    ``(rows, width, col_group, mode)``: memory rows of ``width``
    contiguous elements, and where each element's rate comes from."""
    if x.shape != y.shape:
        raise ValueError(f"axpy_fold: x {tuple(x.shape)} vs y "
                         f"{tuple(y.shape)}")
    return _geometry(y.shape, alpha.shape if isinstance(alpha, torch.Tensor)
                     else None, col)


@functools.lru_cache(maxsize=4096)
def _geometry(shape, alpha_shape, col: bool) -> tuple[int, int, int, int]:
    """:func:`_fold_segment` for a y of ``shape`` and a rate that is a
    number (``alpha_shape`` None) or a tensor of ``alpha_shape``; a fold
    sees the same few shapes again and again."""
    n = math.prod(shape)
    if alpha_shape is None or (not alpha_shape and not col):
        rows = shape[0] if shape else 1
        return rows, n // rows if rows else 0, 0, \
            _VALUE if alpha_shape is None else _FIRST
    got = tuple(alpha_shape)
    if col:
        want = tuple(shape[:-2]) + tuple(shape[-1:])
        if len(shape) < 2 or got != want:
            raise ValueError(f"axpy_fold: column-mode alpha {got} != {want} "
                             f"(y {tuple(shape)}: its leading dims and its "
                             "last axis)")
        return n // shape[-1], shape[-1], shape[-2], _COL
    want = tuple(shape[:len(got)])
    if got != want:
        raise ValueError(f"axpy_fold: alpha {got} != {want} (y's leading "
                         "dims)")
    rows = math.prod(got)
    return rows, n // rows if rows else 0, 0, _ROW


def _axpy_group_cuda(ys, xs, alphas, cols, out_dtype=None) -> list:
    """Check every segment and fold them all: one launch per (y, x, out)
    dtype triple.  Returns the outputs in order (each in ``out_dtype``,
    default its y's).  A segment is eight 8-byte words of csrc's SegIn."""
    dev = ys[0].device
    index = ys[0].get_device()
    outs, keep, groups = [], [], {}
    for y, x, alpha, col in zip(ys, xs, alphas, cols):
        rows, width, col_group, mode = _fold_segment(y, x, alpha, col)
        if y.dtype not in _OUT_CODES or x.dtype not in _OUT_CODES:
            raise TypeError(f"axpy_fold: y {y.dtype}, x {x.dtype}: each "
                            f"must be one of {list(_OUT_CODES)}")
        if y.get_device() != index or x.get_device() != index:
            raise ValueError(f"axpy_fold: y is on {y.device}, x on "
                             f"{x.device}, the fold on {dev}")
        # a transposed or sliced view is copied once into row-major order
        if not y.is_contiguous():
            y = y.contiguous()
        if not x.is_contiguous():
            x = x.contiguous()
        out = (torch.empty_like(y) if out_dtype is None
               else torch.empty_like(y, dtype=out_dtype))
        outs.append(out)
        if not rows or not width:
            continue
        if mode == _VALUE:
            ptr, bits = 0, int.from_bytes(_F32.pack(alpha), "little")
        else:
            if alpha.get_device() != index:
                raise ValueError(f"axpy_fold: alpha is on {alpha.device}, "
                                 f"the fold on {dev}")
            if alpha.dtype != torch.float32 or not alpha.is_contiguous():
                alpha = alpha.to(torch.float32).contiguous()
            ptr, bits = alpha.data_ptr(), 0
        keep += (y, x, alpha)
        groups.setdefault((y.dtype, x.dtype, out.dtype), []).extend(
            (y.data_ptr(), x.data_ptr(), out.data_ptr(), ptr, rows, width,
             col_group, bits | mode << 32))
    lib = _axpy_lib()
    with (torch.cuda.device(dev) if torch.cuda.current_device() != index
          else contextlib.nullcontext()):
        stream = _stream(dev)
        for (ty, tx, to), words in groups.items():
            codes = (_OUT_CODES[ty], _OUT_CODES[tx], _OUT_CODES[to])
            table = array.array("q", words)
            addr, n = table.buffer_info()[0], len(words) // 8
            if n <= lib.axpy_fold_inline_segs():
                err = lib.axpy_fold_group(addr, n, *codes, stream)
            else:       # the table goes to the card by one async copy
                host = torch.empty(n * lib.axpy_fold_table_bytes(),
                                   dtype=torch.uint8, pin_memory=True)
                tiles = ctypes.c_int64()
                err = lib.axpy_fold_layout(addr, n, *codes, host.data_ptr(),
                                           ctypes.byref(tiles))
                _check_launch(err, "axpy_fold", lib)
                dev_table = host.to(dev, non_blocking=True)
                err = lib.axpy_fold_group_table(dev_table.data_ptr(), n,
                                                tiles.value, *codes, stream)
            _check_launch(err, "axpy_fold", lib)
            runtime.LAUNCHES["axpy_fold"] += 1
    return outs


def axpy_fold_group(ys, xs, alphas, *, cols=None, backend: str = "auto"):
    """Fold many leaves in one call: ``ys[i] + alphas[i] * (xs[i] - ys[i])``
    for every segment i, each result a new tensor in ``ys[i]``'s dtype and
    shape (no ``y`` is written).

    ``alphas[i]`` is a number (one rate for the leaf), a 0-d tensor, or a
    tensor over ``ys[i]``'s leading dims (one rate per rank row: RBLA's
    per-row mix, 0 on rows the client does not own).  ``cols[i]`` true
    reads the rates along the leaf's leading dims and its LAST axis: a
    LoRA B leaf ``(..., fan_out, r)`` folds in its own layout.  On the
    card every segment whose (y, x, out) dtypes agree folds in ONE kernel
    launch (``runtime.LAUNCHES["axpy_fold"]`` counts each); on the CPU the
    plain version :func:`axpy_fold_group_ref` runs."""
    n = len(ys)
    if len(xs) != n or len(alphas) != n or (cols is not None
                                            and len(cols) != n):
        raise ValueError(f"axpy_fold_group: {n} ys, {len(xs)} xs, "
                         f"{len(alphas)} alphas"
                         + ("" if cols is None else f", {len(cols)} cols"))
    if not n:
        return []
    cols = (False,) * n if cols is None else cols
    if runtime.use_kernel(backend, ys[0], "axpy_fold"):
        return _axpy_group_cuda(ys, xs, alphas, cols)
    for y, x, a, c in zip(ys, xs, alphas, cols):
        _fold_segment(y, x, a, c)
    return axpy_fold_group_ref(ys, xs, alphas, cols=cols)


def axpy_fold(y, x, alpha, *, generator: torch.Generator | None = None,
              backend: str = "auto"):
    """Fold one update into the live state: ``y + alpha * (x - y)``.

    y, x: (R, *dims) with the rank-row axis leading (a 1-D leaf folds as
    (R, 1), a 0-d one as (1, 1)); ``alpha`` is a scalar (the uniform server
    mix) or an (R,) vector (RBLA's per-row mix: rows the client does not
    own take 0 and pass ``y`` through).  Trailing dims flatten into D and
    are restored.  The result is a new tensor in y's dtype; ``y`` is never
    written.  On the card this is a one-segment :func:`axpy_fold_group`.
    ``generator``: with a bf16 ``y``, the fold is computed in fp32
    and rounded back to bf16 stochastically with noise drawn from this
    ``torch.Generator`` (on y's device), so a long stream of low-precision
    folds stays unbiased (``repro_torch.core.codec.stochastic_round``)."""
    if tuple(x.shape) != tuple(y.shape):
        raise ValueError(f"axpy_fold: x {tuple(x.shape)} vs y "
                         f"{tuple(y.shape)}")
    r = int(y.shape[0]) if y.ndim else 1
    if isinstance(alpha, torch.Tensor) and alpha.ndim and \
            tuple(alpha.shape) != (r,):
        raise ValueError(f"axpy_fold: alpha {tuple(alpha.shape)} != ({r},)")
    y2, x2 = y.reshape(r, -1), x.reshape(r, -1)
    rounds = generator is not None and y.dtype == torch.bfloat16
    out_dtype = torch.float32 if rounds else y.dtype
    if runtime.use_kernel(backend, y, "axpy_fold"):
        out = _axpy_group_cuda([y2], [x2], [alpha], [False], out_dtype)[0]
    else:
        out = axpy_fold_ref(y2, x2, alpha, out_dtype=out_dtype)
    if rounds:
        from repro_torch.core.codec import stochastic_round
        out = stochastic_round(out, generator)
    return out.reshape(y.shape)


__all__ = ["packed_agg", "packed_agg_group", "packed_agg_inline", "rbla_agg",
           "rbla_agg_group", "packed_robust", "packed_robust_group",
           "packed_stack", "packed_stack_group", "StackPlan", "stack_plan",
           "flora_stack", "flora_stack_group", "StackTable",
           "stack_table", "axpy_fold", "axpy_fold_group", "packed_agg_ref",
           "rbla_agg_ref", "rbla_agg_group_ref", "packed_robust_ref",
           "packed_agg_group_ref", "packed_robust_group_ref",
           "packed_stack_ref", "packed_stack_group_ref", "flora_stack_ref",
           "flora_stack_group_ref",
           "axpy_fold_ref", "axpy_fold_group_ref", "MAX_ROBUST_CLIENTS"]
