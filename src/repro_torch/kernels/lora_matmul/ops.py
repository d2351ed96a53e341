"""Wrappers of the fused LoRA matmul kernels in ``csrc/lora_matmul.cu``.

Same arguments as the JAX package's ``repro.kernels.lora_matmul.ops``, with
``backend`` (``lora_matmul``) or ``impl`` (``batched_lora_matmul``) in the
place of ``interpret`` and without the tile sizes: the kernels mask their
ragged edges, nothing is padded.  A CUDA tensor launches the kernel (or the
wrapper raises); a CPU tensor runs the plain version in ``ref.py``.

``batched_lora_matmul`` is the multi-tenant serving entry: on the card
the kernel takes the per-request adapter ids and the per-tenant (offset,
rank, scale) tables as they are and resolves each row's segment itself;
on the CPU :func:`~.ref.resolve_segments` gathers them.  Ids, offsets,
ranks and scales stay device data and nothing synchronises with the
host.  PyTorch runs eagerly: there is no trace to count and no
``*_inline`` form.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import build, runtime
from .ref import (batched_lora_matmul_ref, batched_lora_matmul_segments,
                  lora_matmul_ref, resolve_segments)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: ``impl`` of the batched entry -> the backend rule's names; ``"pallas"``
#: is the JAX package's name of the kernel, ``"xla"`` its segment lowering
_IMPLS = {"auto": "auto", "kernel": "kernel", "pallas": "kernel",
          "xla": "ref"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lora_matmul")
    lib.lora_matmul_batched.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _L,
                                        _P, _P, _I, _L, _L, _L, _L, _P]
    lib.lora_matmul_batched.restype = _I
    lib.lora_matmul_single.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _L,
                                       _L, _L, _L, _P]
    lib.lora_matmul_single.restype = _I
    lib.lora_matmul_single_scratch.argtypes = [_L, _L, _L, _L]
    lib.lora_matmul_single_scratch.restype = _L
    return lib


def _check_operands(name: str, x, **operands) -> None:
    """Every operand in x's dtype (fp32 or bf16), on x's device and
    contiguous: the kernel takes nothing else, and nothing is converted or
    copied behind the caller's back."""
    if x.dtype not in _CODES:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {list(_CODES)}")
    index = x.get_device()
    for key, t in {"x": x, **operands}.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype} but x is {x.dtype}; "
                            "the kernel takes one dtype for every operand")
        if t.get_device() != index:
            raise ValueError(f"{name}: {key} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous (shape "
                             f"{tuple(t.shape)}, strides {t.stride()})")


def _check_shapes(name, k, w, a, b, b_rows_lead: bool) -> None:
    r = a.shape[0]
    n = w.shape[-1]
    want_b = (r, n) if b_rows_lead else (n, r)
    if w.ndim != 2 or w.shape[0] != k or a.ndim != 2 or a.shape[1] != k \
            or tuple(b.shape) != want_b:
        raise ValueError(
            f"{name}: x (..., {k}) needs w ({k}, N), a (r, {k}) and b "
            f"{'(r, N)' if b_rows_lead else '(N, r)'}; got w "
            f"{tuple(w.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")


# -------------------------------------------------------------- single --
@functools.lru_cache(maxsize=1024)
def _scratch(index: int, m: int, k: int, n: int, r: int) -> int:
    """The fp32 elements of the single kernel's scratch u on card
    ``index`` (partial u's, one a split of K, each row padded to the
    tail's rank chunk), asked of the library once per shape."""
    with _on_device(index):
        return int(_lib().lora_matmul_single_scratch(m, k, n, r))


def _scale_on(scale, dev) -> torch.Tensor:
    """``scale`` as one fp32 value on ``dev``: a 0-d or one-element fp32
    tensor there is passed as it is (no copy, no host read); another
    device tensor is cast there, a number or a tensor elsewhere copied."""
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"lora_matmul: scale must be one value, got "
                             f"shape {tuple(scale.shape)}")
        if scale.device == dev:
            return (scale if scale.dtype == torch.float32
                    else scale.to(torch.float32))
        scale = float(scale)
    return torch.full((1,), float(scale), dtype=torch.float32, device=dev)


def _on_device(index: int):
    """A context that makes card ``index`` current, or nothing when it
    already is."""
    return (torch.cuda.device(index) if torch.cuda.current_device() != index
            else contextlib.nullcontext())


def _lora_cuda(x, x2, w, a, b, scale):
    m, k = x2.shape
    n, r = w.shape[1], a.shape[0]
    dev = x.device
    _check_operands("lora_matmul", x, w=w, a=a, b=b)
    s = _scale_on(scale, dev)
    index = x.get_device()
    u = (torch.empty(_scratch(index, m, k, n, r), dtype=torch.float32,
                     device=dev) if r else None)
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    with _on_device(index):
        err = _lib().lora_matmul_single(
            x2.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            s.data_ptr(), None if u is None else u.data_ptr(), y.data_ptr(),
            _CODES[x.dtype], m, k, n, r, runtime.stream_handle(dev))
    runtime.check_launch(err, "lora_matmul", _lib())
    runtime.LAUNCHES["lora_matmul"] += 1
    return y


def lora_matmul(x, w, a, b, scale, *, backend: str = "auto"):
    """x (..., K) @ w (K, N) + scale * (x @ a^T) @ b^T.

    a: (r, K), b: (N, r), scale a scalar (a Python number or a one-element
    tensor; on the card a tensor on x's device is read there, never on
    the host).  The result has x's dtype.  On the card two launches: u =
    scale x a^T, then x w with u b^T as more depth of the same
    accumulators (csrc/lora_matmul.cu)."""
    k = x.shape[-1]
    _check_shapes("lora_matmul", k, w, a, b, b_rows_lead=False)
    lead, n = tuple(x.shape[:-1]), w.shape[-1]
    x2 = x.reshape(-1, k)
    if runtime.use_kernel(backend, x, "lora_matmul"):
        y = _lora_cuda(x, x2, w, a, b, scale)
    else:
        y = lora_matmul_ref(x2, w, a, b, scale)
    return y.reshape(lead + (n,))


# ------------------------------------------------------- batched multi-adapter
def resolve_impl(impl: str | None, device="cuda") -> str:
    """The batched entry's ``impl`` for tensors on ``device`` (by default
    the card, as every entry point of the port): ``"kernel"`` or
    ``"xla"`` (the plain segment lowering).  ``"auto"`` (or None) picks
    the kernel on a CUDA device and the segment lowering on the CPU;
    ``"pallas"`` is an alias of ``"kernel"``."""
    kind = runtime.resolve_backend(_impl_backend(impl), device)
    return "kernel" if kind == "kernel" else "xla"


def _impl_backend(impl: str | None) -> str:
    impl = "auto" if impl is None else impl
    if impl not in _IMPLS:
        raise ValueError(f"unknown batched lora_matmul impl {impl!r}; "
                         f"options: {' | '.join(_IMPLS)}")
    return _IMPLS[impl]


def _table(t, dev, dtype, name):
    """A tenant table or the ids as a tensor on ``dev``: host data is
    copied there, a tensor on another device is refused."""
    if not isinstance(t, torch.Tensor):
        return torch.as_tensor(t, dtype=dtype, device=dev)
    if t.device != dev:
        raise ValueError(f"batched_lora_matmul: {name} is on {t.device}, x "
                         f"on {dev} (no hidden transfer)")
    return t


#: the kernel's types for the ids and the three tenant tables
_TABLE_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32)


def _batched_cuda(x, x2, w, a_rows, b_rows, tables):
    """Check the operands and pass the ids and tenant tables as they are,
    then one ctypes call: the kernel resolves each row's segment itself.
    An id or table of another dtype, or not contiguous, is converted once
    (the serving store's are already int32 / fp32)."""
    m, k = x2.shape
    n, r_tot = w.shape[1], a_rows.shape[0]
    dtype, index = x.dtype, x.get_device()
    _check_operands("batched_lora_matmul", x, w=w, a_rows=a_rows,
                    b_rows=b_rows)
    tables = [t if t.dtype == want and t.is_contiguous()
              else t.to(want).contiguous()
              for t, want in zip(tables, _TABLE_DTYPES)]
    u = torch.empty((m, max(r_tot, 1)), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=dtype, device=x.device)
    lib = _lib()
    with _on_device(index):
        err = lib.lora_matmul_batched(
            x2.data_ptr(), w.data_ptr(), a_rows.data_ptr(), b_rows.data_ptr(),
            *(t.data_ptr() for t in tables), tables[1].shape[0],
            u.data_ptr(), y.data_ptr(),
            _CODES[dtype], m, k, n, r_tot, runtime.stream_handle(index))
    runtime.check_launch(err, "batched_lora_matmul", lib)
    runtime.LAUNCHES["batched_lora_matmul"] += 1
    return y


def batched_lora_matmul(x, w, a_rows, b_rows, adapter_ids, seg_off,
                        seg_rank, seg_scale, *, impl: str = "auto"):
    """One launch, many adapters: for every request row i of x,

        y_i = x_i @ w + seg_scale[t] * (x_i @ A_t^T) @ B_t^T,
        t = adapter_ids[i]

    where tenant t's factors live as rank-row segment
    ``[seg_off[t], seg_off[t] + seg_rank[t])`` of the packed buffers
    ``a_rows`` (R, K) and ``b_rows`` (R, N) (B transposed, so row p of
    both is one rank-one component -- the
    :class:`~repro_torch.serving.AdapterStore` layout).  ``adapter_ids``
    matches x's leading dims; the three per-tenant tables are tensors on
    x's device (or host arrays, copied there).  On the card the kernel
    reads ids and tables itself; on the CPU
    :func:`~.ref.resolve_segments` gathers them.  A negative id counts
    from the end of the tables and ids still outside them clamp to their
    ends, as the JAX package's gather does.  A tenant with
    ``seg_rank[t] == 0`` gets the pure base product, and rows outside
    every requested segment are never read.  The result has x's dtype.
    """
    k = x.shape[-1]
    _check_shapes("batched_lora_matmul", k, w, a_rows, b_rows,
                  b_rows_lead=True)
    use_kernel = runtime.use_kernel(_impl_backend(impl), x,
                                    "batched_lora_matmul")
    lead, n = tuple(x.shape[:-1]), w.shape[-1]
    dev = x.device
    ids = _table(adapter_ids, dev, torch.int32, "adapter_ids")
    # a call at a serving batch's shapes makes no view it does not need
    tables = (ids if ids.dim() == 1 else ids.reshape(-1),
              _table(seg_off, dev, torch.int32, "seg_off"),
              _table(seg_rank, dev, torch.int32, "seg_rank"),
              _table(seg_scale, dev, torch.float32, "seg_scale"))
    if tables[0].numel() != x.numel() // max(k, 1):
        raise ValueError(f"batched_lora_matmul: {tables[0].numel()} adapter "
                         f"ids for x of shape {tuple(x.shape)}")
    t = tables[1].shape[0]
    if t < 1 or tables[2].shape[0] != t or tables[3].shape[0] != t:
        raise ValueError(f"batched_lora_matmul: tenant tables of "
                         f"{[tuple(v.shape) for v in tables[1:]]}; each "
                         "needs the same T >= 1 entries")
    x2 = x if x.dim() == 2 else x.reshape(-1, k)
    if use_kernel:
        y = _batched_cuda(x, x2, w, a_rows, b_rows, tables)
    else:
        y = batched_lora_matmul_segments(x2, w, a_rows, b_rows,
                                         *resolve_segments(*tables))
    return y if x.dim() == 2 else y.reshape(lead + (n,))


def lora_dense_apply(p, x, pair, alpha: float = 16.0,
                     backend: str = "auto"):
    """A dense layer with a LoRA pair through the fused kernel: ``p["w"]``
    is (fan_in, fan_out) as in the JAX package's ``models.common.dense``,
    ``p["b"]`` an optional bias; the scale ``alpha / max(rank, 1)`` is one
    fp32 value made on the pair's device and read there by the kernel."""
    scale = alpha / pair["rank"].clamp(min=1)
    y = lora_matmul(x, p["w"], pair["A"], pair["B"], scale, backend=backend)
    if "b" in p:
        y = y + p["b"]
    return y


__all__ = ["lora_matmul", "lora_dense_apply", "lora_matmul_ref",
           "batched_lora_matmul", "batched_lora_matmul_ref",
           "batched_lora_matmul_segments", "resolve_impl",
           "resolve_segments"]
