"""Wrapper of the chunked SSD scan kernel in ``csrc/ssd_scan.cu``.

Same arguments as the JAX package's ``repro.kernels.ssd_scan.ops.ssd_scan``
(``backend`` takes the place of ``interpret``).  The chunk length is the
reference's rule (:func:`~.ref.chunk_len`); the kernel
takes any length that divides L and masks its ragged tiles, so nothing is
padded.  A CUDA tensor launches the kernel (or the wrapper raises); a CPU
tensor runs the plain version in ``ref.py``.

The launch is the body of the registered op ``torch.ops.repro_torch.
ssd_scan`` (:func:`_ssd_op`): its fake implementation gives the outputs'
shapes and dtype, so the op traces under ``FakeTensorMode`` and on the
meta device without a card, and its flop formula (:func:`flops`, the
chunked SSD's products) is registered with ``torch.utils.flop_counter``,
so the dry run counts the kernel's work where the reference's lowers its
Pallas kernel.  A sharded mamba mixer calls the wrapper on each rank's
heads through ``local_map`` (``repro_torch.models.mamba``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import build, runtime
from .ref import chunk_len, ssd_scan_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_chunked.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _L, _L,
                                     _L, _L, _L, _L, _P]
    lib.ssd_scan_chunked.restype = _I
    lib.ssd_scan_workspace_floats.argtypes = [_L] * 6
    lib.ssd_scan_workspace_floats.restype = _L
    return lib


def _check_shapes(xdt, dta, bm, cm) -> None:
    if xdt.ndim != 4:
        raise ValueError(f"ssd_scan: xdt must be (B, L, H, P), got "
                         f"{tuple(xdt.shape)}")
    b, l, h, _ = xdt.shape
    n = bm.shape[-1] if bm.ndim == 3 else -1
    if tuple(dta.shape) != (b, l, h) or bm.ndim != 3 \
            or tuple(bm.shape) != (b, l, n) or tuple(cm.shape) != (b, l, n):
        raise ValueError(
            f"ssd_scan: xdt {tuple(xdt.shape)} needs dta ({b}, {l}, {h}) and "
            f"bm/cm ({b}, {l}, N); got dta {tuple(dta.shape)}, bm "
            f"{tuple(bm.shape)}, cm {tuple(cm.shape)}")
    if min(xdt.shape[1:]) < 1 or n < 1:
        raise ValueError(f"ssd_scan: empty dimension in xdt "
                         f"{tuple(xdt.shape)} or bm {tuple(bm.shape)}")


def _check_operands(xdt, dta, bm, cm) -> None:
    """xdt, bm and cm in one dtype (fp32 or bf16), dta in fp32, all on
    xdt's device and contiguous: nothing is converted or copied behind the
    caller's back."""
    if xdt.dtype not in _CODES:
        raise TypeError(f"ssd_scan: xdt dtype {xdt.dtype} not in "
                        f"{list(_CODES)}")
    for name, t, want in (("bm", bm, xdt.dtype), ("cm", cm, xdt.dtype),
                          ("dta", dta, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, the kernel "
                            f"takes {want} (xdt is {xdt.dtype})")
    for name, t in (("xdt", xdt), ("dta", dta), ("bm", bm), ("cm", cm)):
        if t.device != xdt.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xdt on "
                             f"{xdt.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous (shape "
                             f"{tuple(t.shape)}, strides {t.stride()})")


def flops(b: int, l: int, h: int, p: int, n: int, q: int) -> int:
    """The chunked SSD's products for (B, L, H, P) inputs, state N and chunk
    Q, one multiply-add two: C B^T and ((C B^T) o L) @ xdt on the causal
    triangle with its diagonal, Q (Q + 1) / 2 of the Q^2 pairs (Q (Q + 1) N
    once a (batch, chunk), Q (Q + 1) P a head), and a chunk's state and
    C h_prev^T, 2 Q N P each a head; the carry over chunks is not counted."""
    nc = l // q
    return b * nc * q * (q + 1) * n \
        + b * h * nc * (q * (q + 1) * p + 4 * q * n * p)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_op(xdt: torch.Tensor, dta: torch.Tensor, bm: torch.Tensor,
            cm: torch.Tensor, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch as a registered op: (y, h_final)."""
    return _ssd_cuda(xdt, dta, bm, cm, q)


@_ssd_op.register_fake
def _ssd_fake(xdt, dta, bm, cm, q):
    b, _, h, p = xdt.shape
    return (torch.empty_like(xdt),
            xdt.new_empty((b, h, p, bm.shape[-1])))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flop_formula(xdt_shape, dta_shape, bm_shape, cm_shape, q, *args,
                      out_shape=None, **kwargs) -> int:
    return flops(*xdt_shape, bm_shape[-1], q)


def _check_launch(xdt, dta, bm, cm) -> None:
    """The operands' checks, then the refusal of a backward: made before
    the op is called, since autograd hands the op's body detached
    tensors."""
    _check_operands(xdt, dta, bm, cm)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, dta, bm, cm)):
        raise NotImplementedError(
            "ssd_scan: the kernel has no backward; differentiate through "
            "the plain version (a mamba Model with scan_backend='ref')")


def _ssd_cuda(xdt, dta, bm, cm, q):
    _check_launch(xdt, dta, bm, cm)
    b, l, h, p = xdt.shape
    n = bm.shape[-1]
    dev = xdt.device
    y = torch.empty_like(xdt)
    h_final = torch.empty((b, h, p, n), dtype=xdt.dtype, device=dev)
    # the phases' fp32 scratch: a_cs, C B^T per chunk, the chunk states
    ws = torch.empty(_lib().ssd_scan_workspace_floats(b, l, h, p, n, q),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().ssd_scan_chunked(
            xdt.data_ptr(), dta.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), ws.data_ptr(),
            _CODES[xdt.dtype], b, l, h, p, n, q, runtime.stream_handle(dev))
    runtime.check_launch(err, "ssd_scan", _lib())
    runtime.LAUNCHES["ssd_scan"] += 1
    return y, h_final


def ssd_scan(xdt, dta, bm, cm, chunk: int = 256, *, backend: str = "auto"):
    """Chunked SSD: xdt (B,L,H,P) pre-scaled by dt; dta (B,L,H); bm/cm
    (B,L,N).  Returns (y (B,L,H,P), h_final (B,H,P,N)) in xdt's dtype.

    On the card xdt, bm and cm are fp32 or bf16 (one dtype) and dta fp32,
    all contiguous; the kernel's four phases (``csrc/ssd_scan.cu``: a_cs
    and C B^T per chunk, the chunk states, the carry over chunks, the
    outputs) run on the tensor cores with fp32 accumulation and count as
    one launch.  A shape beyond its limits (more than 65535 64-row tiles
    in a chunk or 64 x 64 tiles of P x N, or 2^31 blocks) fails the launch
    with CUDA's "invalid argument"."""
    _check_shapes(xdt, dta, bm, cm)
    if runtime.use_kernel(backend, xdt, "ssd_scan"):
        _check_launch(xdt, dta, bm, cm)
        return _ssd_op(xdt, dta, bm, cm, chunk_len(xdt.shape[1], chunk))
    return ssd_scan_ref(xdt, dta, bm, cm, chunk)
