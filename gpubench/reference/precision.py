"""Arithmetic at a stated precision, for the references and their controls.

``"fp64"`` and ``"fp32"`` compute in that type (fp32 products in full
fp32: TF32 off).  ``"bf16"`` computes in bfloat16.  ``"fp8"`` is the
control of a bfloat16 model: every matmul operand is rounded to float8
e4m3 (per tensor, scaled so its largest magnitude maps to the format's
largest finite value) and every gradient reaching a matmul to e5m2, the
products then taken in fp32.
"""
from __future__ import annotations

import contextlib

import torch

DTYPES = {"fp64": torch.float64, "fp32": torch.float32,
          "bf16": torch.bfloat16, "fp8": torch.float32}


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in full fp32 on the card (TF32 off)
    inside, the flags as they were after; usable as a decorator, as the
    references' entry points use it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def dtype(precision: str) -> torch.dtype:
    return DTYPES[precision]


def _round_to(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().max().float()
    top = torch.finfo(fmt).max
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Round to e4m3 going forward, the gradient to e5m2 coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round_to(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a matmul operand at ``precision``."""
    if precision == "fp8":
        return _Fp8.apply(x.float())
    return x.to(DTYPES[precision])


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` with both operands at ``precision``."""
    return operand(x, precision) @ operand(w, precision)
