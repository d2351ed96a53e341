"""Upload codecs for LoRA adapter transport.

At FLaaS scale the binding cost is upload bytes, not FLOPs: every client
ships fp32 ``(A, B)`` factors each round.  These are the wire formats
clients apply before ``AsyncAggregator.submit``:

``none``
    fp32 pass-through (bit-exact baseline).
``bf16``
    a plain cast to bfloat16 -- 2x smaller, exact for values whose mantissa
    fits in 8 bits.
``int8``
    symmetric per-row quantisation on the packed row convention of
    :func:`repro_torch.core.plan.pair_side_rows`: each of ``A``'s rank rows
    (``amax`` over the fan-in axis) and each of ``B``'s rank *columns*
    (``amax`` over the fan-out axis) carries one fp32 scale
    ``max|row| / 127``; the payload is ``clip(round(x / scale), -127,
    127)`` as int8.  About 4x smaller; the scales travel as runtime data,
    so dequantisation fuses into ``packed_agg``.

An encoded int8 pair is the usual ``{"A", "B", "rank"}`` mapping plus
``"A_scale"`` / ``"B_scale"`` entries of shape ``(..., r_max)``; the pair
walkers test key containment, so encoded pairs flow through the same
trees.  ``decode_pair`` is idempotent on plain fp32 pairs.

:func:`stochastic_round` (f32 -> bf16 with mantissa-noise rounding, an
unbiased rounding for low-precision accumulators) backs the
``accum_dtype="bfloat16"`` fold state of
:class:`repro_torch.fl.async_agg.AsyncAggregator`.  Its noise comes from
a ``torch.Generator`` on the tensor's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from repro_torch.obs.trace import read_back
from repro_torch.tree import tree_map

#: registered codec names, in negotiation-preference order.
CODECS = ("none", "bf16", "int8")

_INT8_QMAX = 127.0
_F32_MAX = float(torch.finfo(torch.float32).max)


# ----------------------------------------------------------- tree walk ----
def _is_pair(node: Any) -> bool:
    return (isinstance(node, Mapping) and "A" in node and "B" in node
            and "rank" in node)


def _map_pairs(fn, tree):
    if _is_pair(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_pairs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_pairs(fn, v) for v in tree)
    return tree


def _iter_pairs(tree, path=()):
    if _is_pair(tree):
        yield path, tree
        return
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _iter_pairs(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _iter_pairs(v, path + (i,))


# -------------------------------------------------------------- codecs ----
def codec_of_pair(pair: Mapping) -> str:
    """Wire format of one (possibly encoded) pair."""
    if "A_scale" in pair or "B_scale" in pair:
        return "int8"
    if torch.as_tensor(pair["A"]).dtype == torch.bfloat16:
        return "bf16"
    return "none"


def tree_codec(adapters) -> str:
    """Codec of a whole adapter tree; ``"mixed"`` if pairs disagree."""
    seen = {codec_of_pair(p) for _, p in _iter_pairs(adapters)}
    if not seen:
        return "none"
    return seen.pop() if len(seen) == 1 else "mixed"


def cohort_codecs(client_adapters: Sequence) -> tuple | None:
    """Per-client codec names for a cohort, or ``None`` when every client
    uploaded plain fp32 (the fast path: zero codec overhead)."""
    codecs = tuple(tree_codec(a) for a in client_adapters)
    return None if all(c == "none" for c in codecs) else codecs


def _int8_encode_side(x: torch.Tensor, row_axis: int):
    """Quantise one factor along the packed-row axis: ``row_axis=-1``
    treats trailing-axis vectors as rows (A), ``-2`` quantises columns (B).
    Returns ``(q_int8, scale)``, ``scale`` shaped ``(..., r_max)``.  The
    code is a true division ``x / scale`` rounded half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=row_axis)
    scale = torch.where(amax > 0, amax / _INT8_QMAX, 1.0)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(row_axis)),
                    -_INT8_QMAX, _INT8_QMAX)
    return q.to(torch.int8), scale.float()


def encode_pair(pair: Mapping, codec: str) -> dict:
    """Encode one pair for upload.  ``rank`` always stays exact."""
    if codec == "none":
        return dict(pair)
    if codec == "bf16":
        out = dict(pair)
        out["A"] = pair["A"].to(torch.bfloat16)
        out["B"] = pair["B"].to(torch.bfloat16)
        return out
    if codec == "int8":
        qa, sa = _int8_encode_side(pair["A"], row_axis=-1)
        qb, sb = _int8_encode_side(pair["B"], row_axis=-2)
        out = dict(pair)
        out.update(A=qa, B=qb, A_scale=sa, B_scale=sb)
        return out
    raise ValueError(f"unknown codec {codec!r}; options: {list(CODECS)}")


def decode_pair(pair: Mapping) -> dict:
    """Dequantise one pair to fp32.  Idempotent on plain pairs."""
    codec = codec_of_pair(pair)
    if codec == "none":
        return dict(pair)
    out = {k: v for k, v in pair.items() if k not in ("A_scale", "B_scale")}
    if codec == "bf16":
        out["A"] = pair["A"].float()
        out["B"] = pair["B"].float()
        return out
    sa = pair["A_scale"].float()
    sb = pair["B_scale"].float()
    out["A"] = pair["A"].float() * sa[..., :, None]
    out["B"] = pair["B"].float() * sb[..., None, :]
    return out


def encode_adapters(adapters, codec: str):
    """Encode every pair in an adapter tree; non-pair leaves untouched."""
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; options: {list(CODECS)}")
    if codec == "none":
        return adapters
    return _map_pairs(lambda p: encode_pair(p, codec), adapters)


def decode_adapters(adapters):
    """Dequantise every pair in a tree to fp32 (idempotent)."""
    return _map_pairs(decode_pair, adapters)


def encode_update(update, codec: str):
    """Encode a ``ClientUpdate``'s adapters (``base_trainable`` stays
    fp32: base rows are shared-dense and fold through plain FedAvg)."""
    return dataclasses.replace(update, adapters=encode_adapters(
        update.adapters, codec))


def decode_update(update):
    """Dequantise a ``ClientUpdate`` (idempotent on plain updates)."""
    return dataclasses.replace(update,
                               adapters=decode_adapters(update.adapters))


# ---------------------------------------------------------- validation ----
class UploadValidationError(ValueError):
    """A rejected upload, tagged with the machine-readable ``reason`` the
    ingestion metrics count it under (``fl_updates_rejected_total``)."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


def validate_encoded_adapters(adapters) -> None:
    """Ingestion sanity for encoded uploads.

    Raises :class:`UploadValidationError` when any quantisation scale is
    non-finite or non-positive (``reason "bad_scale"``), or when an int8
    payload's decoded norm would overflow fp32 (``scale * 127 *
    sqrt(row_width)`` past the largest fp32; ``reason "overflow"``).  Each
    check of a device tensor reads one bool back to the host."""
    for path, pair in _iter_pairs(adapters):
        name = "/".join(str(p) for p in path) or "<root>"
        for side, key in (("A", "A_scale"), ("B", "B_scale")):
            if key not in pair:
                continue
            s = torch.as_tensor(pair[key]).float()
            if not read_back("codec", bool,
                             (torch.isfinite(s) & (s > 0)).all()):
                raise UploadValidationError(
                    f"non-finite or non-positive quantization scale in "
                    f"{name}.{key}", reason="bad_scale")
            width = (pair[side].shape[-1] if side == "A"
                     else pair[side].shape[-2])
            limit = _F32_MAX / (_INT8_QMAX * math.sqrt(max(width, 1)))
            if read_back("codec", bool, (s > limit).any()):
                raise UploadValidationError(
                    f"quantization scale overflow in {name}.{key}: decoded "
                    f"row norm would exceed float32 range",
                    reason="overflow")


# ---------------------------------------------- stochastic accumulators ----
def stochastic_round(x: torch.Tensor, generator: torch.Generator,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Round f32 -> bf16 stochastically.

    Adds 16 uniform random bits to the f32 bit pattern and truncates the
    low mantissa half: ``bf16(bits(x) + u16) & 0xFFFF0000``.  Rounds up
    with probability ``frac / ulp``, so ``E[round(x)] == x``; bf16-
    representable values (low 16 bits zero) are fixed points whatever the
    noise.  Non-finite inputs pass through unchanged.  The bit trick runs
    in int32: adding a number below 2^16 to the bits of a finite float
    never overflows, and ``& -65536`` is ``& 0xFFFF0000`` in two's
    complement.  ``generator`` lives on x's device."""
    if dtype != torch.bfloat16:
        raise ValueError("stochastic_round targets bfloat16 storage; got "
                         f"{dtype}")
    xf = x.float().contiguous()
    noise = torch.randint(0, 1 << 16, tuple(xf.shape), generator=generator,
                          device=xf.device, dtype=torch.int32)
    bits = (xf.view(torch.int32) + noise) & -65536
    rounded = torch.where(torch.isfinite(xf), bits.view(torch.float32), xf)
    return rounded.to(torch.bfloat16)


def stochastic_round_tree(tree, generator: torch.Generator,
                          dtype=torch.bfloat16):
    """:func:`stochastic_round` over the float leaves of a tree (integer
    leaves -- rank vectors, counters -- untouched), drawing each leaf's
    noise from ``generator`` in traversal order, so the map is a pure
    function of the tree and the generator's state."""
    return tree_map(lambda t: stochastic_round(t, generator, dtype)
                    if t.is_floating_point() else t, tree)


__all__ = [
    "CODECS", "codec_of_pair", "tree_codec", "cohort_codecs",
    "encode_pair", "decode_pair", "encode_adapters", "decode_adapters",
    "encode_update", "decode_update", "validate_encoded_adapters",
    "UploadValidationError", "stochastic_round", "stochastic_round_tree",
]
