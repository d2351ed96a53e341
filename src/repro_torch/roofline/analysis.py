"""Roofline terms of a traced step, per device, on the H100 constants.

  compute_s    = flops / peak
  memory_s     = bytes / hbm_bw
  collective_s = collective_bytes / link bandwidth

The port's counterpart of the JAX package's ``repro.roofline.analysis``.
There XLA's ``cost_analysis`` gives the per-device flops and bytes of the
partitioned module and the post-SPMD HLO text its collectives.  Here one
rank's trace gives them: :class:`DeviceCounts` is a dispatch mode that
lets DTensor lower each op to its local shards and collectives first, then
counts every local op -- its flops by ``torch.utils.flop_counter``'s
formulas (the registered ``ssd_scan`` op's among them), the bytes of its
operands and outputs, and the output bytes of every functional collective
by kind under the reference's names (:func:`collective_bytes`, the
counterpart of ``collective_bytes_from_hlo``).  These are estimates from
traced shapes, never times.

A collective's bandwidth is NVLink's while the mesh fits one node of
``hw.GPUS_PER_NODE`` GPUs, the network's beyond.  ``active_params``,
``model_flops_estimate`` and ``scan_correction`` are the reference's,
copied as they are.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from . import hw

#: functional collectives by op name -> the reference's HLO names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")
#: ops of those namespaces that move nothing between ranks
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
#: ops that touch no memory: allocation without a write, metadata
_NO_TRAFFIC = (torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.detach,
               torch.ops.aten.alias)


def _in_shape_propagation() -> bool:
    """True inside DTensor's shape propagation
    (``ShardingPropagator._propagate_tensor_meta*`` on the Python stack),
    which calls the op on fake tensors of the global shapes: work no device
    does."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class DeviceCounts(TorchDispatchMode):
    """What one device does under this mode: ``flops`` (the flop counter's
    formulas over each local op; ``flops_by_op`` and ``calls_by_op`` by
    op), ``bytes`` (each local op's operands read
    and outputs written once) and ``collectives``
    (output bytes a kind); metadata, allocation and views move
    no bytes.  An op on DTensors is handed back to DTensor,
    which lowers it to the local ops and collectives counted here, so the
    counts are one rank's, as XLA's per-device module's are.  DTensor
    also runs each op once on fake tensors of the global shapes, to
    propagate its output's shape (every time while a fake mode is on, as
    in the dry run): those calls are not counted (:func:
    `_in_shape_propagation`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.calls_by_op: dict[str, int] = {}
        self.bytes = 0
        self.collectives: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        packet = func._overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = packet.__name__
            if name not in _NOT_COLLECTIVES:
                kind = _COLLECTIVES.get(name, name)
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + _bytes(out))
            return out
        formula = flop_registry.get(packet)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            name = str(packet)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
            self.calls_by_op[name] = self.calls_by_op.get(name, 0) + 1
        if not (func.is_view or func.namespace == "prim"
                or packet in _NO_TRAFFIC):
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def collective_bytes(fn, *args, **kwargs) -> dict[str, int]:
    """Per-device output bytes of every collective ``fn(*args, **kwargs)``
    makes, summed by kind (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``)."""
    with DeviceCounts() as counts:
        fn(*args, **kwargs)
    return dict(counts.collectives)


@dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    collective_bytes: float      # per-device collective bytes
    chips: int
    model_flops: float = 0.0     # 6*N*D useful flops (global)
    collectives: dict = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        bw = hw.NVLINK_BW if self.chips <= hw.GPUS_PER_NODE else hw.NET_BW
        return self.collective_bytes / bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced flops across all devices)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "collectives": self.collectives,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_estimate(cfg, shape, n_params_active: float,
                         kind: str) -> float:
    """6*N*D for training, 2*N*D for inference forward (per step)."""
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch


def scan_correction(cfg) -> float:
    """The reference's trip-count correction for XLA CPU cost_analysis,
    which counts a ``lax.scan`` body once: a parameter-weighted repeat
    count ``c = sum_s R_s * W_s / sum_s W_s`` over stages s (repeat R_s,
    per-unit params W_s) plus a non-scanned pseudo-stage (embedding/head,
    R=1).  Kept for parity: the port's trace sees every layer, so the dry
    run records it and applies 1.0."""
    units = []
    d = cfg.d_model
    embed_w = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    units.append((1, embed_w))
    for stage in cfg.stages + cfg.encoder_stages:
        w = sum(_block_params(cfg, spec) for spec in stage.unit)
        units.append((stage.repeat, w))
    num = sum(r * w for r, w in units)
    den = sum(w for _, w in units)
    return num / den if den else 1.0


def _block_params(cfg, spec) -> float:
    d = cfg.d_model
    n = 0.0
    if spec.kind == "mamba":
        d_in = cfg.ssm_expand * d
        h = d_in // cfg.ssm_head_dim
        n += d * (2 * d_in + 2 * cfg.ssm_state + h) + d_in * d
    elif spec.kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        n += d * cfg.q_lora_rank
        n += cfg.q_lora_rank * cfg.n_heads * qk
        n += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        n += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim +
                                               cfg.v_head_dim)
        n += cfg.n_heads * cfg.v_head_dim * d
    else:
        hd = cfg.head_dim
        n += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
        n += cfg.n_heads * hd * d
        if spec.cross_attn:
            n *= 2
    if spec.ffn == "dense":
        mult = 2 if cfg.mlp_act == "gelu_plain" else 3
        n += mult * d * cfg.d_ff
    elif spec.ffn == "moe":
        f = cfg.moe_d_ff or cfg.d_ff
        # dispatched compute ~ active experts x capacity factor
        n += (3 * d * f * cfg.experts_per_token * cfg.capacity_factor
              + 3 * d * f * cfg.n_shared_experts + d * cfg.n_experts)
    return n


def active_params(cfg) -> float:
    """Approximate active (per-token) parameter count from the config."""
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for stage in cfg.stages + cfg.encoder_stages:
        for spec in stage.unit:
            n = 0.0
            if spec.kind == "mamba":
                d_in = cfg.ssm_expand * d
                h = d_in // cfg.ssm_head_dim
                n += d * (2 * d_in + 2 * cfg.ssm_state + h) + d_in * d
            elif spec.kind == "mla":
                qk = cfg.qk_nope_dim + cfg.qk_rope_dim
                n += d * cfg.q_lora_rank
                n += cfg.q_lora_rank * cfg.n_heads * qk
                n += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                n += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim +
                                                       cfg.v_head_dim)
                n += cfg.n_heads * cfg.v_head_dim * d
            else:
                hd = cfg.head_dim
                n += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                n += cfg.n_heads * hd * d
                if spec.cross_attn:
                    n *= 2
            if spec.ffn == "dense":
                mult = 2 if cfg.mlp_act == "gelu_plain" else 3
                n += mult * d * cfg.d_ff
            elif spec.ffn == "moe":
                f = cfg.moe_d_ff or cfg.d_ff
                n += 3 * d * f * cfg.experts_per_token      # active experts
                n += 3 * d * f * cfg.n_shared_experts
                n += d * cfg.n_experts                      # router
            total += n * stage.repeat
    return total
