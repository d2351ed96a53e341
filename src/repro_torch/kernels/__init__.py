"""Hand-written Hopper kernels, their plain PyTorch versions, and the
shared backend policy and launch counters (``runtime``).

* ``rbla_agg`` -- the aggregation and fold kernels (``packed_agg``,
  ``packed_robust``, ``packed_stack``, ``flora_stack``, ``axpy_fold``,
  ``rbla_agg``, their grouped forms in the subpackage);
* ``lora_matmul`` -- the fused LoRA matmuls of the serving read path
  (``batched_lora_matmul``, ``lora_matmul``);
* ``ssd_scan`` -- Mamba2's chunked SSD scan of the serving prefill.

The names are the JAX package's ``repro.kernels`` ones, less the forms
that exist only inside a JAX trace (``*_inline``) and
``packed_robust_xla``, the XLA lowering of the robust kernel's oracle.
"""
from .lora_matmul import (batched_lora_matmul, batched_lora_matmul_ref,
                          batched_lora_matmul_segments, lora_dense_apply,
                          lora_matmul, lora_matmul_ref)
from .rbla_agg import (axpy_fold, axpy_fold_ref, flora_stack,
                       flora_stack_ref, packed_agg, packed_agg_ref,
                       packed_robust, packed_robust_ref, packed_stack,
                       packed_stack_ref, rbla_agg, rbla_agg_ref)
from .ssd_scan import chunk_len, ssd_scan, ssd_scan_ref

__all__ = ["lora_dense_apply", "lora_matmul", "lora_matmul_ref",
           "batched_lora_matmul", "batched_lora_matmul_ref",
           "batched_lora_matmul_segments",
           "axpy_fold", "axpy_fold_ref", "flora_stack", "flora_stack_ref",
           "packed_agg", "packed_agg_ref", "packed_robust",
           "packed_robust_ref", "packed_stack", "packed_stack_ref",
           "rbla_agg", "rbla_agg_ref", "chunk_len", "ssd_scan",
           "ssd_scan_ref"]
