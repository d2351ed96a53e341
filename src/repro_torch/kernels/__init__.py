"""Hand-written Hopper kernels, their plain PyTorch versions, and the
shared backend policy and launch counters (``runtime``).

* ``rbla_agg`` -- the aggregation and fold kernels;
* ``lora_matmul`` -- the fused LoRA matmuls of the serving read path
  (``batched_lora_matmul``, ``lora_matmul``).
"""
from .lora_matmul import (batched_lora_matmul, batched_lora_matmul_ref,
                          batched_lora_matmul_segments, lora_dense_apply,
                          lora_matmul, lora_matmul_ref)

__all__ = ["batched_lora_matmul", "batched_lora_matmul_ref",
           "batched_lora_matmul_segments", "lora_dense_apply", "lora_matmul",
           "lora_matmul_ref"]
