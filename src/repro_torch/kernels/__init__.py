"""Hand-written Hopper kernels, their plain PyTorch versions, and the
shared backend policy and launch counters (``runtime``).

* ``rbla_agg`` -- the aggregation and fold kernels;
* ``lora_matmul`` -- the fused LoRA matmuls of the serving read path
  (``batched_lora_matmul``, ``lora_matmul``);
* ``ssd_scan`` -- Mamba2's chunked SSD scan of the serving prefill.
"""
from .lora_matmul import (batched_lora_matmul, batched_lora_matmul_ref,
                          batched_lora_matmul_segments, lora_dense_apply,
                          lora_matmul, lora_matmul_ref)
from .ssd_scan import chunk_len, ssd_scan, ssd_scan_ref

__all__ = ["batched_lora_matmul", "batched_lora_matmul_ref",
           "batched_lora_matmul_segments", "lora_dense_apply", "lora_matmul",
           "lora_matmul_ref", "chunk_len", "ssd_scan", "ssd_scan_ref"]
