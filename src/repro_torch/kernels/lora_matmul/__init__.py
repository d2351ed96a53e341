from .ops import (batched_lora_matmul, lora_dense_apply, lora_matmul,
                  resolve_impl)
from .ref import (batched_lora_matmul_ref, batched_lora_matmul_segments,
                  lora_matmul_ref)

__all__ = ["lora_matmul", "lora_dense_apply", "batched_lora_matmul",
           "resolve_impl", "lora_matmul_ref", "batched_lora_matmul_ref",
           "batched_lora_matmul_segments"]
