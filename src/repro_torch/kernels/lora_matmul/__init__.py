from .ops import (batched_lora_matmul, lora_dense_apply, lora_matmul,
                  resolve_impl)
from .ref import (batched_lora_matmul_ref, batched_lora_matmul_segments,
                  lora_matmul_ref, matmul_3xtf32, resolve_segments,
                  tf32_split)

__all__ = ["lora_matmul", "lora_dense_apply", "batched_lora_matmul",
           "resolve_impl", "lora_matmul_ref", "batched_lora_matmul_ref",
           "batched_lora_matmul_segments", "resolve_segments",
           "matmul_3xtf32", "tf32_split"]
