"""Multi-tenant adapter serving: the FLaaS read path.

The aggregation side (``repro_torch.core``/``repro_torch.fl``) produces
fresh global adapters; this package serves them:

* :class:`AdapterStore` -- paged per-tenant (A, B) storage over
  (fan_out, fan_in, dtype) buckets on the device, heterogeneous ranks
  packed as rank-row segments, per-tenant offset/rank/scale as device
  tables, and the stream rule that keeps publishes and batches on
  different CUDA streams apart;
* :class:`ServingEngine` -- one ``batched_lora_matmul`` launch per layer
  applies every tenant's adapter to a mixed request batch; ``publish()``
  hot-swaps a freshly aggregated global, versioned so in-flight batches
  finish on the snapshot they started with.
"""
from .engine import ServingEngine, merged_reference
from .store import AdapterStore, SegTable, StoreSnapshot

__all__ = ["AdapterStore", "SegTable", "StoreSnapshot", "ServingEngine",
           "merged_reference"]
