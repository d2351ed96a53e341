from repro_torch.core.strategy import ClientUpdate, ServerState, get_strategy
from .async_agg import (REJECT_REASONS, STALENESS_SCHEDULES, AsyncAggregator,
                        make_staleness_fn)
from .client import (LocalFitResult, make_local_fit, merge_base_params,
                     softmax_xent, split_base_params)
from .comm import (BufferedUpdate, DedupWindow, RetryPolicy, UpdateBuffer,
                   adapter_upload_bytes, round_cost_report, tree_bytes)
from .selection import ClientLatencyModel, select_clients
from .server import aggregate_adapters, aggregate_base, stack_trees
from .simulator import (AsyncFLConfig, FLConfig, FLHistory,
                        run_async_simulation, run_simulation)

__all__ = ["LocalFitResult", "make_local_fit", "merge_base_params",
           "softmax_xent", "split_base_params", "select_clients",
           "aggregate_adapters", "aggregate_base", "stack_trees",
           "FLConfig", "FLHistory", "run_simulation", "ClientUpdate",
           "ServerState", "get_strategy", "AsyncAggregator",
           "STALENESS_SCHEDULES", "REJECT_REASONS", "make_staleness_fn",
           "AsyncFLConfig", "run_async_simulation", "ClientLatencyModel",
           "UpdateBuffer", "BufferedUpdate", "DedupWindow", "RetryPolicy",
           "tree_bytes", "adapter_upload_bytes", "round_cost_report"]
