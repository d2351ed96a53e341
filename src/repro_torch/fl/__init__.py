from repro_torch.core.strategy import ClientUpdate, ServerState, get_strategy
from .client import (LocalFitResult, make_local_fit, merge_base_params,
                     softmax_xent, split_base_params)
from .selection import select_clients
from .server import aggregate_adapters, aggregate_base, stack_trees
from .simulator import FLConfig, FLHistory, run_simulation

__all__ = ["LocalFitResult", "make_local_fit", "merge_base_params",
           "softmax_xent", "split_base_params", "select_clients",
           "aggregate_adapters", "aggregate_base", "stack_trees",
           "FLConfig", "FLHistory", "run_simulation", "ClientUpdate",
           "ServerState", "get_strategy"]
