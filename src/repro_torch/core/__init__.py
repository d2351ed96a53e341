"""RBLA core: rank-based aggregation of heterogeneous LoRA adapters (Eq.
6-7, Alg. 1-2), the strategy registry, its compiled plans, the factored
low-rank engine and the distributed paths over ``torch.distributed``."""
from .masks import (axis_mask, pad_to_rank, rank_mask, slice_to_rank,
                    stacked_rank_masks)
from .aggregation import fedavg_leaf, rbla_leaf, zeropad_leaf
from .variants import rank_proportional_weights, rbla_norm_leaf
from .strategy import (AggregationStrategy, ClientUpdate, ServerState,
                       adapter_live_ranks, get_strategy, list_strategies,
                       register_strategy, stack_trees)
from .plan import CohortSpec, CompiledRound, PlanUnavailable, build_cohort_spec
from .distributed import (make_distributed_aggregator, rbla_allreduce,
                          rbla_tree_allreduce)

__all__ = [
    "axis_mask", "pad_to_rank", "rank_mask", "slice_to_rank",
    "stacked_rank_masks", "fedavg_leaf", "rbla_leaf", "zeropad_leaf",
    "rank_proportional_weights", "rbla_norm_leaf", "AggregationStrategy",
    "ClientUpdate", "ServerState", "adapter_live_ranks", "get_strategy",
    "list_strategies", "register_strategy", "stack_trees", "CohortSpec",
    "CompiledRound", "PlanUnavailable", "build_cohort_spec",
    "make_distributed_aggregator", "rbla_allreduce", "rbla_tree_allreduce",
]
