"""RBLA core: rank-based aggregation of heterogeneous LoRA adapters (Eq.
6-7, Alg. 1-2), the strategy registry, its compiled plans, the upload
codecs, the factored low-rank engine and the distributed paths over
``torch.distributed``.  The names are the JAX package's ``repro.core``
ones, less those with no meaning outside a JAX trace (the ``*_inline``
kernels, ``dispatch_counter``, ``shard_map*``, ``trace_counts``):
``repro_torch.kernels.runtime`` counts the launches instead."""
from .masks import (axis_mask, pad_to_rank, rank_mask, slice_to_rank,
                    stacked_rank_masks)
from .aggregation import (AGGREGATORS, aggregate, fedavg_leaf, rbla_leaf,
                          zeropad_leaf)
from .variants import (rank_proportional_weights, rbla_norm_leaf,
                       svd_project_pair)
from .lowrank import (dense_svd, factored_svd, product_factors,
                      randomized_svd, randomized_svd_product,
                      svd_project_stacked, truncated_svd_product)
from .strategy import (BACKENDS, AggregationStrategy, ClientUpdate,
                       FoldState, ServerState, adapter_live_ranks,
                       get_strategy, list_strategies, register_strategy,
                       resolve_backend, stack_trees)
from .plan import (CohortSpec, CompiledRound, PlanUnavailable,
                   build_cohort_spec, build_encoded_cohort_spec)
from .codec import (CODECS, cohort_codecs, decode_adapters, decode_pair,
                    decode_update, encode_adapters, encode_pair,
                    encode_update, stochastic_round, stochastic_round_tree,
                    tree_codec, validate_encoded_adapters)
from .distributed import (make_distributed_aggregator, rbla_allreduce,
                          rbla_tree_allreduce)

__all__ = [
    "axis_mask", "pad_to_rank", "rank_mask", "slice_to_rank",
    "stacked_rank_masks", "aggregate", "fedavg_leaf", "rbla_leaf",
    "zeropad_leaf", "AGGREGATORS", "make_distributed_aggregator",
    "rbla_allreduce", "rbla_tree_allreduce", "rank_proportional_weights",
    "rbla_norm_leaf", "svd_project_pair",
    "dense_svd", "factored_svd", "product_factors", "randomized_svd",
    "randomized_svd_product", "svd_project_stacked",
    "truncated_svd_product",
    "AggregationStrategy",
    "ClientUpdate", "FoldState", "ServerState", "BACKENDS",
    "adapter_live_ranks",
    "CohortSpec", "CompiledRound", "PlanUnavailable", "build_cohort_spec",
    "build_encoded_cohort_spec",
    "CODECS", "cohort_codecs", "decode_adapters", "decode_pair",
    "decode_update", "encode_adapters", "encode_pair", "encode_update",
    "stochastic_round", "stochastic_round_tree", "tree_codec",
    "validate_encoded_adapters",
    "get_strategy",
    "list_strategies", "register_strategy", "resolve_backend",
    "stack_trees",
]
